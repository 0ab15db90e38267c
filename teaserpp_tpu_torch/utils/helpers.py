"""Small helper parity with reference utils.h.

Most of these are one-liners over numpy, provided so code written against
the reference's utility surface ports mechanically:
``randomSample`` (utils.h:31), ``removeRow``/``removeColumn`` (utils.h:65,87),
``maskVector`` (utils.h:169), ``findNonzero`` (utils.h:187).

A copy of ``teaserpp_tpu/utils/helpers.py`` (numpy only).
"""

from __future__ import annotations

from typing import List, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


def random_sample(population: Sequence[T], num_samples: int, rng=None) -> List[T]:
    """Sample without replacement (reference utils.h:31-56)."""
    rng = np.random.default_rng() if rng is None else rng
    idx = rng.choice(len(population), size=num_samples, replace=False)
    return [population[int(i)] for i in idx]


def remove_row(matrix: np.ndarray, row: int) -> np.ndarray:
    """Drop one row; out-of-range is a no-op (reference utils.h:65-78)."""
    if row >= matrix.shape[0]:
        return matrix
    return np.delete(matrix, row, axis=0)


def remove_column(matrix: np.ndarray, col: int) -> np.ndarray:
    """Drop one column; out-of-range is a no-op (reference utils.h:87-100)."""
    if col >= matrix.shape[1]:
        return matrix
    return np.delete(matrix, col, axis=1)


def mask_vector(mask, elements: Sequence[T]) -> List[T]:
    """Select elements where mask is true (reference utils.h:169-179)."""
    mask = np.asarray(mask, bool).reshape(-1)
    assert mask.shape[0] == len(elements)
    return [e for m, e in zip(mask, elements) if m]


def find_nonzero(mask) -> List[int]:
    """Indices of nonzero entries (reference utils.h:187-195)."""
    return np.nonzero(np.asarray(mask).reshape(-1))[0].tolist()
