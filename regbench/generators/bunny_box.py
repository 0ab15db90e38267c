"""Bunny-shaped problems, one per seed and index.

The upstream TEASER++ example ``examples/teaser_cpp_ply/teaser_cpp_ply.cc``
with its cloud drawn uniformly in a box (the bunny PLY is not shipped):
``dst = s R src + t`` under the example's fixed transform and the
problem's ``scale`` s (the key left out: known scale, s = 1), uniform noise
``+-noise_bound / 2`` on every coordinate, and ``outlier_draws`` draws with
replacement, each shifting all three axes of the drawn point by one integer
in ``outlier_shift`` (inclusive). Every problem draws its own cloud.
"""

from __future__ import annotations

import numpy as np


def transform(problem: dict) -> np.ndarray:
    """The example's 4x4 transform with its rotation block projected to the
    nearest rotation (the published digits are rounded off SO(3))."""
    t = np.array(problem["transform"], dtype=np.float64)
    u, _, vt = np.linalg.svd(t[:3, :3])
    t[:3, :3] = u @ vt
    return t


def make(problem: dict, seed: int, ids) -> tuple:
    """Problems ``ids`` of ``seed``: ``(src, dst)`` float32 ``(len(ids), 3, n)``.

    Problem ``i`` depends on ``(seed, i)`` alone, so any subset of a pool is
    drawn the same.
    """
    n = problem["n"]
    nb = problem["noise_bound"]
    lo, hi = problem["outlier_shift"]
    t = transform(problem)
    src = np.empty((len(ids), 3, n), np.float32)
    dst = np.empty((len(ids), 3, n), np.float32)
    for k, i in enumerate(ids):
        rng = np.random.default_rng(np.random.SeedSequence([seed, int(i)]))
        cloud = rng.uniform(0.0, problem["cloud_box_m"], (3, n))
        tgt = t[:3, :3] @ cloud
        if "scale" in problem:
            tgt *= problem["scale"]
        tgt += t[:3, 3:4]
        tgt += rng.uniform(-nb / 2, nb / 2, size=tgt.shape)
        mask = np.zeros(n, bool)
        mask[rng.integers(0, n, size=min(problem["outlier_draws"], n))] = True
        tgt[:, mask] += rng.integers(lo, hi + 1, size=int(mask.sum()))
        src[k] = cloud
        dst[k] = tgt
    return src, dst
