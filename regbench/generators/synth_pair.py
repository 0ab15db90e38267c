"""Two raw clouds a problem: a cloud drawn uniformly in a cube and its
rigid, noisy copy, one pair per seed and index.

The recipe of the repository's front-end pair: ``n`` points uniform in
``[-half_width, half_width]^3``; a uniform random proper rotation (the Q of
a QR factorisation of a standard normal 3x3 matrix, its columns' signs
fixed by R's diagonal and its determinant made +1); a translation uniform
in ``[-translation_half_width, translation_half_width]^3``; Gaussian noise
of sd ``noise_sd`` on every coordinate of the copy. No correspondences are
given: the front end finds them.
"""

from __future__ import annotations

import numpy as np


def draw(problem: dict, rng: np.random.Generator) -> tuple:
    """One pair from ``rng``: ``(src, dst)`` float64 ``(n, 3)`` and the
    planted ``(R, t)``."""
    w = problem["half_width"]
    pts = rng.uniform(-w, w, (problem["n"], 3))
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    tw = problem["translation_half_width"]
    t = rng.uniform(-tw, tw, 3)
    dst = pts @ q.T + t + rng.normal(scale=problem["noise_sd"], size=pts.shape)
    return pts, dst, q, t


def make(problem: dict, seed: int, ids) -> tuple:
    """Problems ``ids`` of ``seed``: ``(src, dst)`` float32 ``(len(ids), 3, n)``.

    Problem ``i`` depends on ``(seed, i)`` alone, so any subset of a pool is
    drawn the same.
    """
    n = problem["n"]
    src = np.empty((len(ids), 3, n), np.float32)
    dst = np.empty((len(ids), 3, n), np.float32)
    for k, i in enumerate(ids):
        rng = np.random.default_rng(np.random.SeedSequence([seed, int(i)]))
        s, d, _, _ = draw(problem, rng)
        src[k] = s.T
        dst[k] = d.T
    return src, dst
