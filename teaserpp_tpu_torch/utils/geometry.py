"""Point and point-cloud containers (reference geometry.h:15-72 parity).

``PointCloud`` is a thin container over an (N, 3) float array with the
reference's STL-ish surface (push_back / at / len / iteration) plus zero-copy
numpy in/out, which is what the solvers consume (the facade's
``solve(src_cloud, dst_cloud, correspondences)`` reads ``points``).

A copy of ``teaserpp_tpu/utils/geometry.py``: the port imports nothing of the
JAX package, even where a module needs no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PointXYZ:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def __iter__(self):
        return iter((self.x, self.y, self.z))


class PointCloud:
    """A growable cloud of 3-D points."""

    def __init__(self, points: Optional[np.ndarray] = None):
        if points is None:
            self._pts = np.zeros((0, 3), dtype=np.float64)
        else:
            pts = np.asarray(points, dtype=np.float64)
            if pts.ndim == 2 and pts.shape[0] == 3 and pts.shape[1] != 3:
                pts = pts.T
            assert pts.ndim == 2 and pts.shape[1] == 3
            self._pts = pts.copy()

    # -- container API (reference geometry.h:34-66)
    def push_back(self, p) -> None:
        x, y, z = (p.x, p.y, p.z) if isinstance(p, PointXYZ) else tuple(p)
        self._pts = np.vstack([self._pts, [[x, y, z]]])

    def at(self, i: int) -> PointXYZ:
        return self[i]

    def size(self) -> int:
        return len(self)

    def empty(self) -> bool:
        return len(self) == 0

    def clear(self) -> None:
        self._pts = np.zeros((0, 3), dtype=np.float64)

    def reserve(self, n: int) -> None:  # parity no-op
        del n

    def __len__(self) -> int:
        return self._pts.shape[0]

    def __getitem__(self, i: int) -> PointXYZ:
        x, y, z = self._pts[i]
        return PointXYZ(float(x), float(y), float(z))

    def __iter__(self) -> Iterator[PointXYZ]:
        for row in self._pts:
            yield PointXYZ(float(row[0]), float(row[1]), float(row[2]))

    # -- array API (the native surface here)
    @property
    def points(self) -> np.ndarray:
        """(N, 3) float64 view of the cloud."""
        return self._pts

    def as_matrix(self) -> np.ndarray:
        """3xN matrix (the solver input layout)."""
        return self._pts.T.copy()

    @classmethod
    def from_matrix(cls, m: np.ndarray) -> "PointCloud":
        return cls(np.asarray(m))

    @classmethod
    def from_points(cls, pts: Iterable) -> "PointCloud":
        return cls(np.asarray([[p.x, p.y, p.z] if isinstance(p, PointXYZ) else tuple(p) for p in pts]))
