"""The comparison that decides ``correct``.

Every answer the window produced (or a sample of them drawn from the seed,
where the traffic names one) is held against the plain reference of its
problem (the configuration's ``reference/<name>.py``), computed after the
window from the same inputs. Four numbers a problem, each against the
cell's limit:

* ``set_diff``: vertices in one selected inlier set and not the other (the
  program's clique against the reference's maximum clique);
* ``rot_gap_deg``: the angle between the two rotations, in degrees;
* ``trans_gap_m``: the distance between the two translations, in metres;
* ``scale_gap``: ``|s - s_ref| / s_ref``, the scales' relative gap.

A problem whose reference could not certify its maximum clique counts in
``undecided``, whose limit is 0. The run is correct when the worst answer
of each number is within its limit; ``failed`` counts the answers over any.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np

NUMBERS = ("set_diff", "rot_gap_deg", "trans_gap_m", "scale_gap", "undecided")


class Verdict(NamedTuple):
    worst: Dict[str, float]  # each number's worst reading over the answers compared
    limits: Dict[str, float]
    compared: int
    failed: int

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(self.worst[k] <= self.limits[k] for k in NUMBERS)

    def lines(self) -> list:
        return [f"{k} {self.worst[k]!r} limit {self.limits[k]!r}" for k in NUMBERS]

    def as_json(self) -> dict:
        return {k: {"value": self.worst[k], "limit": self.limits[k]} for k in NUMBERS}


def rotation_gap_deg(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """Angle of ``r1^T r2`` for ``(..., 3, 3)`` rotations, from the chord
    ``||r1 - r2||_F = 2 sqrt(2) sin(angle / 2)``, exact at small angles."""
    chord = np.linalg.norm(np.asarray(r1, np.float64) - np.asarray(r2, np.float64),
                           axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.minimum(1.0, chord / (2.0 * math.sqrt(2.0)))))


def compare(rotation, translation, scale, inliers, ref_rotation, ref_translation, ref_scale,
            ref_inliers, ref_decided, limits: Dict[str, float]) -> Verdict:
    """Answers ``(A, 3, 3)``, ``(A, 3)``, ``(A,)``, ``(A, n)`` against the
    references of their problems, row for row."""
    set_diff = np.sum(np.asarray(inliers, bool) != np.asarray(ref_inliers, bool), axis=-1)
    rot = rotation_gap_deg(rotation, ref_rotation)
    trans = np.linalg.norm(np.asarray(translation, np.float64)
                           - np.asarray(ref_translation, np.float64), axis=-1)
    ref_scale = np.asarray(ref_scale, np.float64)
    scale_gap = np.abs(np.asarray(scale, np.float64) - ref_scale) / ref_scale
    undecided = ~np.asarray(ref_decided, bool)
    # a NaN answer is as far off as can be, and stays a JSON number
    rot = np.where(np.isfinite(rot), rot, 180.0)
    trans = np.where(np.isfinite(trans), trans, 1e30)
    scale_gap = np.where(np.isfinite(scale_gap), scale_gap, 1e30)
    over = ((set_diff > limits["set_diff"]) | (rot > limits["rot_gap_deg"])
            | (trans > limits["trans_gap_m"]) | (scale_gap > limits["scale_gap"]) | undecided)
    worst = {
        "set_diff": int(set_diff.max(initial=0)),
        "rot_gap_deg": float(rot.max(initial=0.0)),
        "trans_gap_m": float(trans.max(initial=0.0)),
        "scale_gap": float(scale_gap.max(initial=0.0)),
        "undecided": int(undecided.sum()),
    }
    return Verdict(worst, {k: limits.get(k, 0) for k in NUMBERS}, int(len(set_diff)),
                   int(over.sum()))
