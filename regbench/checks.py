"""The comparison that decides ``correct``.

Every answer the window produced is held against the plain reference of its
problem (the configuration's ``reference/<name>.py``), computed after the
window from the same inputs. Nothing is sampled: the reference solves each
problem of the pool that was answered once, and every answer of that
problem is compared with it, so the pool bounds the reference's cost. Four
numbers a problem, each against the cell's limit:

* ``set_diff``: vertices in one selected inlier set and not the other (the
  program's clique against the reference's maximum clique);
* ``rot_gap_deg``: the angle between the two rotations, in degrees;
* ``trans_gap_m``: the distance between the two translations, in metres;
* ``scale_gap``: ``|s - s_ref| / s_ref``, the scales' relative gap.

A problem whose reference could not certify its maximum clique counts in
``undecided``, whose limit is 0. A cell whose ``limits`` name both of
``CERTIFICATE_NUMBERS`` also holds each answer's optimality certificate
(``optimal``, the certifier's verdict, and ``suboptimality``, its best
gap) against the reference's:

* ``cert_flips``: the answers whose verdict differs from the reference's;
* ``subopt_diff``: ``|suboptimality - reference's|``, in the gap's own
  units; a NaN on either side reads 1e30, equal infinities 0.

There an answer without a certificate (NaN in both) reads as a flip and
1e30, and a reference without one raises. Other cells compare the first
five numbers alone. The run is correct when the worst answer of each
number is within its limit; ``failed`` counts the answers over any.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np

CERTIFICATE_NUMBERS = ("cert_flips", "subopt_diff")
CERTIFICATE = ("optimal", "suboptimality")  # the fields of a certificate, in an answer's order


class Verdict(NamedTuple):
    worst: Dict[str, float]  # each number compared: its worst reading over the answers
    limits: Dict[str, float]
    compared: int
    failed: int

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(self.worst[k] <= self.limits[k] for k in self.worst)

    def lines(self) -> list:
        return [f"{k} {self.worst[k]!r} limit {self.limits[k]!r}" for k in self.worst]

    def as_json(self) -> dict:
        return {k: {"value": self.worst[k], "limit": self.limits[k]} for k in self.worst}


def certifying(limits: Dict[str, float]) -> bool:
    """Whether a cell's ``limits`` hold the certificates: both numbers of
    ``CERTIFICATE_NUMBERS`` named, or neither."""
    named = [k for k in CERTIFICATE_NUMBERS if k in limits]
    if named and len(named) != len(CERTIFICATE_NUMBERS):
        raise ValueError(f"limits name {named[0]} alone: a certifying cell names both of "
                         f"{', '.join(CERTIFICATE_NUMBERS)}")
    return bool(named)


def rotation_gap_deg(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """Angle of ``r1^T r2`` for ``(..., 3, 3)`` rotations, from the chord
    ``||r1 - r2||_F = 2 sqrt(2) sin(angle / 2)``, exact at small angles."""
    chord = np.linalg.norm(np.asarray(r1, np.float64) - np.asarray(r2, np.float64),
                           axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.minimum(1.0, chord / (2.0 * math.sqrt(2.0)))))


def compare(rotation, translation, scale, inliers, ref_rotation, ref_translation, ref_scale,
            ref_inliers, ref_decided, limits: Dict[str, float], *,
            optimal: Optional[np.ndarray] = None, suboptimality: Optional[np.ndarray] = None,
            ref_optimal: Optional[np.ndarray] = None,
            ref_suboptimality: Optional[np.ndarray] = None) -> Verdict:
    """Answers ``(A, 3, 3)``, ``(A, 3)``, ``(A,)``, ``(A, n)`` against the
    references of their problems, row for row. Where ``limits`` name the
    certificate numbers, the answers' certificates ``(A,)`` (``optimal``
    bool or 0/1, NaN in both where an answer has none; None where no answer
    has one) against the references' ``(A,)``, which must be given."""
    cert = certifying(limits)
    if cert and (ref_optimal is None or ref_suboptimality is None):
        raise ValueError("the cell compares certificates and the reference gives none")
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
    if cert:
        missing = np.full(len(set_diff), np.nan)
        opt = missing if optimal is None else np.asarray(optimal, np.float64)
        sub = missing if suboptimality is None else np.asarray(suboptimality, np.float64)
        ref_sub = np.asarray(ref_suboptimality, np.float64)
        flips = opt != np.asarray(ref_optimal, np.float64)  # NaN, no certificate, flips
        with np.errstate(invalid="ignore"):
            gap = np.where(sub == ref_sub, 0.0, np.abs(sub - ref_sub))  # equal infinities: 0
        gap = np.where(np.isfinite(gap), gap, 1e30)
        over |= (flips.astype(int) > limits["cert_flips"]) | (gap > limits["subopt_diff"])
        worst.update(cert_flips=int(flips.sum()), subopt_diff=float(gap.max(initial=0.0)))
    return Verdict(worst, {k: limits.get(k, 0) for k in worst}, int(len(set_diff)),
                   int(over.sum()))
