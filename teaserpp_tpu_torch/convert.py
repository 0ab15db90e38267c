"""State carried between the JAX package and the port.

The registration engine has no weights: its state is the parameter struct
going in and the solution coming out. Both cross here without importing the
JAX package — a parameter instance is read field by field through
``dataclasses.fields`` and enums are matched by their integer value.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np
import torch

from teaserpp_tpu_torch import params as _params


def params_from_jax(p: Any):
    """Build the port's copy of a parameter struct from a JAX-package instance.

    The port's class is the one of the same name in
    :mod:`teaserpp_tpu_torch.params` (e.g. ``RobustRegistrationSolverParams``).
    """
    cls = getattr(_params, type(p).__name__, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"no port counterpart for {type(p).__name__}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = getattr(p, f.name)
        if isinstance(f.default, enum.IntEnum):
            value = type(f.default)(int(value))
        kwargs[f.name] = value
    return cls(**kwargs)


def _to_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def solution_to_numpy(sol):
    """Return ``sol`` (a NamedTuple of tensors) with every field as a numpy array."""
    return type(sol)(*[_to_numpy(v) for v in sol])


def large_result_to_numpy(res):
    """Return a ``LargeSolveResult`` of either package with numpy fields.

    ``res`` has the fields ``solution`` (a NamedTuple of arrays), ``max_core``
    and ``clique_size``; tensors and JAX arrays alike become numpy arrays, in
    the same NamedTuple types, so results of the two packages compare field
    by field.
    """
    return type(res)(
        solution=solution_to_numpy(res.solution),
        max_core=_to_numpy(res.max_core),
        clique_size=_to_numpy(res.clique_size),
    )
