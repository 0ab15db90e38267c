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


# Dtype of each field of the certifier's loop state (it, m, best, traj, done,
# v_psd, lam_psd, v_gap, lam_gap, sat): None for the working float dtype.
_DRS_STATE_DTYPES = (torch.int32, None, None, None, torch.bool, None, None, None, None,
                     torch.bool)


def drs_state_from_numpy(state, consts, device, dtype):
    """The certifier's ITERATIVE loop state from numpy arrays, as tensors.

    ``state`` holds the 10 arrays and ``consts`` the 3 of the JAX package's
    ``_iterative_init`` (state0, consts) of one problem, or of a checkpoint
    written by either package's ``certify_checkpointed`` (``s0``..``s9``,
    ``c0``..``c2``). The counter stays int32 and the flags bool; every float
    array takes ``dtype``. Returns (state, consts) as tuples of tensors on
    ``device``, the port's unbatched form.
    """
    if len(state) != len(_DRS_STATE_DTYPES) or len(consts) != 3:
        raise ValueError("a certifier state has 10 arrays and its constants 3")
    state = tuple(torch.as_tensor(np.array(a), device=device).to(d or dtype)
                  for a, d in zip(state, _DRS_STATE_DTYPES))
    consts = tuple(torch.as_tensor(np.array(a), device=device).to(dtype) for a in consts)
    return state, consts


def drs_state_to_numpy(state, consts):
    """Inverse of :func:`drs_state_from_numpy`: the 10 + 3 arrays in the JAX
    package's dtypes (int32 counter, bool flags, floats as they are)."""
    return tuple(_to_numpy(v) for v in state), tuple(_to_numpy(v) for v in consts)
