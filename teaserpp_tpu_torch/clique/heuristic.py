"""Heuristic maximum clique via parallel greedy expansion, batched.

Counterpart of ``teaserpp_tpu/clique/heuristic.py``: ``num_seeds`` greedy
expansions from the highest-core vertices, each step taking the candidate
with the highest core number (ties to the lowest index), and the largest
clique wins (the first of equal size). The JAX package ``vmap``s one
``while_loop`` over the seeds, and the batched pipeline ``vmap``s that over
the problems; here every lane of every problem runs in one launch of the
``greedy_clique`` kernel (``ops/cuda_kernels.py``) on the adjacency's packed
words, with no host sync. A step's pick is the first candidate in the
problem's core order (core numbers descending, then index ascending), which
is the JAX argmax's pick; a lane whose candidates have run out stops, as a
finished ``vmap`` lane keeps its state.

:func:`heuristic_max_clique` takes a dense ``(B, N, N)`` adjacency and packs
its rows; :func:`heuristic_max_clique_from_bits` takes the row-packed
``(B, W, N)`` words of K1 (``ops/cuda_kernels.py::trim_bits``) as they are,
with no unpacked adjacency.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from teaserpp_tpu_torch.clique.kcore import core_numbers, pack_bits_u32, unpack_bits_u32_rows
from teaserpp_tpu_torch.ops.cuda_kernels import greedy_clique


class HeuristicCliqueResult(NamedTuple):
    mask: torch.Tensor  # (B, N) bool membership of the best clique found
    size: torch.Tensor  # (B,) int32
    max_core: torch.Tensor  # (B,) int32 (clique upper bound is max_core + 1)
    core: torch.Tensor  # (B, N) int32 core numbers (reused by callers)


def greedy_order_and_allowed(
    core: torch.Tensor, valid: Optional[torch.Tensor] = None, skip=None
) -> tuple:
    """The ``greedy_clique`` kernel's ``order`` and ``allowed`` from ``(B, N)``
    int32 core numbers: each problem's core order (a stable descending sort:
    core numbers descending, ties by index; its first entries are the
    seeds), and the packed vertices that may be candidates, ``valid`` (every
    vertex when None) and none where ``skip`` (a (B,) or scalar bool) is set.
    """
    bsz, n = core.shape
    allowed = pack_bits_u32(torch.ones((bsz, n), dtype=torch.bool, device=core.device)
                            if valid is None else valid)
    if skip is not None:
        skip = torch.as_tensor(skip, dtype=torch.bool, device=core.device).expand(bsz)
        allowed = allowed.masked_fill(skip[:, None], 0)
    order = torch.sort(core, dim=-1, descending=True, stable=True).indices.to(torch.int32)
    return order, allowed


def _best_clique(rows, n, core, valid, num_seeds, skip) -> HeuristicCliqueResult:
    """The greedy over adjacency rows ``(B, N, W)`` int32 (bit ``j`` of word
    ``[b, v, w]``: vertex ``32 w + j`` is adjacent to ``v``)."""
    bsz, dev = rows.shape[0], rows.device
    order, allowed = greedy_order_and_allowed(core, valid, skip)
    members, sizes = greedy_clique(rows, order, allowed, min(num_seeds, n))
    best = torch.argmax(sizes, dim=-1)  # the first largest, as jnp.argmax
    lanes = torch.arange(bsz, device=dev)
    mask = unpack_bits_u32_rows(members[lanes, best][..., None], n)[..., 0]
    if valid is not None:
        mask = mask & valid
    return HeuristicCliqueResult(mask=mask, size=sizes[lanes, best],
                                 max_core=core.amax(dim=-1), core=core)


def heuristic_max_clique_from_bits(
    adj_bits: torch.Tensor,
    n: int,
    core: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    num_seeds: int = 64,
    skip: Optional[torch.Tensor] = None,
) -> HeuristicCliqueResult:
    """Best clique over ``num_seeds`` greedy expansions a problem, on the
    row-packed ``(B, W, N)`` int32 words of a symmetric adjacency (bit ``b``
    of word ``[p, w, j]``: pair ``(32 w + b, j)``), with its ``(B, N)``
    int32 core numbers. By symmetry the words' transpose holds each
    vertex's row as ``W`` consecutive words, the kernel's layout: one copy
    of the words. ``valid`` and ``skip`` as in :func:`heuristic_max_clique`.
    """
    rows = adj_bits.transpose(-1, -2).contiguous()
    return _best_clique(rows, n, core, valid, num_seeds, skip)


def heuristic_max_clique(
    adj: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    num_seeds: int = 64,
    skip: Optional[torch.Tensor] = None,
    core: Optional[torch.Tensor] = None,
) -> HeuristicCliqueResult:
    """Best clique over ``num_seeds`` parallel greedy expansions a problem.

    Args:
      adj: (B, N, N) bool symmetric adjacency, zero diagonal; (N, N) is a
        batch of one and returns unbatched fields.
      valid: optional (B, N) vertex validity mask (padding support): an
        invalid vertex is never a candidate, and an invalid seed's clique is
        the seed alone.
      num_seeds: number of high-core seed vertices to expand from.
      skip: optional (B,) bool (a scalar for all); a problem whose flag is
        set runs no greedy step and its mask is meaningless (the caller's
        k-core shortcut supplies the answer).
      core: optional precomputed (B, N) int32 core numbers (saves a second
        k-core peel when the caller already ran one).
    """
    single = adj.dim() == 2
    if single:
        adj = adj[None]
        valid = None if valid is None else torch.as_tensor(valid)[None]
        core = None if core is None else core[None]
    if valid is not None:
        valid = valid.to(device=adj.device, dtype=torch.bool)
    if core is None:
        core = core_numbers(adj, valid)
    res = _best_clique(pack_bits_u32(adj), adj.shape[-1], core, valid, num_seeds, skip)
    return HeuristicCliqueResult(*[f[0] for f in res]) if single else res
