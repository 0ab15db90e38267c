"""Heuristic maximum clique via parallel greedy expansion, batched.

Counterpart of ``teaserpp_tpu/clique/heuristic.py``: ``num_seeds`` greedy
expansions from the highest-core vertices, each step taking the candidate
with the highest core number, and the largest clique wins. The JAX package
``vmap``s one ``while_loop`` over the seeds, and the batched pipeline
``vmap``s that over the problems; here the lanes are a batch ``(B, S, N)``
in one Python loop with one host sync a step for the whole batch, and a lane
whose candidates have run out keeps its state, as a finished ``vmap`` lane
does.

``adj`` is ``(B, N, N)``; an ``(N, N)`` adjacency is a batch of one and
gets unbatched fields back, as the JAX function's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from teaserpp_tpu_torch.clique.kcore import core_numbers


class HeuristicCliqueResult(NamedTuple):
    mask: torch.Tensor  # (B, N) bool membership of the best clique found
    size: torch.Tensor  # (B,) int32
    max_core: torch.Tensor  # (B,) int32 (clique upper bound is max_core + 1)
    core: torch.Tensor  # (B, N) int32 core numbers (reused by callers)


def _greedy_from_seed(
    seeds: torch.Tensor, adj: torch.Tensor, score: torch.Tensor, skip: torch.Tensor
) -> torch.Tensor:
    """Grow one clique per lane by repeated best-candidate picks.

    ``seeds`` (B, S) int64, ``adj`` (B, N, N) bool, ``score`` (B, N) int32 ->
    members (B, S, N) bool. ``skip`` (B,) bool empties a problem's initial
    candidate sets, so its lanes run no step and each clique is its seed alone.

    Each vertex's adjacency row is held as 8-byte words (the bool row padded
    to a multiple of 8 with non-edges), so a step gathers its picks' rows and
    ANDs them into the candidates a word at a time; the scores are int16
    where they fit. The picks are the same: padded columns are never
    candidates.
    """
    bsz, num = seeds.shape
    n = adj.shape[-1]
    dev = adj.device
    words = -(-n // 8)
    if n % 8 == 0:
        rows = adj.reshape(bsz * n, n).contiguous().view(torch.int64)
    else:
        rows = torch.zeros((bsz * n, words * 8), dtype=torch.bool, device=dev)
        rows[:, :n] = adj.reshape(bsz * n, n)
        rows = rows.view(torch.int64)  # (B N, words)
    first_row = torch.arange(bsz, device=dev)[:, None] * n  # (B, 1)

    def rows_of(v):  # (B, S) vertices -> (B, S, words) their adjacency rows
        return rows.index_select(0, (first_row + v).reshape(-1)).view(bsz, num, words)

    cand = rows_of(seeds).masked_fill_(skip[:, None, None], 0)
    sdt = torch.int16 if n < 2 ** 15 else torch.int32
    padded = torch.full((bsz, 1, words * 8), -1, dtype=sdt, device=dev)
    padded[:, 0, :n] = score
    neg = torch.tensor(-1, dtype=sdt, device=dev)
    member = torch.zeros((bsz * num, n + 1), dtype=torch.bool, device=dev)  # column n: no pick
    member.scatter_(1, seeds.reshape(-1, 1), True)
    while True:
        running = cand.any(dim=-1)
        if not bool(running.any()):  # the step's one host sync
            return member[:, :n].view(bsz, num, n)
        # argmax takes the first maximum, as jnp.argmax does; a finished lane
        # (all -1) records its pick in the spare column n and ANDs an empty
        # set with the row it picked, so its state stays as it is
        pick = torch.argmax(torch.where(cand.view(torch.bool), padded, neg), dim=-1)
        member.scatter_(1, torch.where(running, pick, n).reshape(-1, 1), True)
        cand = cand & rows_of(pick)


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
      valid: optional (B, N) vertex validity mask (padding support).
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
    bsz, n = adj.shape[0], adj.shape[-1]
    if valid is not None:
        valid = valid.to(device=adj.device, dtype=torch.bool)
        adj = adj & valid[:, None, :] & valid[:, :, None]
    if core is None:
        core = core_numbers(adj, valid)
    max_core = core.amax(dim=-1)
    num_seeds = min(num_seeds, n)
    skip = (
        torch.zeros((bsz,), dtype=torch.bool, device=adj.device)
        if skip is None
        else torch.as_tensor(skip, dtype=torch.bool, device=adj.device).expand(bsz)
    )

    # Seeds: each problem's num_seeds highest-core vertices (ties by index).
    seeds = torch.sort(core, dim=-1, descending=True, stable=True).indices[:, :num_seeds]
    members = _greedy_from_seed(seeds, adj, core, skip)
    sizes = members.sum(dim=-1, dtype=torch.int32)  # (B, S)
    best = torch.argmax(sizes, dim=-1)
    rows = torch.arange(bsz, device=adj.device)
    mask = members[rows, best]
    if valid is not None:
        mask = mask & valid
    res = HeuristicCliqueResult(mask=mask, size=sizes[rows, best], max_core=max_core,
                                core=core)
    return HeuristicCliqueResult(*[f[0] for f in res]) if single else res
