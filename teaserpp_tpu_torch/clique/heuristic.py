"""Heuristic maximum clique via parallel greedy expansion.

Counterpart of ``teaserpp_tpu/clique/heuristic.py``: ``num_seeds`` greedy
expansions from the highest-core vertices, each step taking the candidate
with the highest core number, and the largest clique wins. The JAX package
``vmap``s one ``while_loop`` over the seeds; here the seeds are a batch
``(S, N)`` in one Python loop with one host sync a step, and a seed whose
candidates have run out keeps its state, as a finished ``vmap`` lane does.

One problem at a time: ``adj`` is ``(N, N)``, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from teaserpp_tpu_torch.clique.kcore import core_numbers


class HeuristicCliqueResult(NamedTuple):
    mask: torch.Tensor  # (N,) bool membership of the best clique found
    size: torch.Tensor  # scalar int32
    max_core: torch.Tensor  # scalar int32 (clique upper bound is max_core + 1)
    core: torch.Tensor  # (N,) int32 core numbers (reused by callers)


def _greedy_from_seed(
    seeds: torch.Tensor, adj: torch.Tensor, score: torch.Tensor, skip: torch.Tensor
) -> torch.Tensor:
    """Grow one clique per seed by repeated best-candidate picks.

    ``seeds`` (S,) int64, ``adj`` (N, N) bool, ``score`` (N,) int32 ->
    members (S, N) bool. ``skip`` (scalar bool) empties the initial candidate
    sets, so the loop runs no step and each seed's clique is the seed alone.
    """
    n = adj.shape[-1]
    lanes = torch.arange(seeds.shape[0], device=adj.device)
    member = torch.zeros((seeds.shape[0], n), dtype=torch.bool, device=adj.device)
    member[lanes, seeds] = True
    cand = adj[seeds] & ~skip
    neg = torch.tensor(-1, dtype=score.dtype, device=adj.device)
    while True:
        running = cand.any(dim=-1)
        if not bool(running.any()):  # the step's one host sync
            return member
        # argmax takes the first maximum, as jnp.argmax does; a finished lane
        # picks vertex 0 from its all -1 row, so only running lanes take
        # their pick (an OR with `running`, which needs no host sync)
        pick = torch.argmax(torch.where(cand, score, neg), dim=-1)
        member[lanes, pick] |= running
        cand = cand & adj[pick]  # a finished lane's candidates stay empty


def heuristic_max_clique(
    adj: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    num_seeds: int = 64,
    skip: Optional[torch.Tensor] = None,
    core: Optional[torch.Tensor] = None,
) -> HeuristicCliqueResult:
    """Best clique over ``num_seeds`` parallel greedy expansions.

    Args:
      adj: (N, N) bool symmetric adjacency, zero diagonal.
      valid: optional (N,) vertex validity mask (padding support).
      num_seeds: number of high-core seed vertices to expand from.
      skip: optional scalar bool; when True the greedy loops run no step and
        the result mask is meaningless (the caller's k-core shortcut supplies
        the answer).
      core: optional precomputed (N,) int32 core numbers (saves a second
        k-core peel when the caller already ran one).
    """
    n = adj.shape[-1]
    if valid is not None:
        valid = valid.to(torch.bool)
        adj = adj & valid[None, :] & valid[:, None]
    if core is None:
        core = core_numbers(adj[None], None if valid is None else valid[None])[0]
    max_core = core.amax()
    num_seeds = min(num_seeds, n)
    skip = (
        torch.zeros((), dtype=torch.bool, device=adj.device)
        if skip is None else torch.as_tensor(skip, dtype=torch.bool, device=adj.device)
    )

    # Seeds: the num_seeds highest-core vertices (ties broken by index).
    seeds = torch.sort(core, descending=True, stable=True).indices[:num_seeds]
    members = _greedy_from_seed(seeds, adj, core, skip)
    sizes = members.sum(dim=-1, dtype=torch.int32)
    best = torch.argmax(sizes)
    mask = members[best]
    if valid is not None:
        mask = mask & valid
    return HeuristicCliqueResult(mask=mask, size=sizes[best], max_core=max_core, core=core)
