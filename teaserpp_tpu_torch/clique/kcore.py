"""K-core decomposition over row-packed adjacency bits, batched.

Counterpart of ``teaserpp_tpu/clique/kcore.py``: the level-by-level peel
(:func:`core_numbers_from_bits`), the binary-search top core
(:func:`max_core_from_bits`), the fixed-k core (:func:`kcore_mask_from_bits`),
and the peel on a dense adjacency, packed (:func:`core_numbers_bitset`, which
:func:`core_numbers` is) or as masked row sums (:func:`core_numbers_matvec`).
The batch peel removes, each
round, every active vertex whose active degree is at most the current core
level ``k``; degrees are popcounts of the adjacency words ANDed with the
packed active set. The JAX package runs one ``lax.while_loop`` per problem
under ``vmap``; here the batch runs one Python loop with one host sync per
round, and a finished problem's carry is frozen, which gives the same core
numbers per problem.

Words are int32 bit patterns throughout (PyTorch lacks shifts on uint32):
bit ``b`` of a word is set iff the word's two's-complement value has it.

On a mesh each rank holds a slab of word rows (``parallel/sharded.py``):
:func:`active_degrees` of a slab counts only its rows, and the loops here
take a ``degrees`` function that sums those partial degrees over the ranks
(one all-reduce a round). Every host read that ends a loop then reads a
value computed from the summed degrees, the same on every rank, so no rank
leaves a loop while another waits in a collective.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _pack_last(bits: torch.Tensor) -> torch.Tensor:
    """Sum ``bits`` (..., 32) of 0/1 int32 into words: bit b = bits[..., b]."""
    shift = torch.arange(32, dtype=torch.int32, device=bits.device)
    # disjoint powers of two never carry, so the int32 sum is the OR
    return torch.sum(bits << shift, dim=-1, dtype=torch.int32)


def pack_bits_u32(mask: torch.Tensor) -> torch.Tensor:
    """Pack a (..., N) bool mask into (..., ceil(N/32)) int32 words.

    Bit j of word w holds element w*32+j; N is padded up with zeros.
    """
    n = mask.shape[-1]
    w = (n + 31) // 32
    bits = torch.nn.functional.pad(mask.to(torch.int32), (0, w * 32 - n))
    return _pack_last(bits.reshape(*mask.shape[:-1], w, 32))


def pack_bits_u32_rows(mask: torch.Tensor) -> torch.Tensor:
    """Pack a (..., N, M) bool matrix over its ROW axis into (..., W, M) words.

    Bit b of word [w, j] holds element [w*32+b, j].
    """
    n, m = mask.shape[-2], mask.shape[-1]
    w = (n + 31) // 32
    bits = torch.nn.functional.pad(mask.to(torch.int32), (0, 0, 0, w * 32 - n))
    bits = bits.reshape(*mask.shape[:-2], w, 32, m)
    return _pack_last(bits.transpose(-1, -2))


def unpack_bits_u32_rows(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits_u32_rows` on the device: (..., W, M) int32
    words -> (..., n, M) bool, element [i, j] = bit ``i % 32`` of word
    [i // 32, j].

    One shift and mask a bit position, each writing its rows ``b, b + 32,
    ...`` of the output; the temporaries are the size of the words.
    """
    out = torch.empty((*bits.shape[:-2], n, bits.shape[-1]), dtype=torch.bool,
                      device=bits.device)
    for b in range(min(32, n)):
        rows = (n - b + 31) // 32  # rows b, b + 32, ... below n
        out[..., b::32, :] = ((bits[..., :rows, :] >> b) & 1) != 0
    return out


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element bit count of int32 words (SWAR; PyTorch has no popcount).

    Each arithmetic right shift is followed by a mask that clears the copied
    sign bits, so negative words count like their uint32 patterns.
    """
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    # byte sums by shift-add: no int32 product that could overflow
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


# Words per chunk of a degree pass: bounds the AND and popcount temporaries
# to a few hundred MB when one problem's words are GBs (N = 100,000).
_DEGREE_CHUNK_WORDS = 1 << 25


def active_degrees(adj_bits: torch.Tensor, active: torch.Tensor,
                   word0: int = 0) -> torch.Tensor:
    """Degrees into the active set: ``deg[p, j] = sum_w popcount(adj_bits[p,
    w, j] & active_bits[p, w])``, ``(B, W, N)`` words and ``(B, N)`` bool ->
    ``(B, N)`` int32. Summed over chunks of word rows when the words are many;
    integer sums, so the chunking changes nothing. ``adj_bits`` may be the
    slab of word rows ``[word0, word0 + W)`` of the whole: the degrees then
    count the slab's rows only, and the slabs' degrees sum to the whole's."""
    bsz, words, n = adj_bits.shape
    act_bits = pack_bits_u32(active)[:, word0:word0 + words]  # (B, W)
    step = max(1, _DEGREE_CHUNK_WORDS // max(1, bsz * n))
    deg = torch.zeros((bsz, n), dtype=torch.int32, device=adj_bits.device)
    for w0 in range(0, words, step):
        live = adj_bits[:, w0:w0 + step] & act_bits[:, w0:w0 + step, None]
        deg += torch.sum(popcount32(live), dim=-2, dtype=torch.int32)
    return deg


def _initial_active(bsz: int, n: int, valid: Optional[torch.Tensor], device) -> torch.Tensor:
    if valid is None:
        return torch.ones((bsz, n), dtype=torch.bool, device=device)
    return valid.to(torch.bool).clone()


Degrees = Callable[[torch.Tensor], torch.Tensor]


def _whole(adj_bits: torch.Tensor, degrees: Optional[Degrees]) -> Degrees:
    """``degrees`` if given, else the degrees of the whole words ``adj_bits``."""
    return degrees or (lambda active: active_degrees(adj_bits, active))


def _kcore_fixpoint(degrees: Degrees, k: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Drop active vertices with active-degree < ``k`` (B, 1) until no problem
    changes. The k-core is unique, so running every problem until the last
    one is stable gives each problem its own fixpoint."""
    while True:
        keep = active & (degrees(active) >= k)
        if torch.equal(keep, active):  # the round's one host sync
            return keep
        active = keep


def max_core_from_bits(
    adj_bits: torch.Tensor, n: int, valid: Optional[torch.Tensor] = None,
    degrees: Optional[Degrees] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximum k-core mask and max core number, by binary search over k.

    Counterpart of the JAX package's function of the same name, with a batch
    dimension: each probe is a bulk-removal fixpoint at ``k = (lo + hi + 1)
    // 2`` from the last successful probe's survivors; a problem whose search
    has ended keeps its state. The nested ``lax.while_loop``s are Python
    loops with one host sync a round. Integer logic only, so mask and
    ``max_core`` equal the JAX package's exactly.

    ``degrees(active)`` gives the ``(B, N)`` degrees into ``active``; by
    default those of the whole words ``adj_bits`` (a slab's summed over a
    mesh in ``parallel/sharded.py``).

    Returns (mask (B, N) bool of the max-core vertices, max_core (B,) int32).
    """
    bsz = adj_bits.shape[0]
    degrees = _whole(adj_bits, degrees)
    base = _initial_active(bsz, n, valid, adj_bits.device)
    deg0 = degrees(base)
    zero = torch.zeros((), dtype=torch.int32, device=adj_bits.device)
    hi = torch.where(base, deg0, zero).amax(dim=-1)  # max_core <= max degree
    lo = torch.zeros_like(hi)
    while bool((lo < hi).any()):
        searching = lo < hi
        k = (lo + hi + 1) // 2
        probe = _kcore_fixpoint(degrees, k[:, None], base)
        ok = probe.any(dim=-1)
        lo = torch.where(searching & ok, k, lo)
        hi = torch.where(searching & ~ok, k - 1, hi)
        base = torch.where((searching & ok)[:, None], probe, base)
    return base, lo


def kcore_mask_from_bits(
    adj_bits: torch.Tensor,
    n: int,
    k,
    valid: Optional[torch.Tensor] = None,
    degrees: Optional[Degrees] = None,
) -> torch.Tensor:
    """(B, N) bool mask of each problem's ``k``-core on row-packed words.

    ``k`` is an int or a (B,) tensor. Bulk-removal fixpoint, as in the JAX
    package: with a clique lower bound ``lb``, every vertex of a maximum
    clique lies in the (lb-1)-core, so this mask is a safe pruning before the
    host exact search. ``degrees`` as in :func:`max_core_from_bits`.
    """
    bsz = adj_bits.shape[0]
    k = torch.as_tensor(k, dtype=torch.int32, device=adj_bits.device)
    k = k.expand(bsz)[:, None]
    active = _initial_active(bsz, n, valid, adj_bits.device)
    return _kcore_fixpoint(_whole(adj_bits, degrees), k, active)


def core_numbers_from_bits(
    adj_bits: torch.Tensor, n: int, valid: Optional[torch.Tensor] = None,
    degrees: Optional[Degrees] = None,
) -> torch.Tensor:
    """Core numbers from row-packed ``(B, W, N)`` int32 adjacency words.

    Invalid vertices get core number -1. Returns ``(B, N)`` int32.
    ``degrees`` as in :func:`max_core_from_bits`.
    """
    return _peel(adj_bits.shape[0], n, valid, adj_bits.device,
                 _whole(adj_bits, degrees))


def _peel(bsz: int, n: int, valid: Optional[torch.Tensor], dev,
          degrees: Degrees) -> torch.Tensor:
    """The batch peel over ``degrees(active)`` (B, N) int32 -> core numbers."""
    active = _initial_active(bsz, n, valid, dev)
    core = torch.full((bsz, n), -1, dtype=torch.int32, device=dev)
    k = torch.zeros((bsz, 1), dtype=torch.int32, device=dev)
    big = torch.tensor(n + 1, dtype=torch.int32, device=dev)
    while bool(active.any()):  # the round's one host sync
        running = active.any(dim=-1, keepdim=True)
        deg = degrees(active)
        mind = torch.where(active, deg, big).amin(dim=-1, keepdim=True)
        k = torch.where(running, torch.maximum(k, mind), k)
        remove = active & (deg <= k)
        core = torch.where(remove, k, core)
        active = active & ~remove
    return core


def core_numbers_bitset(
    adj: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Core numbers of a batched ``(B, N, N)`` bool symmetric adjacency.

    Packs the rows to words and peels them with :func:`core_numbers_from_bits`,
    so each round streams N^2 / 8 bytes a problem.
    """
    return core_numbers_from_bits(pack_bits_u32_rows(adj), adj.shape[-1], valid)


def core_numbers(
    adj: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Core numbers of a batched ``(B, N, N)`` bool symmetric adjacency, by
    :func:`core_numbers_bitset`. Invalid vertices get -1; ``(B, N)`` int32."""
    return core_numbers_bitset(adj, valid)


def core_numbers_matvec(
    adj: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Core numbers by the same batch peel with degrees as masked row sums.

    Counterpart of the JAX package's int8 matvec peel: each round's degrees
    are ``(adj & active).sum(-1)`` in int32, an integer contraction with no
    float accumulation, so the core numbers equal :func:`core_numbers_bitset`'s.
    ``(B, N, N)`` bool -> ``(B, N)`` int32, invalid vertices -1.
    """
    adj = adj.to(torch.bool)
    return _peel(adj.shape[0], adj.shape[-1], valid, adj.device,
                 lambda active: (adj & active[:, None, :]).sum(dim=-1, dtype=torch.int32))


def max_kcore_mask(
    adj: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertices of each problem's maximum k-core (reference graph.cc:70-80).

    Returns (mask (B, N) bool, max_core (B,) int32).
    """
    core = core_numbers(adj, valid)
    max_core = core.amax(dim=-1)
    mask = core >= max_core[:, None]
    if valid is not None:
        mask = mask & valid
    return mask, max_core
