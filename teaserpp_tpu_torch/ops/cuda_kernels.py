"""Hand-written CUDA kernels of the port, their plain versions and launch counts.

Counterpart of ``teaserpp_tpu/ops/pallas_kernels.py``:

* ``trim_bits`` (``csrc/trim_bits.cu``) replaces
  ``pallas_kernels.py::trim_adjacency_bits_pallas``, batched and masked;
  given a word-row range it launches the same file's row-slab kernel
  (counted as ``trim_bits_slab``), the row-sharded words of a mesh.
* ``trim_degrees`` (``csrc/trim_degrees.cu``) replaces
  ``pallas_kernels.py::trim_degrees_pallas``, batched.
* ``trim_adjacency_i8`` (``csrc/trim_adjacency.cu``) replaces
  ``pallas_kernels.py::trim_adjacency_pallas``, batched.
* ``greedy_clique`` (``csrc/greedy_clique.cu``) replaces no Pallas kernel:
  it runs every step of the batched greedy clique
  (``clique/heuristic.py``), which the JAX package writes as a ``vmap``ped
  ``lax.while_loop``, in one launch.
* ``tls_sweep`` (``csrc/tls_sweep.cu``, kernel S) replaces no Pallas kernel:
  it sweeps the sorted events of the scale TLS (``ops/tls.py::scalar_tls``),
  which the JAX package writes as ``jnp`` sorts and cumulative sums, in
  four to six launches, each counted.
* ``gnc_tls`` (``csrc/gnc_tls.cu``, kernel R) replaces no Pallas kernel: it
  runs every round of the GNC-TLS rotation loop
  (``solvers/rotation.py::_solve_gnc_tls``), which the JAX package writes as
  a ``vmap``ped ``lax.while_loop``, in one launch, one block a problem.
* ``neighbor_plans`` (``csrc/neighbor_plans.cu``) replaces no Pallas kernel:
  it builds the front end's grid-hash neighbour plans, which both packages
  build in host numpy (``features/spatial.py``); its wrapper and plain
  version are ``features/spatial.py::build_neighbor_plans_tensor`` and
  ``build_neighbor_plans_plain``.

As in the JAX package, of the three TRIM kernels only ``trim_bits`` sits on
a solver path; the other two are public operations of this module. All
three evaluate each unordered pair of a problem once, through one tile loop
(``csrc/trim_tile.cuh``) over the upper triangle of 32x32 blocks of pairs,
and use the result for both orientations.

A wrapper launches its kernel for CUDA tensors and counts the launch in
:data:`LAUNCHES`; for CPU tensors it runs the plain PyTorch version (and
counts nothing). There is no fallback from the card to the plain version:
anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from teaserpp_tpu_torch.clique.kcore import pack_bits_u32_rows
from teaserpp_tpu_torch.ops import _build
from teaserpp_tpu_torch.ops.procrustes import rotate, svd_rot, svd_rot_2d
from teaserpp_tpu_torch.ops.tims import _pdist2, trim_pred_sq
from teaserpp_tpu_torch.ops.tls import _SCAN_BLOCK, prefix_sum

LAUNCHES = {"trim_bits": 0, "trim_bits_slab": 0, "trim_degrees": 0, "trim_adjacency_i8": 0,
            "greedy_clique": 0, "tls_sweep": 0, "gnc_tls": 0, "neighbor_plans": 0}

# Pairs per chunk of the plain version: bounds its float intermediates to a
# few hundred MB whatever the batch and N.
_PLAIN_CHUNK_PAIRS = 1 << 26


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def word_rows(n: int, rows) -> tuple:
    """``rows`` (a word-row range ``(w0, w1)``, or None for all) checked
    against the ``ceil(n/32)`` word rows of N = ``n``."""
    words = (n + 31) // 32
    if rows is None:
        return 0, words
    w0, w1 = (int(r) for r in rows)
    if not 0 <= w0 <= w1 <= words:
        raise ValueError(f"word rows {rows} outside [0, {words}] of N={n}")
    return w0, w1


def trim_adjacency_bits_plain(
    src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor, beta: float,
    rows=None,
) -> torch.Tensor:
    """Plain PyTorch version of the ``trim_bits`` kernel.

    ``(B, 3, N)`` float32 points and ``(B, N)`` bool validity ->
    ``(B, ceil(N/32), N)`` int32 words; bit ``b`` of word ``[p, w, j]`` is the
    TRIM predicate of pair ``(32 w + b, j)`` of problem ``p``, masked by the
    diagonal and by both vertices' validity. With ``rows = (w0, w1)``, only
    the word rows ``[w0, w1)``: ``(B, w1 - w0, N)`` (the slab kernel's
    plain version). Chunked over the batch, or over 32-row bands at large
    N, so memory stays bounded.
    """
    bsz, _, n = src.shape
    row0, words = word_rows(n, rows)
    out = torch.empty((bsz, words - row0, n), dtype=torch.int32, device=src.device)
    col = torch.arange(n, device=src.device)
    per_problem = max(1, (words - row0) * 32 * n)
    if per_problem <= _PLAIN_CHUNK_PAIRS:
        b_step, w_step = max(1, _PLAIN_CHUNK_PAIRS // per_problem), max(1, words - row0)
    else:
        b_step, w_step = 1, max(1, _PLAIN_CHUNK_PAIRS // (32 * n))
    for b0 in range(0, bsz, b_step):
        b1 = min(b0 + b_step, bsz)
        s, d, v = src[b0:b1], dst[b0:b1], valid[b0:b1]
        for w0 in range(row0, words, w_step):
            w1 = min(w0 + w_step, words)
            r0, r1 = 32 * w0, min(32 * w1, n)
            pred = trim_pred_sq(
                _pdist2(s[..., r0:r1], s), _pdist2(d[..., r0:r1], d), beta
            )
            row = col[r0:r1]
            pred &= row[:, None] != col[None, :]
            pred &= v[:, r0:r1, None] & v[:, None, :]
            out[b0:b1, w0 - row0:w1 - row0] = pack_bits_u32_rows(pred)
    return out


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_POINTER, _INT, _LONG, _FLOAT, _DOUBLE = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_float, ctypes.c_double)

# argument types of each library's ``<name>_launch``
_LAUNCH_ARGTYPES = {
    # src, dst, valid, out, batch, n, b2, stream
    "trim_bits": [_POINTER, _POINTER, _POINTER, _POINTER, _INT, _INT, _FLOAT, _POINTER],
    # src, dst, valid, out, batch, n, w0, w1, b2, stream
    "trim_bits_slab": [_POINTER, _POINTER, _POINTER, _POINTER, _INT, _INT, _INT, _INT,
                       _FLOAT, _POINTER],
    # src, dst, out, batch, n, b2, stream
    "trim_degrees": [_POINTER, _POINTER, _POINTER, _INT, _INT, _FLOAT, _POINTER],
    # src, dst, out, batch, n, beta, stream
    "trim_adjacency": [_POINTER, _POINTER, _POINTER, _INT, _INT, _FLOAT, _POINTER],
    # rows, order, allowed, members, sizes, batch, n, seeds, stream
    "greedy_clique": [_POINTER, _POINTER, _POINTER, _POINTER, _POINTER, _INT, _INT, _INT,
                      _POINTER],
    # x, ranges, vmask, packed, count, f64, stream
    "tls_pack": [_POINTER, _POINTER, _POINTER, _POINTER, _LONG, _INT, _POINTER],
    # in, out, rows, len, stride, stream
    "tls_carry": [_POINTER, _POINTER, _LONG, _LONG, _LONG, _POINTER],
    # perm, packed, totals, last, batch, n, tiles, f64, stream
    "tls_totals": [_POINTER, _POINTER, _POINTER, _POINTER, _INT, _INT, _LONG, _INT, _POINTER],
    # perm, packed, carry, last, tile_cost, tile_x_hat, batch, n, tiles, f64, stream
    "tls_sweep": [_POINTER, _POINTER, _POINTER, _POINTER, _POINTER, _POINTER, _INT, _INT, _LONG,
                  _INT, _POINTER],
    # src, dst, valid, noise_bound, noise_bound_all, rotation, weights, cost, iterations,
    # batch, d, n, gnc_factor, max_iterations, cost_threshold, f64, stream
    "gnc_tls": [_POINTER, _POINTER, _POINTER, _POINTER, _DOUBLE, _POINTER, _POINTER, _POINTER,
                _POINTER, _INT, _INT, _LONG, _DOUBLE, _INT, _DOUBLE, _INT, _POINTER],
    # pts, lohi, cell, n, keys, stream
    "plan_keys": [_POINTER, _POINTER, _DOUBLE, _LONG, _POINTER, _POINTER],
    # skey, uniq, lens, lohi, cell, n, block, reach, words, mark, wsum, stream
    "plan_mark": [_POINTER, _POINTER, _POINTER, _POINTER, _DOUBLE, _LONG, _INT, _INT, _LONG,
                  _POINTER, _POINTER, _POINTER],
    # mark, wsum, starts, lens, nblocks, words, mpad, fill, out, stream
    "plan_cands": [_POINTER, _POINTER, _POINTER, _POINTER, _LONG, _LONG, _INT, _INT, _POINTER,
                   _POINTER],
}


def _launch(lib_name: str, counter: str, device: torch.device, *args,
            entry: str = None) -> None:
    """Call ``<entry>_launch(*args, stream)`` of library ``lib_name``
    (``entry`` defaults to ``lib_name``) on ``device``'s current stream,
    raise on a refused launch, and count the launch. The launch functions
    check their own grid limits and refuse what they do not take."""
    lib = _build.load_library(lib_name)
    entry = entry or lib_name
    fn = getattr(lib, f"{entry}_launch")
    err = getattr(lib, f"{lib_name}_error_string")
    if fn.argtypes is None:
        fn.argtypes = _LAUNCH_ARGTYPES[entry]
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: {err(rc).decode()} ({rc})")
    LAUNCHES[counter] += 1


def _check_points(name: str, src: torch.Tensor, dst: torch.Tensor):
    """Checks of a wrapper's ``(B, 3, N)`` float32 inputs, on either device
    -> (B, N)."""
    if src.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {src.device}")
    if src.dim() != 3 or src.shape[1] != 3:
        raise ValueError(f"src must be (B, 3, N), got {tuple(src.shape)}")
    bsz, _, n = src.shape
    _check("src", src, torch.float32, (bsz, 3, n), src.device)
    _check("dst", dst, torch.float32, (bsz, 3, n), src.device)
    return bsz, n


def trim_bits(
    src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor, beta: float,
    rows=None,
) -> torch.Tensor:
    """Batched TRIM adjacency bit words: the ``trim_bits`` kernel's wrapper.

    ``src``/``dst`` ``(B, 3, N)`` float32 and ``valid`` ``(B, N)`` bool, all
    contiguous on one device; returns ``(B, ceil(N/32), N)`` int32. On the CPU
    this is :func:`trim_adjacency_bits_plain`; on CUDA the kernel launches on
    the current stream without synchronising: one warp task per word row and
    group of column blocks on or right of the diagonal (the schedule is
    ``csrc/trim_tile.cuh``'s), each unordered 32x32 block of pairs evaluated
    once and both of its orientations stored, so every word of the
    uninitialised output is written exactly once. A batch or N beyond the
    launch's grid limits raises.

    ``rows = (w0, w1)`` asks for the word rows ``[w0, w1)`` only, ``(B, w1 -
    w0, N)``, equal bit for bit to those rows of the whole: on CUDA the
    row-slab kernel (``trim_bits_slab_launch``, counted as
    ``trim_bits_slab``), whose every word is written once too; all rows
    ``(0, W)`` are the whole launch above, and an empty range launches
    nothing.
    """
    bsz, n = _check_points("trim_bits", src, dst)
    _check("valid", valid, torch.bool, (bsz, n), src.device)
    w0, w1 = word_rows(n, rows)
    if src.device.type == "cpu":
        return trim_adjacency_bits_plain(src, dst, valid, beta, rows=rows)
    out = torch.empty((bsz, w1 - w0, n), dtype=torch.int32, device=src.device)
    if bsz == 0 or n == 0 or w0 == w1:
        return out
    b2 = float(np.float32(beta * beta))  # rounded once to f32, as in JAX
    if (w0, w1) == (0, (n + 31) // 32):
        _launch("trim_bits", "trim_bits", src.device, src.data_ptr(), dst.data_ptr(),
                valid.data_ptr(), out.data_ptr(), bsz, n, b2)
    else:
        _launch("trim_bits", "trim_bits_slab", src.device, src.data_ptr(),
                dst.data_ptr(), valid.data_ptr(), out.data_ptr(), bsz, n, w0, w1, b2,
                entry="trim_bits_slab")
    return out


def _row_bands(bsz: int, n: int):
    """(b0, b1, r0, r1) chunks of a (B, N, N) pair grid, each within the plain
    versions' pair budget: whole problems, or row bands of one problem."""
    if n * n <= _PLAIN_CHUNK_PAIRS:
        b_step, r_step = max(1, _PLAIN_CHUNK_PAIRS // max(1, n * n)), n
    else:
        b_step, r_step = 1, max(1, _PLAIN_CHUNK_PAIRS // n)
    for b0 in range(0, bsz, b_step):
        for r0 in range(0, n, max(1, r_step)):
            yield b0, min(b0 + b_step, bsz), r0, min(r0 + r_step, n)


def trim_degrees_plain(src: torch.Tensor, dst: torch.Tensor, beta: float) -> torch.Tensor:
    """Plain PyTorch version of the ``trim_degrees`` kernel.

    ``(B, 3, N)`` float32 points -> ``(B, N)`` int32 TRIM-graph degrees:
    ``deg[p, j]`` counts the ``i != j`` whose pair passes the sqrt-free TRIM
    predicate. Chunked over the batch, or over row bands at large N.
    """
    bsz, _, n = src.shape
    deg = torch.zeros((bsz, n), dtype=torch.int32, device=src.device)
    col = torch.arange(n, device=src.device)
    for b0, b1, r0, r1 in _row_bands(bsz, n):
        s, d = src[b0:b1], dst[b0:b1]
        pred = trim_pred_sq(_pdist2(s[..., r0:r1], s), _pdist2(d[..., r0:r1], d), beta)
        pred &= col[r0:r1, None] != col[None, :]
        deg[b0:b1] += pred.sum(dim=-2, dtype=torch.int32)
    return deg


def trim_degrees(src: torch.Tensor, dst: torch.Tensor, beta: float) -> torch.Tensor:
    """Batched TRIM-graph degrees: the ``trim_degrees`` kernel's wrapper.

    ``src``/``dst`` ``(B, 3, N)`` float32, contiguous on one device; returns
    ``(B, N)`` int32, equal to the popcount row sums of :func:`trim_bits` with
    every point valid. On the CPU this is :func:`trim_degrees_plain`; on CUDA
    the kernel launches on the current stream without synchronising, on the
    grid of :func:`trim_bits`: each unordered pair is evaluated once and
    counted toward both of its vertices with integer atomic adds into a
    zeroed output, which is exact whatever order they land in.
    """
    bsz, n = _check_points("trim_degrees", src, dst)
    if src.device.type == "cpu":
        return trim_degrees_plain(src, dst, beta)
    out = torch.zeros((bsz, n), dtype=torch.int32, device=src.device)  # the kernel adds
    if bsz == 0 or n == 0:
        return out
    b2 = float(np.float32(beta * beta))  # rounded once to f32, as in JAX
    _launch("trim_degrees", "trim_degrees", src.device, src.data_ptr(),
            dst.data_ptr(), out.data_ptr(), bsz, n, b2)
    return out


def _gram_dist(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(..., 3, R) x (..., 3, C) -> (..., R, C) Gram-form distances:
    ``sqrt(max(a2 + b2 - 2 (ax bx + ay by + az bz), 0))``, every sum left to
    right and elementwise, the kernel's order."""
    def norm2(v):
        x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
        return x * x + y * y + z * z

    gram = (rows[..., 0, :, None] * cols[..., 0, None, :]
            + rows[..., 1, :, None] * cols[..., 1, None, :]
            + rows[..., 2, :, None] * cols[..., 2, None, :])
    d2 = (norm2(rows)[..., :, None] + norm2(cols)[..., None, :]) - 2.0 * gram
    return torch.sqrt(torch.clamp(d2, min=0.0))


def trim_adjacency_i8_plain(src: torch.Tensor, dst: torch.Tensor, beta: float) -> torch.Tensor:
    """Plain PyTorch version of the ``trim_adjacency_i8`` kernel.

    ``(B, 3, N)`` float32 points -> ``(B, N, N)`` int8: 1 where
    ``|dist_src - dist_dst| <= beta`` (float32 compare) off the diagonal, the
    distances in Gram form. Chunked over the batch, or over row bands at
    large N, so the float fields stay bounded.
    """
    bsz, _, n = src.shape
    out = torch.empty((bsz, n, n), dtype=torch.int8, device=src.device)
    col = torch.arange(n, device=src.device)
    beta32 = torch.tensor(beta, dtype=torch.float32, device=src.device)
    for b0, b1, r0, r1 in _row_bands(bsz, n):
        s, d = src[b0:b1], dst[b0:b1]
        ds = _gram_dist(s[..., r0:r1], s)
        dd = _gram_dist(d[..., r0:r1], d)
        keep = (ds - dd).abs() <= beta32
        keep &= col[r0:r1, None] != col[None, :]
        out[b0:b1, r0:r1] = keep
    return out


def trim_adjacency_i8(src: torch.Tensor, dst: torch.Tensor, beta: float) -> torch.Tensor:
    """Batched dense int8 TRIM adjacency: the ``trim_adjacency_i8`` kernel's
    wrapper.

    ``src``/``dst`` ``(B, 3, N)`` float32, contiguous on one device; returns
    ``(B, N, N)`` int8 with a zero diagonal. Distances are in Gram form, so a
    pair at the threshold may differ from :func:`ops.tims.trim_adjacency_dense`.
    On the CPU this is :func:`trim_adjacency_i8_plain`; on CUDA the kernel
    launches on the current stream without synchronising, on the grid of
    :func:`trim_bits`: each unordered 32x32 block of pairs is evaluated once
    and stored in both orientations, so every byte of the uninitialised
    output is written exactly once. A batch or N beyond the launch's grid
    limits raises.
    """
    bsz, n = _check_points("trim_adjacency_i8", src, dst)
    if src.device.type == "cpu":
        return trim_adjacency_i8_plain(src, dst, beta)
    out = torch.empty((bsz, n, n), dtype=torch.int8, device=src.device)
    if bsz == 0 or n == 0:
        return out
    beta32 = float(np.float32(beta))
    _launch("trim_adjacency", "trim_adjacency_i8", src.device, src.data_ptr(),
            dst.data_ptr(), out.data_ptr(), bsz, n, beta32)
    return out


def greedy_clique_plain(
    rows: torch.Tensor, order: torch.Tensor, allowed: torch.Tensor, num_seeds: int
) -> tuple:
    """Plain PyTorch version of the ``greedy_clique`` kernel.

    ``rows`` (B, N, W) int32 adjacency rows (bit ``j`` of word ``[b, v, w]``:
    vertex ``32 w + j`` is adjacent to ``v``; zero diagonal), ``order``
    (B, N) int32 each problem's core order (a permutation of the vertices),
    ``allowed`` (B, W) int32 packed vertices that may be candidates ->
    ``members`` (B, S, W) int32 packed cliques and ``sizes`` (B, S) int32.
    Lane ``s`` of problem ``b`` is seeded with ``order[b, s]``; its
    candidates are the seed's row masked by ``allowed``, or none if the
    seed is not allowed. A step takes the first candidate in ``order`` at
    or past the lane's cursor, moves the cursor past it, and ANDs its row
    into the candidates; a lane with no candidate past its cursor is done.
    All lanes step together, one host sync a step.
    """
    bsz, n, _ = rows.shape
    dev = rows.device
    problem = torch.arange(bsz, device=dev)[:, None]  # (B, 1)
    order = order.long()
    seeds = order[:, :num_seeds]  # (B, S)
    cand = rows[problem, seeds] & allowed[:, None, :]
    open_ = (torch.gather(allowed, -1, seeds >> 5) >> (seeds & 31).to(torch.int32)) & 1 != 0
    cand = cand.masked_fill(~open_[..., None], 0)
    members = torch.zeros_like(cand)
    one = torch.ones_like(seeds, dtype=torch.int32)
    members.scatter_(-1, seeds[..., None] >> 5, (one << (seeds & 31).to(torch.int32))[..., None])
    sizes = one.clone()
    cursor = torch.zeros_like(seeds)
    position = torch.arange(n, device=dev)
    # each order entry's word and bit, as the lanes see them: (B, S, N), (B, 1, N)
    order_word = (order >> 5)[:, None, :].expand(-1, seeds.shape[1], -1)
    order_shift = (order & 31).to(torch.int32)[:, None, :]
    while True:
        hit = (torch.gather(cand, -1, order_word) >> order_shift) & 1 != 0
        hit &= position >= cursor[..., None]
        running = hit.any(dim=-1)
        if not bool(running.any()):  # the step's one host sync
            return members, sizes
        first = torch.argmax(hit.to(torch.int8), dim=-1)  # the first hit
        pick = torch.gather(order, 1, first)
        cursor = torch.where(running, first + 1, cursor)
        bit = torch.where(running, one << (pick & 31).to(torch.int32), 0)
        word = (pick >> 5)[..., None]
        members.scatter_(-1, word, torch.gather(members, -1, word) | bit[..., None])
        sizes += running.to(torch.int32)
        cand = torch.where(running[..., None], cand & rows[problem, pick], cand)


def greedy_clique(
    rows: torch.Tensor, order: torch.Tensor, allowed: torch.Tensor, num_seeds: int
) -> tuple:
    """The batched greedy clique: the ``greedy_clique`` kernel's wrapper.

    Arguments and results as :func:`greedy_clique_plain`'s, all contiguous
    int32 on one device, ``1 <= num_seeds <= N``. On the CPU this is
    :func:`greedy_clique_plain`; on CUDA the kernel launches on the current
    stream without synchronising, one warp a lane, and writes every word of
    its uninitialised outputs. Rows too long for a block's shared memory
    (N above ~929,000) raise.
    """
    if rows.device.type not in ("cuda", "cpu"):
        raise ValueError(f"greedy_clique runs on cuda or cpu, not {rows.device}")
    if rows.dim() != 3:
        raise ValueError(f"rows must be (B, N, W), got {tuple(rows.shape)}")
    bsz, n, words = rows.shape
    _check("rows", rows, torch.int32, (bsz, n, (n + 31) // 32), rows.device)
    _check("order", order, torch.int32, (bsz, n), rows.device)
    _check("allowed", allowed, torch.int32, (bsz, words), rows.device)
    if not 1 <= num_seeds <= n:
        raise ValueError(f"num_seeds {num_seeds} outside [1, {n}]")
    if rows.device.type == "cpu":
        return greedy_clique_plain(rows, order, allowed, num_seeds)
    members = torch.empty((bsz, num_seeds, words), dtype=torch.int32, device=rows.device)
    sizes = torch.empty((bsz, num_seeds), dtype=torch.int32, device=rows.device)
    if bsz == 0:
        return members, sizes
    _launch("greedy_clique", "greedy_clique", rows.device, rows.data_ptr(),
            order.data_ptr(), allowed.data_ptr(), members.data_ptr(), sizes.data_ptr(),
            bsz, n, num_seeds)
    return members, sizes


def tls_sweep_plain(
    perm: torch.Tensor, x: torch.Tensor, ranges: torch.Tensor, vmask: torch.Tensor
) -> tuple:
    """Plain PyTorch version of kernel S: the sweep of ``ops/tls.py::scalar_tls``.

    ``x``, ``ranges``, ``vmask`` (..., N) of one float dtype (``vmask`` 1 for
    a measurement, 0 for padding), ``perm`` (..., 2N) int64 the stable sort
    of the events ``[x - ranges, x + ranges]`` -> ``(estimate, cost)``
    (...,): the candidate of least cost, in ``torch.argmin``'s order. Each
    running quantity of the reference's sweep is a stream of signed deltas
    (+q opening, -q closing; reference registration.cc:63-68), gathered and
    scanned by :func:`prefix_sum`, one stream at a time, so only its scan
    outlives the stream; the candidate after each event is the weighted mean
    of the open set, its cost the unweighted squared residual of the open
    set plus the ranges of the closed ones, in the JAX package's float order.
    """
    w = vmask / torch.where(vmask > 0, ranges * ranges, torch.ones_like(x))

    def running(q):
        return prefix_sum(torch.gather(torch.cat([q, -q], dim=-1), -1, perm))

    # invalid measurements add nothing (q is 0 there). The ranges' total is
    # the last of their fixed-order prefix sums, not ``torch.sum``, whose
    # order on the card follows the number of rows: so a problem's bits do
    # not depend on the batch it is solved in.
    total_rng = prefix_sum(ranges * vmask)[..., -1:]
    card = running(vmask)
    cum_w = running(w)
    cum_xw = running(w * x)
    cum_rng = -running(ranges * vmask)  # outlier penalty: closing adds the range back
    cum_sx = running(x * vmask)
    cum_sx2 = running(x * x * vmask)
    outlier_pen = total_rng + cum_rng

    have_consensus = card > 0.5
    safe_w = torch.where(have_consensus, cum_w, torch.ones_like(cum_w))
    x_hat = cum_xw / safe_w
    residual = card * x_hat * x_hat + cum_sx2 - 2.0 * cum_sx * x_hat
    cost = residual + outlier_pen
    cost = torch.where(have_consensus, cost, torch.full_like(cost, float("inf")))

    min_idx = torch.argmin(cost, dim=-1, keepdim=True)
    estimate = torch.gather(x_hat, -1, min_idx)[..., 0]
    best_cost = torch.gather(cost, -1, min_idx)[..., 0]
    return estimate, best_cost


# Events a block of kernel S sweeps (a tile): 32 scan blocks of 64, as
# ``csrc/tls_sweep.cu``'s kTileBlocks, which the launch checks.
_TLS_TILE_EVENTS = 32 * _SCAN_BLOCK


def _carry_strides(blocks: int) -> list:
    """Strides of the carry's levels for rows of ``blocks`` totals: the
    powers of 64 below ``blocks``, and 1 always."""
    strides = [1]
    while strides[-1] * _SCAN_BLOCK < blocks:
        strides.append(strides[-1] * _SCAN_BLOCK)
    return strides


def tls_sweep(
    perm: torch.Tensor, x: torch.Tensor, ranges: torch.Tensor, vmask: torch.Tensor
) -> tuple:
    """The sweep of the scale TLS: kernel S's wrapper.

    Arguments and results as :func:`tls_sweep_plain`'s, float32 or float64,
    on one device. On the CPU this is :func:`tls_sweep_plain`; on CUDA the
    launches of ``csrc/tls_sweep.cu`` run on the current stream without
    synchronising, each counted in ``LAUNCHES["tls_sweep"]``: one packs each
    measurement's x, range, mask and weight into one entry; one writes the
    64-event block totals of the six streams and of the ranges' row; one a
    level scans the totals (the carry of :func:`prefix_sum`; levels 64^l
    below the row's ``ceil(2N / 64)`` blocks, at least one: three at N =
    1,889); and one sweeps the events in tiles of ``_TLS_TILE_EVENTS`` and
    writes each tile's first minimum, which ``torch.argmin`` reduces. The
    bits are the plain version's on the CPU. No measurement (N = 0), or a
    batch beyond the launch's grid, raises.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"tls_sweep runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or float64")
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    for name, t, dtype, shape in (("ranges", ranges, x.dtype, x.shape),
                                  ("vmask", vmask, x.dtype, x.shape),
                                  ("perm", perm, torch.int64, (*lead, 2 * n))):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {tuple(shape)} on {x.device}")
    if x.device.type == "cpu":
        return tls_sweep_plain(perm, x, ranges, vmask)
    if n == 0:
        raise ValueError("tls_sweep needs at least one measurement a row")
    bsz = int(np.prod(lead, dtype=np.int64))
    if bsz == 0:
        empty = torch.empty(lead, dtype=x.dtype, device=x.device)
        return empty, empty.clone()
    x, ranges, vmask, perm = (t.contiguous() for t in (x, ranges, vmask, perm))
    if perm.data_ptr() % 16:  # the kernel loads a lane's two entries at once
        perm = perm.clone()
    blocks = -(-2 * n // _SCAN_BLOCK)
    tiles = -(-2 * n // _TLS_TILE_EVENTS)
    f64 = int(x.dtype == torch.float64)
    packed = torch.empty((bsz, n, 4), dtype=x.dtype, device=x.device)
    _launch("tls_sweep", "tls_sweep", x.device, x.data_ptr(), ranges.data_ptr(),
            vmask.data_ptr(), packed.data_ptr(), bsz * n, f64, entry="tls_pack")
    totals = torch.empty((bsz, 7, blocks), dtype=torch.float64, device=x.device)
    last = torch.empty((bsz,), dtype=torch.float64, device=x.device)
    _launch("tls_sweep", "tls_sweep", x.device, perm.data_ptr(), packed.data_ptr(),
            totals.data_ptr(), last.data_ptr(), bsz, n, tiles, f64, entry="tls_totals")
    # the carry: the totals' scan, one launch a level l, the passes k in
    # [64^l, 64^(l+1)) of the scan
    carry, spare = totals, torch.empty_like(totals)
    for stride in _carry_strides(blocks):
        _launch("tls_sweep", "tls_sweep", x.device, carry.data_ptr(), spare.data_ptr(),
                bsz * 7, blocks, stride, entry="tls_carry")
        carry, spare = spare, carry
    del totals, spare
    tile_cost = torch.empty((bsz, tiles), dtype=x.dtype, device=x.device)
    tile_x_hat = torch.empty_like(tile_cost)
    _launch("tls_sweep", "tls_sweep", x.device, perm.data_ptr(), packed.data_ptr(),
            carry.data_ptr(), last.data_ptr(), tile_cost.data_ptr(), tile_x_hat.data_ptr(),
            bsz, n, tiles, f64)
    best = torch.argmin(tile_cost, dim=-1, keepdim=True)
    return (torch.gather(tile_x_hat, -1, best).reshape(lead),
            torch.gather(tile_cost, -1, best).reshape(lead))


def _gnc_tls_weight_update(residuals_sq, weights, mu, noise_bound_sq, valid_f):
    """Closed-form TLS weight update (reference registration.cc:827-844).

    ``mu`` and ``noise_bound_sq`` are (..., 1); the cost uses the previous
    weights.
    """
    th1 = (mu + 1.0) / mu * noise_bound_sq
    th2 = mu / (mu + 1.0) * noise_bound_sq
    cost = torch.sum(weights * residuals_sq, dim=-1)
    safe_r = torch.clamp(residuals_sq, min=1e-30)
    interp = torch.sqrt(noise_bound_sq * mu * (mu + 1.0) / safe_r) - mu
    new_w = torch.where(
        residuals_sq >= th1,
        torch.zeros_like(weights),
        torch.where(residuals_sq <= th2, torch.ones_like(weights), interp),
    )
    return cost, new_w * valid_f


def gnc_tls_plain(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound,
    gnc_factor: float,
    max_iterations: int,
    cost_threshold: float,
    valid,
    procrustes,
):
    """Plain PyTorch version of kernel R: the GNC-TLS loop over a batch of
    (B, d, N) inputs, the 3-D solve with ``procrustes=svd_rot``, the 2-D
    (Quatro) with ``svd_rot_2d``.

    One Python loop serves the batch: each round updates every problem still
    running, freezes the carry of the others with ``torch.where`` and makes
    one host sync for all of them, so each problem stops after the same
    ``iterations`` as in JAX. ``noise_bound`` is a float or a (B,) tensor;
    ``valid`` (B, N) bool masks padding, and an invalid column carries zero
    weight throughout. Returns (R (B, d, d), weights (B, N), cost (B,),
    iterations (B,) int32).
    """
    dtype, dev = src.dtype, src.device
    bsz, d, n = src.shape
    valid_f = (
        torch.ones((bsz, n), dtype=dtype, device=dev)
        if valid is None else valid.to(dtype)
    )
    # noise bound per problem (it depends on the scale estimate);
    # degenerate fallback per reference registration.cc:794-796
    nb_sq = torch.as_tensor(noise_bound, dtype=dtype, device=dev).expand(bsz) ** 2
    nb_sq = torch.where(nb_sq < 1e-16, torch.full_like(nb_sq, 1e-2), nb_sq)[:, None]

    i = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    r = torch.eye(d, dtype=dtype, device=dev).expand(bsz, d, d).clone()
    weights = valid_f
    mu = torch.ones((bsz, 1), dtype=dtype, device=dev)
    prev_cost = torch.full((bsz,), float("inf"), dtype=dtype, device=dev)
    done = torch.zeros((bsz,), dtype=torch.bool, device=dev)

    while True:
        running = (i < max_iterations) & ~done
        if not bool(running.any()):  # the round's one host sync
            break
        r_new = procrustes(src, dst, weights)
        diff = dst - rotate(r_new, src)
        residuals_sq = torch.sum(diff * diff, dim=-2) * valid_f

        # mu initialization on the first iteration (reference
        # registration.cc:814-825); mu <= 0 means residuals are already tiny
        max_residual = residuals_sq.amax(dim=-1, keepdim=True)
        mu0 = 1.0 / (2.0 * max_residual / nb_sq - 1.0)
        is_first = (i == 0)[:, None]
        mu_new = torch.where(is_first, mu0, mu)
        degenerate = is_first & (mu_new <= 0)

        new_cost, new_w = _gnc_tls_weight_update(
            residuals_sq, weights, mu_new, nb_sq, valid_f
        )
        # on the degenerate break the reference keeps the all-ones weights
        new_w = torch.where(degenerate, weights, new_w)
        new_cost = torch.where(degenerate[:, 0], prev_cost, new_cost)

        converged = torch.abs(new_cost - prev_cost) < cost_threshold
        new_done = degenerate[:, 0] | converged
        mu_new = torch.where(degenerate, mu_new, mu_new * gnc_factor)

        run_col = running[:, None]
        i = torch.where(running, i + 1, i)
        r = torch.where(running[:, None, None], r_new, r)
        weights = torch.where(run_col, new_w, weights)
        mu = torch.where(run_col, mu_new, mu)
        prev_cost = torch.where(running, new_cost, prev_cost)
        done = torch.where(running, new_done, done)
    return r, weights, prev_cost, i


# The Procrustes solve kernel R runs for each d
_GNC_PROCRUSTES = {3: svd_rot, 2: svd_rot_2d}


def gnc_tls(
    src: torch.Tensor,
    dst: torch.Tensor,
    noise_bound,
    gnc_factor: float,
    max_iterations: int,
    cost_threshold: float,
    valid,
    procrustes,
):
    """The GNC-TLS rotation loop: kernel R's wrapper.

    Arguments and results as :func:`gnc_tls_plain`'s: ``src``/``dst``
    (B, d, N) float32 or float64 on one device, d = 3 with ``svd_rot`` or
    d = 2 with ``svd_rot_2d``; ``valid`` None or (B, N) bool; ``noise_bound``
    a number or a tensor of B values (or one). On the CPU this is
    :func:`gnc_tls_plain`; on CUDA ``csrc/gnc_tls.cu`` runs every round of
    every problem in one launch on the current stream, one block a problem,
    without synchronising, and writes every element of its uninitialised
    outputs. Its sums over the N columns run in one fixed order of its own,
    so R and the cost lie within rounding of the plain version's, and repeat
    bit for bit. N = 0 with a round to run raises, as the plain version does.
    """
    if src.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gnc_tls runs on cuda or cpu, not {src.device}")
    if src.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"src has dtype {src.dtype}, expected float32 or float64")
    if src.dim() != 3 or src.shape[1] not in _GNC_PROCRUSTES:
        raise ValueError(f"src must be (B, 2 or 3, N), got {tuple(src.shape)}")
    bsz, d, n = src.shape
    if procrustes is not _GNC_PROCRUSTES[d]:
        raise ValueError(f"at d = {d} the loop solves with {_GNC_PROCRUSTES[d].__name__}")
    checks = [("dst", dst, src.dtype, (bsz, d, n))]
    if valid is not None:
        checks.append(("valid", valid, torch.bool, (bsz, n)))
    for name, t, dtype, shape in checks:
        if t.device != src.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {src.device}")
    if src.device.type == "cpu":
        return gnc_tls_plain(src, dst, noise_bound, gnc_factor, max_iterations, cost_threshold,
                             valid, procrustes)
    if n == 0 and max_iterations > 0:
        raise ValueError("gnc_tls needs at least one column a problem")
    if isinstance(noise_bound, (int, float)):
        nb, nb_all = None, float(noise_bound)
    else:
        nb = torch.as_tensor(noise_bound, dtype=src.dtype, device=src.device)
        nb, nb_all = nb.expand(bsz).contiguous(), 0.0
    src, dst = src.contiguous(), dst.contiguous()
    valid = None if valid is None else valid.contiguous()
    weights = torch.empty((bsz, n), dtype=src.dtype, device=src.device)
    rotation = torch.empty((bsz, d, d), dtype=src.dtype, device=src.device)
    cost = torch.empty((bsz,), dtype=src.dtype, device=src.device)
    iterations = torch.empty((bsz,), dtype=torch.int32, device=src.device)
    if bsz == 0:
        return rotation, weights, cost, iterations
    _launch("gnc_tls", "gnc_tls", src.device, src.data_ptr(), dst.data_ptr(),
            None if valid is None else valid.data_ptr(), None if nb is None else nb.data_ptr(),
            nb_all, rotation.data_ptr(), weights.data_ptr(), cost.data_ptr(),
            iterations.data_ptr(), bsz, d, n, float(gnc_factor), int(max_iterations),
            float(cost_threshold), int(src.dtype == torch.float64))
    return rotation, weights, cost, iterations
