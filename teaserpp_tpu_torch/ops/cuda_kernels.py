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

As in the JAX package, only ``trim_bits`` sits on a solver path; the other
two are public operations of this module. All three kernels evaluate each
unordered pair of a problem once, through one tile loop
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
from teaserpp_tpu_torch.ops.tims import _pdist2, trim_pred_sq

LAUNCHES = {"trim_bits": 0, "trim_bits_slab": 0, "trim_degrees": 0, "trim_adjacency_i8": 0}

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


_POINTER, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

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
