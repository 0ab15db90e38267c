"""ctypes bridge to the native exact max-clique solver.

Counterpart of ``teaserpp_tpu/clique/exact.py``. The solver is host C++, not a
kernel: the port keeps its own copy of the source, ``csrc/maxclique.cc``,
which ``ops/_build.py`` compiles with ``g++`` at first use into
``teaserpp_tpu_torch/_build/`` (a hash-named library, rebuilt when the source
changes). This is the host-side tail of the exact huge-N path
(``parallel/sharded.py::solve_large_exact``) and the role PMC plays for the
reference (graph.cc:105-122).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

from teaserpp_tpu_torch.ops import _build


def _load() -> ctypes.CDLL:
    lib = _build.load_library("maxclique")
    if lib.tpureg_max_clique.argtypes is None:  # first use: declare the C interface
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i32, f64 = ctypes.c_int32, ctypes.c_double
        lib.tpureg_max_clique_mt.restype = ctypes.c_int
        lib.tpureg_max_clique_mt.argtypes = [u64p, i32, i32, f64, i32, i32p, i32p]
        lib.tpureg_core_numbers.restype = None
        lib.tpureg_core_numbers.argtypes = [u64p, i32, i32, i32p]
        lib.tpureg_max_clique_sparse.restype = ctypes.c_int
        lib.tpureg_max_clique_sparse.argtypes = [i64p, i32p, i32, f64, i32, i32p, i32p]
        lib.tpureg_core_numbers_csr.restype = None
        lib.tpureg_core_numbers_csr.argtypes = [i64p, i32p, i32, i32p]
        lib.tpureg_max_clique.restype = ctypes.c_int
        lib.tpureg_max_clique.argtypes = [u64p, i32, i32, f64, i32p, i32p]  # last: the marker
    return lib


def pack_adjacency(adj: np.ndarray) -> Tuple[np.ndarray, int]:
    """Pack an (N, N) bool adjacency into row-major uint64 bitset words."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    words = (n + 63) // 64
    bits = np.packbits(adj, axis=1, bitorder="little")
    row_bytes = np.zeros((n, words * 8), dtype=np.uint8)
    row_bytes[:, : bits.shape[1]] = bits
    return row_bytes.view(np.uint64).reshape(n, words), words


def exact_max_clique(
    adj: np.ndarray, time_limit: float = 3600.0, num_threads: int = 1
) -> Tuple[List[int], bool]:
    """Exact maximum clique of a dense boolean adjacency matrix.

    Returns (sorted vertex list, timed_out). Under time pressure the best
    clique found so far is returned with ``timed_out=True`` (PMC semantics).
    ``num_threads`` > 1 searches root subtrees on worker threads that share
    the incumbent bound (the reference's PMC OpenMP model, graph.cc:38);
    ``num_threads <= 0`` uses all hardware threads.
    """
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if n == 0:
        return [], False
    lib = _load()
    packed, words = pack_adjacency(adj)
    packed = np.ascontiguousarray(packed)
    out = np.zeros(n, dtype=np.int32)
    flag = np.zeros(1, dtype=np.int32)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    size = lib.tpureg_max_clique_mt(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.int32(n),
        np.int32(words),
        ctypes.c_double(time_limit),
        np.int32(num_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flag.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return sorted(int(v) for v in out[:size]), bool(flag[0])


def exact_max_clique_sparse(
    indptr: np.ndarray,
    indices: np.ndarray,
    n: int,
    time_limit: float = 3600.0,
    num_threads: int = 1,
) -> Tuple[List[int], bool]:
    """Exact maximum clique of a symmetric CSR graph (both edge directions).

    The large-N path — the analog of PMC's sparse ``search`` the reference
    switches to at V >= 20000 (graph.cc:114-121). O(E + N) bucket k-core
    peel for the degeneracy order; each root then branch-and-bounds on the
    dense bitset graph induced on its later-ordered neighbors (size bounded
    by the degeneracy), so memory stays O(E + d^2/8) regardless of N.

    Returns (sorted vertex list, timed_out).
    """
    if n == 0:
        return [], False
    lib = _load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    assert indptr.shape[0] == n + 1
    out = np.zeros(n, dtype=np.int32)
    flag = np.zeros(1, dtype=np.int32)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    size = lib.tpureg_max_clique_sparse(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.int32(n),
        ctypes.c_double(time_limit),
        np.int32(num_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flag.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return sorted(int(v) for v in out[:size]), bool(flag[0])


def adjacency_to_csr(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense bool adjacency -> (indptr int64, indices int32) symmetric CSR."""
    adj = np.asarray(adj, dtype=bool)
    counts = adj.sum(axis=1).astype(np.int64)
    indptr = np.zeros(adj.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.nonzero(adj)[1].astype(np.int32)
    return indptr, indices


def native_core_numbers_csr(
    indptr: np.ndarray, indices: np.ndarray, n: int
) -> np.ndarray:
    """Core numbers via the O(E + N) bucket peel (large-N parity oracle)."""
    lib = _load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    out = np.zeros(n, dtype=np.int32)
    lib.tpureg_core_numbers_csr(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.int32(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def native_core_numbers(adj: np.ndarray) -> np.ndarray:
    """Core numbers from the native library (parity oracle for the device peel)."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    lib = _load()
    packed, words = pack_adjacency(adj)
    packed = np.ascontiguousarray(packed)
    out = np.zeros(n, dtype=np.int32)
    lib.tpureg_core_numbers(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.int32(n),
        np.int32(words),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
