#!/usr/bin/env python3
"""Times of the port's CUDA kernels on the card: one JSON line for each row
of PERF.md's table of kernels, then each library's ptxas registers and
spills as ``ops/_build.py`` logged them. Needs a CUDA card; under a minute
on an H100::

    python3 scripts/torch_kernel_times.py

Rows, at the table's shapes and on tests/chip_support.py's inputs: K1
(``trim_bits``) at (512, 1889) with a quarter of the problems padded,
(1, 65536) and (1, 100000), and its row slab on the two halves of
(1, 100000); K2 (``trim_degrees``) at (512, 1889) and (1, 100000); K3
(``trim_adjacency_i8``) at (64, 1889), (1, 16384) and (1, 46341); kernel G
(``greedy_clique``, 64 seeds) on K1's words of 512 bunny problems,
``solve_large_sharded``'s 2,048-vertex subgraph and (7, 333) padded; kernel
S (``tls_sweep``) on one chunk of the unknown-scale batch in float32 and on
4 of its problems in float64; kernel R (``gnc_tls``, the GNC-TLS rotation
loop) on the chain TIMs of the 512 bunny problems' top cores, (512, 1889)
float32, and of the first alone, (1, 1889).

Times are CUDA events around one call, the median of 20 calls for a kernel
and of 3 for its plain version, each after one call to warm up. Bounds are
the least time the card could take for the inputs, from the card's
published peaks (``regbench/yardstick.py``; none for a card not in its
table): K1's is ``trim_bits_least_s``, the count the benchmark's
``k1_roofline`` divides by. This is a tool, not a gate:
tests/test_torch_chip_kernels.py and tests/test_torch_tls_sweep.py hold each
kernel to its plain version.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

# K3's Gram-form entry: per cloud 3 mul + 2 add (product), add, and
# `- 2 gram` as one FMA (doubling is exact, so fusing it rounds as the
# separate multiply and subtract do), max = 8; then one sub and one compare
# (the abs is an operand modifier); and two square roots, which run on an
# SM's 16 special-function units against its 128 FP32 lanes (Hopper white
# paper): at 1/8 of the FP32 rate.
GRAM_OPS_PER_PAIR = 2 * 8 + 2
GRAM_SQRTS_PER_PAIR = 2
SWEEP_BYTES_PER_EVENT = 16  # kernel S reads an event's int64 index in both passes
REPS, PLAIN_REPS = 20, 3


def time_ms(fn, reps: int) -> float:
    """Median time of one ``fn()`` in ms by CUDA events, after a warm call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(terms_s: dict) -> dict:
    """The largest of the least times in seconds, in ms, and what sets it."""
    if not terms_s:
        return dict(bound_ms=None, bound_by=None)
    name = max(terms_s, key=terms_s.get)
    return dict(bound_ms=terms_s[name] * 1e3, bound_by="bytes" if name == "bytes" else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from chip_support import (
        GREEDY_CASES,
        GREEDY_SEEDS,
        adjacency_case,
        gnc_tls_case,
        greedy_case,
        kernel_inputs,
        slab_cases,
        tls_sweep_case,
        to_device,
    )
    from regbench import yardstick
    from teaserpp_tpu_torch.ops import _build
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = yardstick.peaks(kind) or {}

    def least(ops: float = 0.0, nbytes: float = 0.0, sqrts: float = 0.0) -> dict:
        if not peaks:
            return bound({})
        terms = {"fp32": ops / peaks["fp32_ops_per_s"], "bytes": nbytes / peaks["hbm_bytes_per_s"]}
        if sqrts:
            terms["sqrt"] = sqrts / (peaks["fp32_ops_per_s"] / 8)
        return bound(terms)

    def report(kernel, shape, kernel_fn, plain_fn, **fields):
        print(json.dumps(dict(kernel=kernel, shape=shape, ms=time_ms(kernel_fn, REPS),
                              plain_ms=time_ms(plain_fn, PLAIN_REPS), **fields)), flush=True)

    inputs = kernel_inputs()
    trim_ops = yardstick.TRIM_OPS_PER_PAIR
    for case in ("main", "huge", "large"):
        s_np, d_np, v_np, beta = inputs[case]
        s, d, v = to_device("cuda", s_np, d_np, v_np)
        bsz, n = v_np.shape
        valid_counts = [int(m) for m in v_np.sum(axis=-1)]
        k1 = yardstick.trim_bits_least_s(valid_counts, n, kind)
        ops_s = (trim_ops * sum(m * (m - 1) // 2 for m in valid_counts)
                 / peaks["fp32_ops_per_s"]) if peaks else None
        report("K1", [bsz, n], lambda: ck.trim_bits(s, d, v, beta),
               lambda: ck.trim_adjacency_bits_plain(s, d, v, beta),
               bound_ms=None if k1 is None else k1 * 1e3,
               bound_by=None if k1 is None else "operations" if ops_s >= k1 else "bytes")

    for case, (w0, w1) in slab_cases()[:2]:  # the halves of (1, 100000)
        s_np, d_np, v_np, beta = inputs[case]
        s, d, v = to_device("cuda", s_np, d_np, v_np)
        bsz, n = v_np.shape
        # the predicate once for each unordered pair of valid points inside
        # the slab's rows, and once for each pair of a valid point of those
        # rows and one outside them (the slab holds no mirror of those)
        inside = v_np[:, 32 * w0:32 * w1].sum(axis=-1).astype(np.int64)
        outside = v_np.sum(axis=-1).astype(np.int64) - inside
        pairs = int(np.sum(inside * (inside - 1) // 2 + inside * outside))
        report("K1 slab", [bsz, n, w0, w1], lambda: ck.trim_bits(s, d, v, beta, rows=(w0, w1)),
               lambda: ck.trim_adjacency_bits_plain(s, d, v, beta, rows=(w0, w1)),
               **least(trim_ops * pairs, bsz * (2 * 3 * n * 4 + n) + bsz * (w1 - w0) * n * 4))

    for case in ("main", "large"):
        s_np, d_np, _, beta = inputs[case]
        s, d = to_device("cuda", s_np, d_np)
        bsz, _, n = s_np.shape
        report("K2", [bsz, n], lambda: ck.trim_degrees(s, d, beta),
               lambda: ck.trim_degrees_plain(s, d, beta),
               **least(trim_ops * bsz * n * (n - 1) // 2, bsz * (2 * 3 * n * 4 + n * 4)))

    for case in ("main", "large", "wide"):
        s_np, d_np, beta, _ = adjacency_case(case, inputs)
        s, d = to_device("cuda", s_np, d_np)
        bsz, _, n = s.shape
        pairs = bsz * n * (n - 1) // 2
        report("K3", [bsz, n], lambda: ck.trim_adjacency_i8(s, d, beta),
               lambda: ck.trim_adjacency_i8_plain(s, d, beta),
               **least(GRAM_OPS_PER_PAIR * pairs, bsz * (2 * 3 * n * 4 + n * n),
                       GRAM_SQRTS_PER_PAIR * pairs))

    for case in GREEDY_CASES:
        rows, order, allowed = greedy_case(case, "cuda", inputs)
        bsz, n, words = rows.shape
        seeds = min(GREEDY_SEEDS, n)
        _, sizes = ck.greedy_clique(rows, order, allowed, seeds)
        # the row words its lanes' steps read: sum over lanes of (size - 1) W 4 B
        row_bytes = int((sizes.long() - 1).clamp(min=0).sum()) * words * 4
        report("G", [bsz, n, seeds], lambda: ck.greedy_clique(rows, order, allowed, seeds),
               lambda: ck.greedy_clique_plain(rows, order, allowed, seeds),
               **least(nbytes=row_bytes), words_once_ms=least(nbytes=rows.numel() * 4)["bound_ms"])

    for case in ("chunk", "float64"):
        perm, x, ranges, vmask = tls_sweep_case(case, "cuda")
        report("S", [*x.shape, str(x.dtype)], lambda: ck.tls_sweep(perm, x, ranges, vmask),
               lambda: ck.tls_sweep_plain(perm, x, ranges, vmask),
               **least(nbytes=SWEEP_BYTES_PER_EVENT * perm.numel()))
        del perm, x, ranges, vmask

    for case in ("bunny_batch", "facade"):
        args = gnc_tls_case(case, "cuda", inputs)
        bsz, d, n = args["src"].shape
        _, _, cost, rounds = ck.gnc_tls(**args)
        # a pass reads each column's src, dst and valid once: H and the weights
        # a round, and round 0's largest residual where it goes on (a break
        # at mu0 <= 0 leaves the cost infinite and skips the weights' pass)
        passes = 2 * rounds.long() + torch.where(torch.isinf(cost), -1, 1)
        column_bytes = 2 * d * args["src"].element_size() + (args["valid"] is not None)
        report("R", [bsz, n, str(args["src"].dtype)], lambda: ck.gnc_tls(**args),
               lambda: ck.gnc_tls_plain(**args),
               **least(nbytes=int(passes.sum()) * n * column_bytes),
               rounds=[int(rounds.min()), int(rounds.max())])

    for name, so in _build.build_all().items():
        log = pathlib.Path(str(so) + ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        print(json.dumps({"library": name, "ptxas": [
            ln.strip() for ln in lines if "registers" in ln or "spill" in ln]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
