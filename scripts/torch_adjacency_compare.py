#!/usr/bin/env python3
"""Time another build of the dense int8 TRIM adjacency kernel beside the
package's ``csrc/trim_adjacency.cu``, in one process on one card.

    python3 scripts/torch_adjacency_compare.py OTHER.cu [OTHER2.cu ...] [--rounds 3]

Each OTHER source must export the package's C interface
(``trim_adjacency_launch(src, dst, out, batch, n, beta, stream)``), for
example the kernel of an earlier revision
(``git show <rev>:teaserpp_tpu_torch/csrc/trim_adjacency.cu > old.cu``). It is
built with the package's ``nvcc`` flags into a temporary directory. At the
shapes that ``chip_smoke.py`` times, (64, 1889) and (1, 16384), and at
(1, 46341), every build is first held against the plain PyTorch version byte
for byte, then all are timed in turns, ``--rounds`` times: the package, each
other, each other again, the package (median of 20 launches by CUDA events
each). Prints the card's name and power limit, then one JSON line a shape.
Exits non-zero without CUDA, or when a build differs from the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _load_other(source: Path, workdir: Path) -> ctypes.CDLL:
    from teaserpp_tpu_torch.ops import _build

    so = workdir / f"lib{source.stem}_{abs(hash(str(source)))}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {source}:", line.strip(), flush=True)
    return ctypes.CDLL(str(so))


def _launcher(lib: ctypes.CDLL):
    fn = lib.trim_adjacency_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(src, dst, beta):
        import torch

        bsz, _, n = src.shape
        out = torch.empty((bsz, n, n), dtype=torch.int8, device=src.device)
        rc = fn(src.data_ptr(), dst.data_ptr(), out.data_ptr(), bsz, n,
                float(np.float32(beta)), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")
        return out

    return run


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("others", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_adjacency_compare: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from teaserpp_tpu_torch.ops import _build
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.ops.tims import trim_beta

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    builds = {"package": _launcher(_build.load_library("trim_adjacency"))}
    with tempfile.TemporaryDirectory() as tmp:
        for source in args.others:
            builds[str(source)] = _launcher(_load_other(source, Path(tmp)))

        src_main, dst_main = cs.make_problems(cs.BATCH, cs.N_POINTS, seed=3, shared_cloud=False)
        large_src, large_dst, *_ = cs.make_large_problem(cs.LARGE_N)
        wide_src, wide_dst, *_ = cs.make_large_problem(cs.WIDE_N, seed=17)
        shapes = [
            (src_main[:cs.DENSE_BATCH], dst_main[:cs.DENSE_BATCH], trim_beta(cs.NOISE_BOUND)),
            (large_src[None, :, :cs.DENSE_N], large_dst[None, :, :cs.DENSE_N],
             trim_beta(cs.LARGE_NOISE_BOUND)),
            (wide_src[None], wide_dst[None], trim_beta(cs.LARGE_NOISE_BOUND)),
        ]
        device = torch.device("cuda")
        ok = True
        for s_np, d_np, beta in shapes:
            s, d = cs._to(device, np.ascontiguousarray(s_np), np.ascontiguousarray(d_np))
            want = ck.trim_adjacency_i8_plain(s, d, beta)
            equal = {}
            for name, run in builds.items():
                got = run(s, d, beta)
                torch.cuda.synchronize()
                equal[name] = bool(torch.equal(got, want))
                del got
            del want
            ok = ok and all(equal.values())
            order = ["package", *[o for o in builds if o != "package"]]
            turns = order + order[1:][::-1] + ["package"]
            times = {name: [] for name in builds}
            for _ in range(args.rounds):
                for name in turns:
                    times[name].append(cs.time_ms(lambda: builds[name](s, d, beta), 20, device))
            bound_ms, bound_by, _, terms = cs.trim_adjacency_bound_ms(s.shape[0], s.shape[-1])
            print(json.dumps(dict(batch=int(s.shape[0]), n=int(s.shape[-1]), equal_to_plain=equal,
                                  ms=times, bound_ms=bound_ms, bound_by=bound_by,
                                  bound_terms_ms=terms, card=card)), flush=True)
            del s, d
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
