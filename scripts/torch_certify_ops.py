#!/usr/bin/env python3
"""Times the DRS certifier's float64 operations on the card at the shapes its
paths give them (``tests/test_torch_chip_certification.py``), one JSON line each:

* ``torch.linalg.eigh`` of (32, 404, 404) against 32 single calls (whether
  the installed torch runs the batch as one solver call), and of 404², 2000²,
  128² and 8²;
* ``torch.linalg.cholesky_ex`` of 604², 2000² and 4004²,
  ``torch.cholesky_solve`` of 604 x 128 and 604 x 8, ``torch.linalg.qr`` of
  604 x 128 and 604 x 8;
* the dual projection at npm 604 and at (32, 404);
* one ITERATIVE DRS iteration at npm 604, rank 128, from a state 25
  iterations into a run on a seeded 150-TIM problem.

Median of CUDA-event times; the card's name and power limit first. Needs a
card; about 30 s::

    python3 scripts/torch_certify_ops.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
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


def _sym(*shape, seed=0):
    import torch

    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(*shape, generator=gen, dtype=torch.float64)
    return (a + a.transpose(-1, -2)).cuda()


def _spd(n, seed=0):
    import torch

    a = _sym(n, n, seed=seed)
    return a + 2 * n ** 0.5 * 2 * torch.eye(n, dtype=torch.float64, device="cuda")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_certify_ops: no CUDA device", file=sys.stderr)
        return 1
    from teaserpp_tpu_torch.certification import drs
    from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType

    print(subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)

    def report(name, ms, **kw):
        print(json.dumps(dict(op=name, ms=ms, **kw)), flush=True)

    batch = _sym(32, 404, 404)
    report("eigh (32,404,404)", _time_ms(lambda: torch.linalg.eigh(batch), 3))
    report("eigh 32 x (404,404) one at a time",
           _time_ms(lambda: [torch.linalg.eigh(m) for m in batch], 3))
    report("eigvalsh (32,404,404)", _time_ms(lambda: torch.linalg.eigvalsh(batch), 3))
    for n in (8, 128, 404, 2000):
        a = _sym(n, n)
        report(f"eigh {n}", _time_ms(lambda: torch.linalg.eigh(a), 5 if n == 2000 else 10))
    for n in (604, 2000, 4004):
        a = _spd(n)
        report(f"cholesky_ex {n}", _time_ms(lambda: torch.linalg.cholesky_ex(a)))
    c = torch.linalg.cholesky(_spd(604))
    for k in (128, 8):
        b = torch.randn(604, k, dtype=torch.float64, device="cuda")
        report(f"cholesky_solve 604x{k}", _time_ms(lambda: torch.cholesky_solve(b, c)))
        report(f"qr 604x{k}", _time_ms(lambda: torch.linalg.qr(b)))

    for bsz, n in ((1, 150), (32, 100)):
        w = _sym(bsz, 4 * n + 4, 4 * n + 4)
        th = torch.ones(bsz, n + 1, dtype=torch.float64, device="cuda")
        i_idx, j_idx = drs._pair_indices(n + 1, "cuda")
        report(f"optimal_dual_projection ({bsz},{4 * n + 4})",
               _time_ms(lambda: drs.optimal_dual_projection(w, th, i_idx, j_idx)))

    rng = np.random.default_rng(0)
    n = 150
    v1 = rng.standard_normal((3, n))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.linalg.det(q))
    v2 = q @ v1 + rng.standard_normal((3, n)) * 0.005
    v2[:, :16] = rng.standard_normal((3, 16))
    theta = np.r_[-np.ones(16), np.ones(n - 16)]
    params = DRSCertifierParams(noise_bound=0.02, eig_decomposition_solver=EigSolverType.ITERATIVE,
                                psd_projection_rank=128, max_iterations=200)
    args = [torch.as_tensor(a, dtype=torch.float64, device="cuda")[None]
            for a in (q, v1, v2, theta)]
    state, consts = drs._iterative_init_batch(*args, params)
    state = drs._iterative_segment_batch(state, consts, params, 25)
    it0 = int(state[0][0])
    report("ITERATIVE DRS iteration, npm 604, rank 128",
           _time_ms(lambda: drs._iterative_segment_batch(state, consts, params, it0 + 1)),
           start_iteration=it0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
