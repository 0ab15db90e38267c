"""The mesh paths on the card: one world of two gloo ranks sharing it, bit
for bit the ``mesh=None`` runs of this process, and a world of one over
NCCL.

Each rank of the gloo world runs this file as a script::

    python tests/test_torch_chip_mesh.py <rank> <address> <out dir> <device>

and runs (a) ``solve_large_sharded`` and ``solve_large_exact`` on the
N=100,000 problem on a (1, 2) mesh over ``pairs`` (K1 as row slabs),
(b) the synth100k pair through ``FPFHEstimation(neighbor_mode="grid")``
with its query blocks over both ranks, the matcher and
``solve_large_sharded`` on the (1, 2) mesh (its dense branch: no TRIM
kernel), (c) ``solve_batch_sharded`` on the 512 bunny problems on a (2, 1)
mesh over ``batch``; it writes its results to ``<out dir>/rank<r>.npz`` and
its launches to ``rank<r>.json``. Two ranks share one card: no scaling is
measured here.

Marked ``chip``: skips without a CUDA card. No JAX; on a machine with an
H100::

    python -m pytest tests/test_torch_chip_mesh.py -m chip --noconftest -p no:cacheprovider
"""

import datetime
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_support import (
    BATCH,
    EXACT_TIME_LIMIT_S,
    FRONTEND_N,
    FRONTEND_RADII,
    LARGE_N,
    N_POINTS,
    PARITY_TOL,
    bench_params,
    cuda_card,  # noqa: F401 (a fixture)
    frontend_gate,
    frontend_params,
    large_gate,
    large_params,
    launched,
    make_frontend_pair,
    make_large_problem,
    make_problems,
    to_device,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 2
TIMEOUT_S = 300.0  # the ranks' collectives give up after this
WAIT_S = 600.0  # the test kills a world that runs longer


def _fields(prefix: str, result) -> dict:
    """A result (LargeSolveResult, PipelineSolution, tensors, arrays) as
    {name: numpy array}, for an exact comparison across processes."""
    if isinstance(result, tuple) and hasattr(result, "_fields"):
        out = {}
        for k in result._fields:
            out.update(_fields(f"{prefix}.{k}", getattr(result, k)))
        return out
    if isinstance(result, torch.Tensor):
        result = result.detach().cpu().numpy()
    return {prefix: np.asarray(result)}


def _large_result_view(fields: dict, prefix: str):
    """A LargeSolveResult of numpy arrays from ``_fields`` output."""
    from teaserpp_tpu_torch.parallel.sharded import LargeSolveResult
    from teaserpp_tpu_torch.solvers.pipeline import PipelineSolution

    sol = PipelineSolution(*(fields[f"{prefix}.solution.{k}"] for k in PipelineSolution._fields))
    return LargeSolveResult(solution=sol, max_core=fields[f"{prefix}.max_core"],
                            clique_size=fields[f"{prefix}.clique_size"])


def mesh_frontend(device, src, dst, blocks=None, pairs=None) -> dict:
    """Case (b): FPFH on the grid route with its query blocks over
    ``blocks``, the matcher with cross-check, ``solve_large_sharded`` over
    ``pairs`` (``None``: one device), as ``_fields``."""
    from teaserpp_tpu_torch import solve_large_sharded
    from teaserpp_tpu_torch.features import FPFHEstimation, Matcher

    est = FPFHEstimation(neighbor_mode="grid", mesh=blocks, device=device)
    ds, dd = (est.computeFPFHFeatures(c, *FRONTEND_RADII) for c in (src, dst))
    corr = np.asarray(Matcher(device=device).calculateCorrespondences(
        src, dst, ds, dd, False, True, False, 0.95), np.int64).reshape(-1, 2)
    res = solve_large_sharded(np.ascontiguousarray(src[corr[:, 0]].T).astype(np.float32),
                              np.ascontiguousarray(dst[corr[:, 1]].T).astype(np.float32),
                              frontend_params(), mesh=pairs, device=device)
    return {**_fields("frontend", res), "frontend.corr": corr,
            **_fields("frontend.desc_src", ds), **_fields("frontend.desc_dst", dd)}


def rank_main(rank: int, address: str, out_dir: str, device_name: str) -> None:
    """One rank of the gloo world: cases (a)-(c) on ``device_name``."""
    import torch.distributed as dist
    from teaserpp_tpu_torch import solve_large_exact, solve_large_sharded
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.parallel import multihost as mh
    from teaserpp_tpu_torch.parallel import solve_batch_sharded

    device = torch.device(device_name)
    torch.cuda.set_device(device)
    mh.initialize_distributed(address, WORLD, rank, backend="gloo", timeout_s=TIMEOUT_S)
    pairs = mh.make_mesh(pairs_per_host=WORLD)  # (1, 2): the pair rows over both
    batch = mh.make_mesh(pairs_per_host=1)  # (2, 1): the batch over both
    blocks = mh.Mesh(np.arange(WORLD), ("blocks",))  # the front end's query blocks
    fields, launches = {}, {}

    def run(name, fn):
        dist.barrier()
        ck.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = dict(ck.LAUNCHES)
        return out

    src, dst = to_device(device, *make_large_problem(LARGE_N)[:2])
    fields.update(_fields("large", run("large", lambda: solve_large_sharded(
        src, dst, large_params(), mesh=pairs, device=device))))
    fields.update(_fields("exact", run("exact", lambda: solve_large_exact(
        src, dst, large_params(), mesh=pairs, time_limit=EXACT_TIME_LIMIT_S, device=device))))
    del src, dst
    fe_src, fe_dst, *_ = make_frontend_pair(FRONTEND_N)
    fields.update(run("frontend", lambda: mesh_frontend(device, fe_src, fe_dst, blocks, pairs)))
    b_src, b_dst = make_problems(BATCH, N_POINTS)
    fields.update(_fields("batch", run("batch", lambda: solve_batch_sharded(
        b_src, b_dst, bench_params(), batch, device=device))))
    out = pathlib.Path(out_dir)
    np.savez(out / f"rank{rank}.npz", **fields)
    (out / f"rank{rank}.json").write_text(json.dumps(launches))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
    sys.exit(0)


pytestmark = pytest.mark.chip


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def refs(cuda_card):
    """The ``mesh=None`` runs on this card: (a) and (b) as the ranks run
    them, ``solve_batch`` of each half of the batch and of the whole."""
    from teaserpp_tpu_torch import solve_batch, solve_large_exact, solve_large_sharded
    from teaserpp_tpu_torch.convert import solution_to_numpy

    src, dst, r_true, t_true, inlier = make_large_problem(LARGE_N)
    s, d = to_device(cuda_card, src, dst)
    fields = {**_fields("large", solve_large_sharded(s, d, large_params(), device=cuda_card)),
              **_fields("exact", solve_large_exact(s, d, large_params(),
                                                   time_limit=EXACT_TIME_LIMIT_S,
                                                   device=cuda_card))}
    del s, d
    fe_src, fe_dst, fe_r, fe_t = make_frontend_pair(FRONTEND_N)
    fields.update(mesh_frontend(cuda_card, fe_src, fe_dst))
    b_src, b_dst = make_problems(BATCH, N_POINTS)
    half = BATCH // WORLD
    halves = [_fields("batch", solve_batch(b_src[i * half:(i + 1) * half],
                                           b_dst[i * half:(i + 1) * half], bench_params(),
                                           device=cuda_card)) for i in range(WORLD)]
    whole = solution_to_numpy(solve_batch(b_src, b_dst, bench_params(), device=cuda_card))
    return dict(fields=fields, halves=halves, whole=whole,
                truth=(r_true, t_true, inlier, fe_r, fe_t))


@pytest.fixture(scope="module")
def ranks(refs, cuda_card, tmp_path_factory):
    """Both ranks' (fields, launches); a world that outlives ``WAIT_S`` is
    killed."""
    torch.cuda.empty_cache()  # the ranks share this card
    out = tmp_path_factory.mktemp("mesh_world")
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), address, str(out), "cuda:0"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        logs = [proc.communicate(timeout=WAIT_S) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, (proc, (_, err)) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {r} (rc {proc.returncode}): {err[-3000:]}"
    results = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            results.append(({k: z[k] for k in z.files},
                            json.loads((out / f"rank{r}.json").read_text())))
    return results


def _differing(got: dict, want: dict, keys) -> list:
    """The keys whose arrays differ in dtype, shape or any bit."""
    return [k for k in keys if got[k].dtype != want[k].dtype or got[k].shape != want[k].shape
            or got[k].tobytes() != want[k].tobytes()]


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_equals_mesh_none(rank, ranks, refs):
    """(a) and (b) bit for bit; (c) each half bit for bit ``solve_batch`` of
    that half, the whole within the parity tolerance of the whole batch's
    solve, with equal masks."""
    got, _ = ranks[rank]
    want = refs["fields"]
    differ = _differing(got, want, [k for k in want if not k.startswith("batch")])
    half = BATCH // WORLD
    for h, own in enumerate(refs["halves"]):
        differ += [f"{k}[half {h}]" for k in own
                   if got[k][h * half:(h + 1) * half].tobytes() != own[k].tobytes()]
    assert not differ, differ[:12]
    whole = refs["whole"]
    assert np.array_equal(got["batch.clique_mask"], whole.clique_mask)
    assert np.linalg.norm(got["batch.rotation"] - whole.rotation, axis=(1, 2)).max() <= PARITY_TOL
    assert np.linalg.norm(got["batch.translation"] - whole.translation, axis=1).max() <= PARITY_TOL


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_launches(rank, ranks):
    """(a): K1's slab once in the heuristic solve, twice in the exact one
    (its heuristic bound and its prune), whose host search on the first rank
    takes its subgraph's words from K1, and the greedy once in each; (b):
    the greedy and each cloud's plans on the card (5 launches a cloud, on
    every rank); (c): K1 on the rank's half of the batch. Every rank solves
    each rotation with kernel R: once in (a)'s heuristic solve, twice in the
    exact one (its bound's and the exact clique's), once in (b) and (c)."""
    assert ranks[rank][1] == {
        "large": launched(trim_bits_slab=1, greedy_clique=1, gnc_tls=1),
        "exact": launched(trim_bits_slab=2, trim_bits=int(rank == 0), greedy_clique=1,
                          gnc_tls=2),
        "frontend": launched(greedy_clique=1, gnc_tls=1, neighbor_plans=10),
        "batch": launched(trim_bits=1, gnc_tls=1),
    }


def test_mesh_results_pass_the_gates(ranks, refs):
    """(a) the huge-N gate, (b) the front end's."""
    got, _ = ranks[0]
    r_true, t_true, inlier, fe_r, fe_t = refs["truth"]
    large_gate("mesh solve_large_sharded", _large_result_view(got, "large"), r_true, t_true,
               inlier)
    large_gate("mesh solve_large_exact", _large_result_view(got, "exact"), r_true, t_true, inlier)
    frontend_gate("mesh synth100k", _large_result_view(got, "frontend"), fe_r, fe_t)


def test_nccl_world_of_one(refs, cuda_card):
    """Joined here (``init_process_group("nccl")``, world size 1): (a) on
    the (1, 1) mesh, whose collectives go through NCCL, equal to
    ``mesh=None`` bit for bit, with nothing staged through the host."""
    import torch.distributed as dist
    from teaserpp_tpu_torch import solve_large_exact, solve_large_sharded
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.parallel import multihost as mh

    src, dst, r_true, t_true, inlier = make_large_problem(LARGE_N)
    s, d = to_device(cuda_card, src, dst)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = mh.make_mesh()
        ck.reset_launches()
        mh.reset_staged_bytes()
        got = {**_fields("large", solve_large_sharded(s, d, large_params(), mesh=mesh,
                                                      device=cuda_card)),
               **_fields("exact", solve_large_exact(s, d, large_params(), mesh=mesh,
                                                    time_limit=EXACT_TIME_LIMIT_S,
                                                    device=cuda_card))}
        torch.cuda.synchronize()
        backend, launches, staged = dist.get_backend(), dict(ck.LAUNCHES), dict(mh.STAGED_BYTES)
    finally:
        dist.destroy_process_group()
    assert backend == "nccl" and not any(staged.values()), staged
    assert not _differing(got, refs["fields"], got)
    assert launches == launched(trim_bits=4, greedy_clique=2, gnc_tls=3)
    large_gate("NCCL solve_large_sharded", _large_result_view(got, "large"), r_true, t_true,
               inlier)


REFUSED_RANK = """
import json, sys
from teaserpp_tpu_torch.parallel import multihost as mh
try:
    mh.initialize_distributed(sys.argv[1], 2, int(sys.argv[2]), timeout_s=60.0)
except RuntimeError as exc:
    sys.exit(0 if "Duplicate GPU" in str(exc) and "gloo" in str(exc) else 1)
sys.exit(1)
"""


def test_nccl_on_the_shared_card_is_refused_by_name(cuda_card):
    """Two ranks that ask ``initialize_distributed`` for its default backend,
    NCCL, on the one card: both raise, naming the shared card and gloo."""
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", REFUSED_RANK, address, str(r)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [proc.communicate(timeout=120) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-2000:]
