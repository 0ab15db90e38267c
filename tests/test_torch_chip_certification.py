"""The DRS certifier on the card, in float64: scripts/bench_frontend_e2e.py's
``certify_saved`` flow on the front end's two saved rotation-stage problems
(``.e2e_cert_synth100k.npz``, ``.e2e_cert_scene60k.npz``), scripts/
bench_certify.py's batch against its single runs, the reference's large
random instances (certification-test.cc:530-644), the card against the CPU,
and a checkpointed run stopped and resumed bit for bit. No route of the
certifier launches a kernel of the port.

Marked ``chip``: skips without a CUDA card. No JAX; on a machine with an
H100::

    python -m pytest tests/test_torch_chip_certification.py -m chip --noconftest -p no:cacheprovider
"""

import pathlib

import numpy as np
import pytest
import torch

from chip_support import cuda_card, hash_arrays, launched, run_counted  # noqa: F401 (a fixture)
from teaserpp_tpu_torch.certification import drs
from teaserpp_tpu_torch.certification.drs import DRSCertifier, certify_batch, certify_checkpointed
from teaserpp_tpu_torch.ops import cuda_kernels as ck
from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType

pytestmark = pytest.mark.chip

ROOT = pathlib.Path(__file__).resolve().parent.parent
CERT_TIMS = 150
CERT_SEGMENT = 25
CERT_BATCH = 32
CERT_BATCH_N = 100
CERT_BATCH_NOISE_BOUND = 0.01
CERT_BATCH_ITERATIONS = 100
CERT_TRAJ_RTOL = 1e-6  # tests/test_torch_certification.py's DENSE tolerance
CERT_TRAJ_ATOL = 1e-8
CERT_SCALE_N = 1000  # npm 4004
CERT_SCALE_SMALL_N = 499  # npm 2000
CERT_PARITY_N = 40
CERT_PARITY_NOISE_BOUND = 0.03


def _gnc(device, v1, v2, nb):
    """The port's float64 GNC-TLS on one problem -> (R, inliers) on the host."""
    from teaserpp_tpu_torch.solvers.rotation import solve_rotation_gnc_tls

    a, b = (torch.as_tensor(x, dtype=torch.float64, device=device)[None] for x in (v1, v2))
    res = solve_rotation_gnc_tls(a, b, nb)
    return res.rotation[0].cpu().numpy(), res.inliers[0].cpu().numpy()


def cert_subset(device, name: str) -> dict:
    """``certify_saved``'s problem: GNC over the saved chain, every TLS
    outlier and evenly spaced inliers up to 150 TIMs, GNC again on the
    subset."""
    with np.load(ROOT / f".e2e_cert_{name}.npz") as z:
        v1f, v2f, nb = z["v1"], z["v2"], float(z["nb_rot"])
    _, th_full = _gnc(device, v1f, v2f, nb)
    out_idx, in_idx = np.nonzero(~th_full)[0], np.nonzero(th_full)[0]
    keep_out = out_idx[: CERT_TIMS // 2]
    n_in = min(CERT_TIMS - len(keep_out), len(in_idx))
    keep_in = in_idx[np.linspace(0, len(in_idx) - 1, n_in).astype(int)]
    sel = np.sort(np.concatenate([keep_in, keep_out]))
    r, inl = _gnc(device, v1f[:, sel], v2f[:, sel], nb)
    return dict(v1=v1f[:, sel], v2=v2f[:, sel], rotation=r, theta=np.where(inl, 1.0, -1.0),
                noise_bound=nb)


@pytest.mark.parametrize("name,subset_outliers", [("synth100k", 0), ("scene60k", 10)])
def test_certify_saved_problem(name, subset_outliers, cuda_card, tmp_path):
    """ITERATIVE, rank 128, 25-iteration segments, 20 rounds of 200, the
    checkpoint in a temporary directory: certified, synth100k with gap 0,
    scene60k with gap < 1e-3. The subset's two GNC-TLS solves are kernel
    R's launches; the certifier launches nothing."""
    ck.reset_launches()
    sub = cert_subset(cuda_card, name)
    params = DRSCertifierParams(noise_bound=sub["noise_bound"],
                                eig_decomposition_solver=EigSolverType.ITERATIVE,
                                iterations_per_dispatch=CERT_SEGMENT, psd_projection_rank=128,
                                max_iterations=200)
    res = certify_checkpointed(sub["rotation"], sub["v1"], sub["v2"], sub["theta"], params,
                               checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2,
                               rounds=20, device=cuda_card)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == launched(gnc_tls=2)
    assert int((sub["theta"] < 0).sum()) == subset_outliers
    assert res.is_optimal, res.best_suboptimality
    if name == "synth100k":
        assert res.best_suboptimality == 0.0
    else:
        assert res.best_suboptimality < 1e-3


def cert_batch_problems(b: int, n: int, seed: int = 0):
    """scripts/bench_certify.py's problems: known rotations, uniform noise
    within the bound, 20% outliers with their theta -1."""
    nb = CERT_BATCH_NOISE_BOUND
    rng = np.random.default_rng(seed)
    rots, srcs, dsts, thetas = [], [], [], []
    for _ in range(b):
        q, r_ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.diag(r_))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        src = rng.uniform(-1, 1, size=(3, n))
        dst = q @ src + rng.uniform(-nb / 2, nb / 2, size=(3, n))
        theta = np.ones(n)
        out = rng.choice(n, size=n // 5, replace=False)
        dst[:, out] = rng.uniform(-2, 2, size=(3, n // 5))
        theta[out] = -1
        rots.append(q)
        srcs.append(src)
        dsts.append(dst)
        thetas.append(theta)
    return tuple(np.stack(x) for x in (rots, srcs, dsts, thetas))


def same_run(got, want) -> bool:
    """Equal verdict and iteration count, trajectories within the tests'
    DENSE tolerance."""
    return (got.is_optimal == want.is_optimal
            and len(got.suboptimality_traj) == len(want.suboptimality_traj)
            and np.allclose(got.suboptimality_traj, want.suboptimality_traj,
                            rtol=CERT_TRAJ_RTOL, atol=CERT_TRAJ_ATOL))


def test_certify_batch_equals_its_single_runs(cuda_card):
    """B=32, N=100, DENSE, 100 iterations: each lane equal to
    ``DRSCertifier.certify`` of its problem alone."""
    probs = cert_batch_problems(CERT_BATCH, CERT_BATCH_N)
    params = DRSCertifierParams(noise_bound=CERT_BATCH_NOISE_BOUND,
                                max_iterations=CERT_BATCH_ITERATIONS)
    res, launches = run_counted(lambda: certify_batch(*probs, params, device=cuda_card))
    assert launches == launched()
    single = DRSCertifier(params, device=cuda_card)
    differ = [b for b in range(CERT_BATCH)
              if not same_run(res[b], single.certify(*(p[b] for p in probs)))]
    assert not differ


@pytest.mark.parametrize("n,solver,rank", [
    (CERT_SCALE_N, EigSolverType.ITERATIVE, 128),
    (CERT_SCALE_SMALL_N, EigSolverType.ITERATIVE, 96),
    (CERT_SCALE_SMALL_N, EigSolverType.DENSE, 0),
], ids=["iterative_npm4004", "iterative_npm2000", "dense_npm2000"])
def test_certify_reference_instance(n, solver, rank, cuda_card):
    """tests/test_certification_scale.py::reference_style_instance
    (certification-test.cc:544-562: noise-free inliers, trailing outliers)
    and the reference's gate: certified with gap <= 1e-5, not saturated;
    at N=499 ITERATIVE in at most 5 iterations."""
    rng = np.random.default_rng(12345)
    v1 = rng.uniform(-1, 1, (3, n))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    v2 = q @ v1
    k = int(n * 0.9)
    theta = np.ones(n)
    theta[k:] = -1
    v2[:, k:] = rng.uniform(-1, 1, (3, n - k)) * 5 + 5
    params = DRSCertifierParams(noise_bound=0.01, eig_decomposition_solver=solver,
                                psd_projection_rank=rank)
    res, launches = run_counted(lambda: DRSCertifier(params, device=cuda_card).certify(
        q, v1, v2, theta))
    assert res.is_optimal and res.best_suboptimality <= 1e-5 and not res.rank_saturated
    assert n != CERT_SCALE_SMALL_N or len(res.suboptimality_traj) <= 5
    assert launches == launched()


@pytest.fixture(scope="module")
def parity_problem(cuda_card):
    """A noisy problem (sd nb/4, a quarter outliers) solved by the port's
    float64 GNC-TLS on the CPU -> (R, v1, v2, theta)."""
    nb, n = CERT_PARITY_NOISE_BOUND, CERT_PARITY_N
    rng = np.random.default_rng(40)
    v1 = rng.standard_normal((3, n))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    v2 = q @ v1 + rng.standard_normal((3, n)) * (nb / 4)
    idx = rng.choice(n, n // 4, replace=False)
    v2[:, idx] = rng.standard_normal((3, n // 4)) * 2
    r, inl = _gnc(torch.device("cpu"), v1, v2, nb)
    return r, v1, v2, np.where(inl, 1.0, -1.0)


@pytest.mark.parametrize("solver", [EigSolverType.DENSE, EigSolverType.ITERATIVE],
                         ids=["dense", "iterative"])
def test_certify_on_the_card_and_the_cpu(solver, parity_problem, cuda_card):
    """DENSE: the same run on both. ITERATIVE: the seed blocks are equal, but
    the initial Lanczos estimate (no reorthogonalization, as in JAX) moves
    by a few percent under a 1e-15 change of its input, and the shift it
    sets carries that through the run; so whole runs are held to an equal
    verdict and iteration count, and the loop itself (the next test) from
    one state."""
    params = DRSCertifierParams(noise_bound=CERT_PARITY_NOISE_BOUND,
                                eig_decomposition_solver=solver)
    card, launches = run_counted(lambda: DRSCertifier(params, device=cuda_card).certify(
        *parity_problem))
    cpu = DRSCertifier(params, device="cpu").certify(*parity_problem)
    if solver == EigSolverType.DENSE:
        assert same_run(card, cpu)
    else:
        assert card.is_optimal == cpu.is_optimal
        assert len(card.suboptimality_traj) == len(cpu.suboptimality_traj)
    assert launches == launched()


def test_iterative_loop_from_one_state_on_the_card_and_the_cpu(parity_problem, cuda_card):
    """The CPU's ITERATIVE init carried to the card: the same iterations and
    trajectory within the DENSE tolerance."""
    from teaserpp_tpu_torch.convert import drs_state_from_numpy, drs_state_to_numpy

    params = DRSCertifierParams(noise_bound=CERT_PARITY_NOISE_BOUND,
                                eig_decomposition_solver=EigSolverType.ITERATIVE)
    state, consts = drs._iterative_init_batch(
        *(torch.as_tensor(a, dtype=torch.float64)[None] for a in parity_problem), params)
    s_card, c_card = drs_state_from_numpy(
        *drs_state_to_numpy(drs._lane(state), drs._lane(consts)), cuda_card, torch.float64)
    card_end = drs._iterative_segment_batch(drs._batched(s_card), drs._batched(c_card), params,
                                            params.max_iterations)
    cpu_end = drs._iterative_segment_batch(state, consts, params, params.max_iterations)
    it_card, it_cpu = int(card_end[0][0]), int(cpu_end[0][0])
    assert it_card == it_cpu
    assert np.allclose(card_end[3][0, :it_card].cpu().numpy(), cpu_end[3][0, :it_cpu].numpy(),
                       rtol=CERT_TRAJ_RTOL, atol=CERT_TRAJ_ATOL)


def test_checkpointed_run_resumes_bit_for_bit(parity_problem, cuda_card, tmp_path):
    """Stopped after 2 segments of 7 and resumed on the card: the
    trajectory and the best gap hash as the uninterrupted run's."""
    params = DRSCertifierParams(noise_bound=CERT_PARITY_NOISE_BOUND,
                                eig_decomposition_solver=EigSolverType.ITERATIVE,
                                iterations_per_dispatch=7)

    def digest(res):
        return hash_arrays(np.asarray(res.suboptimality_traj, np.float64),
                           np.asarray(res.best_suboptimality, np.float64))

    ckpt = str(tmp_path / "ck.npz")
    (whole, stopped, resumed), launches = run_counted(lambda: (
        certify_checkpointed(*parity_problem, params, device=cuda_card),
        certify_checkpointed(*parity_problem, params, checkpoint_path=ckpt, checkpoint_every=1,
                             _stop_after_segments=2, device=cuda_card),
        certify_checkpointed(*parity_problem, params, checkpoint_path=ckpt, checkpoint_every=1,
                             device=cuda_card)))
    assert launches == launched()
    assert stopped is None and len(whole.suboptimality_traj) > 2 * 7
    assert digest(whole) == digest(resumed)
