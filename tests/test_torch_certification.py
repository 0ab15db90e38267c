"""Port parity for the DRS certifier's building blocks, its DENSE loop,
``certify_batch`` and ``ops/linalg.py``: the port's functions against the JAX
package's (float64, x64 as ``conftest.py`` sets it) on the same seeded
inputs, and the Cholesky failure predicate at each of its four sites.

Tolerances: the building blocks are a few float64 roundings apart, so
1e-12 absolute (entries are O(1)-O(100)). DENSE runs the same fixed-point
iteration with another eigensolver's roundings, which the iteration carries
along: equal iteration counts, and each trajectory entry within 1e-6
relative of JAX's (a 1e-14 start grows to ~2e-8 over ~130 iterations here)
plus 1e-8 absolute, the rounding of a gap near 0 (lambda_min's float64
rounding, ~1e-13, times (N+1) / mu, up to ~1e5 on the noise-free instances).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.certification import drs as jdrs
from teaserpp_tpu.ops import linalg as jlinalg
from teaserpp_tpu.params import DRSCertifierParams as JParams
from teaserpp_tpu.params import EigSolverType as JEig
from teaserpp_tpu.solvers.rotation import solve_rotation_gnc_tls as j_gnc
from teaserpp_tpu_torch.certification import drs
from teaserpp_tpu_torch.certification.drs import DRSCertifier, certify_batch
from teaserpp_tpu_torch.ops import linalg
from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType
from teaserpp_tpu_torch.solvers.rotation import solve_rotation_gnc_tls

torch.set_num_threads(1)

BLOCK_TOL = 1e-12
TRAJ_RTOL = 1e-6
TRAJ_ATOL = 1e-8
NB = 0.03
T64 = dict(dtype=torch.float64)


def make_gnc_problem(rng, n, nb=NB, n_out=None):
    """A rotation problem with noisy inliers and n_out outliers, solved by the
    port's float64 GNC-TLS -> (R, v1, v2, theta) as numpy."""
    v1 = rng.standard_normal((3, n))
    r0, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(r0) < 0:
        r0[:, 0] *= -1
    v2 = r0 @ v1 + rng.standard_normal((3, n)) * (nb / 4)
    n_out = n // 4 if n_out is None else n_out
    out_idx = rng.choice(n, n_out, replace=False)
    v2[:, out_idx] = rng.standard_normal((3, n_out)) * 2
    rot = solve_rotation_gnc_tls(torch.as_tensor(v1)[None], torch.as_tensor(v2)[None], nb)
    theta = np.where(rot.inliers[0].numpy(), 1.0, -1.0)
    return rot.rotation[0].numpy(), v1, v2, theta


def reference_style_instance(rng, n, outlier_ratio=0.1):
    """certification-test.cc:544-562's generation (noise-free inliers, the
    trailing 10% outliers) -> (R, v1, v2, theta)."""
    v1 = rng.uniform(-1, 1, (3, n))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    v2 = q @ v1
    k = int(n * (1 - outlier_ratio))
    theta = np.ones(n)
    theta[k:] = -1
    v2[:, k:] = rng.uniform(-1, 1, (3, n - k)) * 5 + 5
    return q, v1, v2, theta


@pytest.fixture(scope="module")
def problems():
    """Noisy GNC-style problems at N=12 and N=30 with a few outliers, solved
    by JAX's GNC-TLS (so both packages see the same R and theta)."""
    rng = np.random.default_rng(2024)
    out = {}
    for n, n_out in ((12, 2), (30, 6)):
        v1 = rng.standard_normal((3, n))
        r0, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(r0) < 0:
            r0[:, 0] *= -1
        v2 = r0 @ v1 + rng.standard_normal((3, n)) * (NB / 4)
        idx = rng.choice(n, n_out, replace=False)
        v2[:, idx] = rng.standard_normal((3, n_out)) * 2
        rot = j_gnc(jnp.asarray(v1), jnp.asarray(v2), NB)
        theta = np.where(np.asarray(rot.inliers), 1.0, -1.0)
        out[n] = (np.asarray(rot.rotation), v1, v2, theta, rng.standard_normal((4 * n + 4,) * 2))
    return out


def _t(a):
    return torch.as_tensor(np.array(a))


def _diff(want, got) -> float:
    return float(np.abs(np.asarray(want) - got.numpy()).max())


def test_hatmap_and_vector_kron_match_jax(rng):
    u, v = rng.standard_normal(3), rng.standard_normal(5)
    assert _diff(jlinalg.hatmap(jnp.asarray(u)), linalg.hatmap(_t(u))) < 1e-12
    assert np.allclose(linalg.hatmap(_t(u)).numpy() @ v[:3], np.cross(u, v[:3]), atol=1e-12)
    cols = rng.standard_normal((2, 3, 7))
    want = np.stack([[np.asarray(jlinalg.hatmap(jnp.asarray(c[:, k]))) for k in range(7)]
                     for c in cols])
    assert _diff(want, linalg.hatmap_columns(_t(cols))) < 1e-12
    assert _diff(jlinalg.vector_kron(jnp.asarray(u), jnp.asarray(v)),
                 linalg.vector_kron(_t(u), _t(v))) < 1e-12


def test_get_nearest_psd_batched_matches_jax(rng):
    a = rng.standard_normal((3, 2, 20, 20))
    got = linalg.get_nearest_psd(_t(a))
    assert got.shape == a.shape
    assert _diff(jlinalg.get_nearest_psd(jnp.asarray(a)), got) < 1e-12
    assert float(torch.linalg.eigvalsh(got).min()) > -1e-12


@pytest.fixture(scope="module")
def jax_blocks(problems):
    """Every building block of JAX on each problem, each function jitted once."""
    quat = jax.jit(jdrs.quat_from_rotation)
    omega = jax.jit(jdrs.get_omega_1)
    bdo = jax.jit(jdrs.get_block_diag_omega, static_argnums=0)
    qcost = jax.jit(jdrs.get_q_cost)
    lam = jax.jit(jdrs.get_lambda_guess)
    ainv = jax.jit(jdrs.apply_inverse_map)
    dual = jax.jit(jdrs.optimal_dual_projection)
    out = {}
    for n, (r, v1, v2, theta, w) in problems.items():
        thp = jnp.asarray(np.concatenate([[1.0], theta]))
        i_idx, j_idx = (jnp.asarray(a) for a in np.triu_indices(n + 1, k=1))
        q = quat(jnp.asarray(r))
        b = np.random.default_rng(n).standard_normal((len(i_idx), 3))
        out[n] = {k: np.asarray(v) for k, v in dict(
            quat_from_rotation=q,
            get_omega_1=omega(q),
            get_block_diag_omega=bdo(4 * n + 4, q),
            get_q_cost=qcost(jnp.asarray(v1), jnp.asarray(v2), NB, 1.0),
            get_lambda_guess=lam(*map(jnp.asarray, (r, theta, v1, v2)), NB, 1.0),
            apply_inverse_map=ainv(thp, jnp.asarray(b), i_idx, j_idx),
            optimal_dual_projection=dual(jnp.asarray(w), thp, i_idx, j_idx),
        ).items()}
    return out


def _port_block(name, q_jax, r, v1, v2, theta, w):
    """The port's block on the problem; omega blocks take JAX's quaternion, so
    that they test the block alone."""
    n = v1.shape[1]
    thp = _t(np.concatenate([[1.0], theta]))
    i_idx, j_idx = drs._pair_indices(n + 1, "cpu")
    if name == "quat_from_rotation":
        return drs.quat_from_rotation(_t(r))
    if name == "get_omega_1":
        return drs.get_omega_1(_t(q_jax))
    if name == "get_block_diag_omega":
        return drs.get_block_diag_omega(4 * n + 4, _t(q_jax))
    if name == "get_q_cost":
        return drs.get_q_cost(_t(v1), _t(v2), NB, 1.0)
    if name == "get_lambda_guess":
        return drs.get_lambda_guess(*map(_t, (r, theta, v1, v2)), NB, 1.0)
    if name == "apply_inverse_map":
        b = np.random.default_rng(n).standard_normal((len(i_idx), 3))
        return drs.apply_inverse_map(thp, _t(b), i_idx, j_idx)
    return drs.optimal_dual_projection(_t(w), thp, i_idx, j_idx)


BLOCKS = ["quat_from_rotation", "get_omega_1", "get_block_diag_omega", "get_q_cost",
          "get_lambda_guess", "apply_inverse_map", "optimal_dual_projection"]


@pytest.mark.parametrize("n", [12, 30])
@pytest.mark.parametrize("name", BLOCKS)
def test_building_block_matches_jax(problems, jax_blocks, name, n):
    want = jax_blocks[n][name]
    got = _port_block(name, jax_blocks[n]["quat_from_rotation"], *problems[n])
    if name == "quat_from_rotation" and float(np.dot(want, got.numpy())) < 0:
        got = -got  # the quaternion's sign is arbitrary
    assert got.shape == want.shape and got.dtype == torch.float64
    assert _diff(want, got) < BLOCK_TOL


def test_building_blocks_batch_over_leading_dims(problems):
    """Each block over a leading batch dim equals its unbatched value."""
    r12, v1, v2, th, w = problems[30]
    stack = lambda a: _t(np.stack([a, a]))  # noqa: E731
    got = drs.get_lambda_guess(stack(r12), stack(th), stack(v1), stack(v2), NB)
    assert _diff(got[1], drs.get_lambda_guess(_t(r12), _t(th), _t(v1), _t(v2), NB)) < BLOCK_TOL
    i_idx, j_idx = drs._pair_indices(31, "cpu")
    thp = np.concatenate([[1.0], th])
    got = drs.optimal_dual_projection(stack(w), stack(thp), i_idx, j_idx)
    assert _diff(got[0], drs.optimal_dual_projection(_t(w), _t(thp), i_idx, j_idx)) < BLOCK_TOL


@pytest.mark.parametrize("n", [12, 30])
@pytest.mark.parametrize("solver", [EigSolverType.DENSE, EigSolverType.ITERATIVE],
                         ids=["dense", "iterative"])
def test_suboptimality_gap_matches_jax(problems, solver, n):
    """DENSE equals JAX's; ITERATIVE is a proven bound: never below the true
    gap (lambda_min from a dense eigvalsh), and within 1e-6 of JAX's (the
    two Lanczos starts differ, and the bound sits 1e-8 relative below the
    estimate)."""
    w = problems[n][4]
    sym = (w + w.T) / 2
    mu = 0.37
    gap = jax.jit(jdrs.suboptimality_gap, static_argnums=(2, 3))
    want = float(gap(jnp.asarray(w), mu, n, JEig(int(solver))))
    got = float(drs.suboptimality_gap(_t(w), torch.tensor(mu, **T64), n, solver))
    true_gap = -np.linalg.eigvalsh(sym)[0] * (n + 1) / mu
    if solver == EigSolverType.DENSE:
        assert abs(got - want) < BLOCK_TOL * abs(want)
    else:
        assert got >= true_gap * (1 - 1e-12)
        assert abs(got - want) < 1e-6 * abs(want)


def test_iterative_gap_proven_zero_on_psd(rng):
    """Mirror of the JAX test: both modes return exactly 0 on a PSD matrix and
    a positive gap on an indefinite one; ITERATIVE >= DENSE, and tight."""
    npm = 60
    a = rng.standard_normal((npm, npm))
    psd = a @ a.T + np.eye(npm)
    mu = torch.tensor(1e-3, **T64)
    n = (npm - 4) // 4
    for solver in (EigSolverType.DENSE, EigSolverType.ITERATIVE):
        assert float(drs.suboptimality_gap(_t(psd), mu, n, solver)) == 0.0
    indef = psd - 3.0 * np.eye(npm)
    g_dense = float(drs.suboptimality_gap(_t(indef), mu, n, EigSolverType.DENSE))
    g_iter = float(drs.suboptimality_gap(_t(indef), mu, n, EigSolverType.ITERATIVE))
    assert g_dense > 0 and g_iter > 0
    assert g_dense * (1 - 1e-9) <= g_iter <= g_dense * 1.01


def _assert_same_run(got, want):
    assert got.is_optimal == want.is_optimal
    assert len(got.suboptimality_traj) == len(want.suboptimality_traj)
    g, w = np.asarray(got.suboptimality_traj), np.asarray(want.suboptimality_traj)
    np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    np.testing.assert_allclose(got.best_suboptimality, want.best_suboptimality,
                               rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


@pytest.mark.parametrize("case", ["reference_style", "noisy_gnc"])
def test_dense_certify_matches_jax(problems, case):
    """DENSE ``DRSCertifier.certify`` against JAX's: the same verdict, the same
    iteration count, the trajectory within TRAJ_RTOL."""
    if case == "reference_style":
        r, v1, v2, th = reference_style_instance(np.random.default_rng(7), 40)
        nb = 0.01
    else:
        r, v1, v2, th, _ = problems[30]
        nb = NB
    want = jdrs.DRSCertifier(JParams(noise_bound=nb)).certify(r, v1, v2, th)
    got = DRSCertifier(DRSCertifierParams(noise_bound=nb), device="cpu").certify(r, v1, v2, th)
    assert got.is_optimal and not got.rank_saturated
    _assert_same_run(got, want)


def test_dense_certify_float32(problems):
    """The working dtype is an argument: float32 runs the same loop on float32
    tensors. Its lambda_min carries float32 rounding, eps32 ||M||, so its gap
    may lie eps32 ||M|| (N+1) / mu (0.034 here) from float64's: each of the
    first 20 entries, O(1)-O(20), within twice that."""
    r, v1, v2, th, _ = problems[30]
    params = DRSCertifierParams(noise_bound=NB, max_iterations=20)
    got = DRSCertifier(params, device="cpu", dtype=torch.float32).certify(r, v1, v2, th)
    want = DRSCertifier(params, device="cpu").certify(r, v1, v2, th)
    assert len(got.suboptimality_traj) == len(want.suboptimality_traj) == 20
    consts = drs._drs_setup(*(_t(a).float()[None] for a in (r, v1, v2, th)), params)
    assert all(c.dtype == torch.float32 for c in consts)
    m64, mu, _ = drs._drs_setup(*(_t(a)[None] for a in (r, v1, v2, th)), params)
    scale = (torch.finfo(torch.float32).eps * float(torch.linalg.matrix_norm(m64[0], 2))
             * 31 / float(mu[0]))
    np.testing.assert_allclose(got.suboptimality_traj, want.suboptimality_traj, rtol=0,
                               atol=2 * scale)


def test_certify_batch_matches_single(rng):
    """Mirror of the JAX test: batched equals per-problem certification, and
    chunks of ``max_device_batch`` give the same numbers in the same order."""
    probs = [make_gnc_problem(rng, 12, 0.06, n_out=2) for _ in range(3)]
    rots, srcs, dsts, thetas = (np.stack(x) for x in zip(*probs))
    params = DRSCertifierParams(noise_bound=0.06)
    batched = certify_batch(rots, srcs, dsts, thetas, params, device="cpu")
    single = DRSCertifier(params, device="cpu")
    for b in range(3):
        one = single.certify(rots[b], srcs[b], dsts[b], thetas[b])
        assert batched[b].is_optimal == one.is_optimal
        assert abs(batched[b].best_suboptimality - one.best_suboptimality) < 1e-9
    chunked = certify_batch(rots, srcs, dsts, thetas, params, max_device_batch=2, device="cpu")
    assert len(chunked) == 3
    for a, b in zip(chunked, batched):
        assert a.is_optimal == b.is_optimal
        assert a.best_suboptimality == b.best_suboptimality


@pytest.mark.parametrize("solver", [EigSolverType.DENSE, EigSolverType.ITERATIVE],
                         ids=["dense", "iterative"])
def test_certify_batch_freezes_finished_lanes(solver):
    """Lanes that stop at different iterations: lane b equals
    ``DRSCertifier.certify`` on problem b alone (equal verdict, equal
    iteration count, the trajectory within TRAJ_RTOL), as under JAX's vmap
    of a while_loop, and equals JAX's DENSE batch lane by lane."""
    rng = np.random.default_rng(5)
    probs = [make_gnc_problem(rng, 16, NB, n_out=k) for k in (0, 3, 5)]
    probs.append(reference_style_instance(rng, 16))
    rots, srcs, dsts, thetas = (np.stack(x) for x in zip(*probs))
    params = DRSCertifierParams(noise_bound=NB, eig_decomposition_solver=solver,
                                iterations_per_dispatch=7)
    batched = certify_batch(rots, srcs, dsts, thetas, params, device="cpu")
    lengths = {len(res.suboptimality_traj) for res in batched}
    assert len(lengths) > 1, "every lane stopped at one iteration: the test is vacuous"
    single = DRSCertifier(params, device="cpu")
    for b, got in enumerate(batched):
        _assert_same_run(got, single.certify(rots[b], srcs[b], dsts[b], thetas[b]))
    if solver == EigSolverType.DENSE:
        want = jdrs.certify_batch(rots, srcs, dsts, thetas, JParams(noise_bound=NB))
        for got, w in zip(batched, want):
            _assert_same_run(got, w)


def test_certify_batch_rank_saturation_recovers():
    """Mirror of the JAX test (there at N=48; N=32 here keeps the file quick,
    and rank 4 still saturates every lane, ~npm/8 = 16 negative eigenvalues):
    ``certify_batch`` re-enters only the saturated problems at a grown rank
    and lands DENSE's verdicts."""
    rng = np.random.default_rng(12345)
    probs = [make_gnc_problem(rng, 32, NB, n_out=8) for _ in range(3)]
    rots, v1s, v2s, thetas = (np.stack(x) for x in zip(*probs))
    starved = DRSCertifierParams(noise_bound=NB, eig_decomposition_solver=EigSolverType.ITERATIVE,
                                 psd_projection_rank=4)
    raw = drs._run_iterative_chunked_batch(*map(_t, (rots, v1s, v2s, thetas)), starved)
    assert bool(raw[3].all())  # every lane saturates at rank 4, or the test is vacuous
    results = certify_batch(rots, v1s, v2s, thetas, starved, device="cpu")
    dense = DRSCertifier(DRSCertifierParams(noise_bound=NB), device="cpu")
    for i, got in enumerate(results):
        ref = dense.certify(rots[i], v1s[i], v2s[i], thetas[i])
        assert got.is_optimal == ref.is_optimal
        assert abs(got.best_suboptimality - ref.best_suboptimality) < 1e-3
        assert got.is_optimal or not got.rank_saturated


# --- the Cholesky failure predicate at its four sites -----------------------

def _with_min_eig(lam_min: float, npm: int = 24, seed: int = 3) -> torch.Tensor:
    """A symmetric matrix whose smallest eigenvalue is exactly ``lam_min``
    (the others in [1, 3])."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((npm, npm)))
    eig = np.concatenate([[lam_min], rng.uniform(1, 3, npm - 1)])
    return _t((q * eig) @ q.T)


def test_cholesky_predicate_flags_nan_and_indefinite():
    ok, failed = drs._cholesky(torch.stack([_with_min_eig(1e-3), _with_min_eig(-1e-3)]))
    assert failed.tolist() == [False, True]
    assert torch.isfinite(ok[0]).all() and torch.isnan(ok[1]).all()
    nan_in = _with_min_eig(1.0)
    nan_in[3, 5] = nan_in[5, 3] = float("nan")
    assert bool(drs._cholesky(nan_in)[1])


@pytest.mark.parametrize("side", ["above", "below"])
def test_proven_bound_brackets_at_the_shift(side):
    """Site 1: the proven bound. With the estimate 1e-6 above lambda_min the
    first attempt fails and the bracket-and-bisect walk must still return a
    sound bound; 1e-6 below, the first attempt succeeds and returns -c0."""
    lam = -0.05
    sym = _with_min_eig(lam)
    est = torch.tensor(lam + (1e-6 if side == "above" else -1e-6), **T64)
    bound = float(drs._proven_lam_min_lb(sym, est))
    assert bound <= lam
    if side == "below":
        g = float(drs._gershgorin(sym))
        assert bound == pytest.approx(float(est) * (1 + 1e-8) - (1e-10 * g + 1e-30), rel=1e-14)
    else:
        assert bound > lam - 1e-9  # 32 bisections of a doubling bracket


@pytest.mark.parametrize("side", ["above", "below"])
def test_shift_walk_at_the_shift(side):
    """Site 2: ``_chol_shifted``. A shift 1e-9 below lambda_min factors at
    once; 1e-9 above it fails and the walk multiplies the shift by 8."""
    lam = -0.2
    sym = _with_min_eig(lam)[None]
    sigma0 = torch.tensor([lam + (1e-9 if side == "above" else -1e-9)], **T64)
    c = drs._chol_shifted(sym, sigma0)
    assert torch.isfinite(c).all()
    sigma = sigma0 * (8.0 if side == "above" else 1.0)
    assert torch.allclose(c @ c.transpose(-1, -2), sym - sigma[:, None, None] * torch.eye(24, **T64),
                          atol=1e-12)


@pytest.mark.parametrize("side", ["above", "below"])
def test_saturation_test_at_the_slack(side):
    """Site 3: the projection's completeness test. A negative eigenvalue the
    rank-1 subspace cannot hold, just beyond the 1e-8 g slack, flags
    saturation; one just inside the slack does not."""
    npm = 24
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.standard_normal((npm, npm)))
    eig = np.concatenate([[-1.0, 0.0], rng.uniform(1, 3, npm - 2)])
    sym = _t((q * eig) @ q.T)
    g = float(drs._gershgorin(sym))
    second = -1e-8 * g * (1.5 if side == "below" else 0.5)
    eig[1] = second
    sym = _t((q * eig) @ q.T)[None]
    v = _t(q[:, :1])[None]  # the rank-1 subspace holds the -1 eigenpair only
    _, _, lam, saturated = drs._si_psd_step(sym, v, torch.tensor([-1.0], **T64), 2)
    assert float(lam[0]) == pytest.approx(-1.0, abs=1e-9)
    assert bool(saturated[0]) == (side == "below")


@pytest.mark.parametrize("side", ["above", "below"])
def test_certificate_gate_at_the_threshold(side):
    """Site 4: the certificate gate. A candidate gap whose lambda_min sits
    just inside the threshold is proven and certifies; just outside it is
    disproven and recorded as +inf."""
    n = 5  # npm 24
    mu = torch.tensor([0.5], **T64)
    thresh = 1e-3 * float(mu) / (n + 1.0)
    lam = -thresh * (0.999 if side == "above" else 1.001)
    sym = _with_min_eig(lam)[None]
    gap, done = drs._certificate_gate(sym, torch.tensor([1e-4], **T64), mu, 1e-3)
    if side == "above":
        assert bool(done[0]) and float(gap[0]) == 1e-4
    else:
        assert not bool(done[0]) and float(gap[0]) == float("inf")
