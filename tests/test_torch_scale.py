"""Port parity for the unknown-scale stages: TIMs and their norms, the pair
adjacency, the SO(2) Procrustes and the diameter, the weighted scalar TLS,
the scale solvers, Quatro and FGR, the scale stage and the COMPLETE
rotation stage, each against the JAX package's function on the same float32
arrays (small sizes, one padded problem). The batched unknown-scale solve as
a whole is held in ``test_torch_pipeline.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.clique.graph import adjacency_from_pair_mask as j_adjacency
from teaserpp_tpu.ops import procrustes as jproc
from teaserpp_tpu.ops import tims as jtims
from teaserpp_tpu.ops.tls import scalar_tls as j_scalar_tls
from teaserpp_tpu.params import RobustRegistrationSolverParams as JParams
from teaserpp_tpu.params import RotationEstimationAlgorithm as JAlg
from teaserpp_tpu.solvers import pipeline as jpipe
from teaserpp_tpu.solvers import rotation as jrot
from teaserpp_tpu.solvers import scale as jscale
from teaserpp_tpu_torch.clique.graph import adjacency_from_pair_mask
from teaserpp_tpu_torch.convert import params_from_jax, solution_to_numpy
from teaserpp_tpu_torch.ops import procrustes, tims
from teaserpp_tpu_torch.ops.tls import scalar_tls
from teaserpp_tpu_torch.parallel.batch import pad_problems
from teaserpp_tpu_torch.solvers import pipeline, rotation, scale

from conftest import random_rotation

torch.set_num_threads(1)

F32_EPS = float(np.finfo(np.float32).eps)


def _jit(fn, **static):
    """A JAX reference compiled once (eager dispatch compiles every op)."""
    return jax.jit(lambda *a: fn(*a, **static))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scaled_problem(rng, n, s, outlier_frac=0.6, nb=0.01):
    """scripts/bench_scale_est.py's recipe: cloud in [-1, 1]^3, dst = s R src
    + t, uniform noise +-nb/2, outliers uniform in [-4, 4]^3."""
    src = rng.uniform(-1, 1, (3, n))
    r = random_rotation(rng)
    t = rng.normal(size=3) * 0.5
    dst = s * r @ src + t[:, None] + rng.uniform(-nb / 2, nb / 2, (3, n))
    out = rng.choice(n, size=int(outlier_frac * n), replace=False)
    dst[:, out] = rng.uniform(-4, 4, (3, out.size))
    return src, dst, r, t


@pytest.fixture(scope="module")
def batch():
    """Three scaled problems, the last padded from 90 to 120 points."""
    rng = np.random.default_rng(11)
    probs = [_scaled_problem(rng, n, s) for n, s in ((120, 1.4), (120, 0.7), (90, 1.9))]
    src, dst, valid = pad_problems([p[0] for p in probs], [p[1] for p in probs],
                                   multiple=40)
    return (src.astype(np.float32), dst.astype(np.float32), valid,
            np.array([1.4, 0.7, 1.9]), [p[2] for p in probs], [p[3] for p in probs])


def test_upper_tri_indices_compute_tims_and_pair_valid_match_jax(batch):
    src, _, valid, *_ = batch
    n = src.shape[-1]
    for a, b in zip(tims.upper_tri_indices(n), jtims.upper_tri_indices(n)):
        np.testing.assert_array_equal(a, b)
    # subtraction of the same two floats: equal bit for bit
    np.testing.assert_array_equal(tims.compute_tims(_t(src)).numpy(),
                                  np.asarray(jtims.compute_tims(jnp.asarray(src))))
    np.testing.assert_array_equal(tims.tim_pair_valid(_t(valid), n).numpy(),
                                  np.asarray(jtims.tim_pair_valid(jnp.asarray(valid), n)))
    assert tims.tim_pair_valid(None, n) is None


@pytest.mark.parametrize("use_matmul", [False, True])
def test_compute_tim_norms_matches_jax(batch, use_matmul):
    src, *_ = batch
    got = tims.compute_tim_norms(_t(src), use_matmul=use_matmul).numpy()
    want = np.asarray(jtims.compute_tim_norms(jnp.asarray(src), use_matmul=use_matmul))
    assert got.shape == want.shape == (3, 120 * 119 // 2)
    if not use_matmul:
        # the same three squares, summed by XLA in an order of its choosing:
        # a few ulps of the norm
        np.testing.assert_allclose(got, want, rtol=4 * F32_EPS, atol=0)
    else:
        # the Gram form cancels: d^2 = |vi|^2 + |vj|^2 - 2 vi.vj carries a few
        # ulps of max |v|^2 (= 3 here) whatever the product order, and the
        # root turns an absolute error e of d^2 into at most sqrt(e)
        np.testing.assert_allclose(got, want, rtol=0, atol=np.sqrt(16 * 3 * F32_EPS))
        np.testing.assert_allclose(got**2, want**2, rtol=0, atol=16 * 3 * F32_EPS)


def test_adjacency_from_pair_mask_matches_jax():
    rng = np.random.default_rng(3)
    n = 45
    masks = rng.random((2, n * (n - 1) // 2)) < 0.3
    got = adjacency_from_pair_mask(_t(masks), n).numpy()
    assert got.shape == (2, n, n)
    for p in range(2):
        np.testing.assert_array_equal(got[p], np.asarray(j_adjacency(jnp.asarray(masks[p]), n)))


def test_svd_rot_2d_and_calculate_diameter_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 2, 50)).astype(np.float32)
    theta = np.array([0.3, -2.0, 1.0])
    rot = np.stack([[[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]] for a in theta])
    y = (rot @ x + rng.normal(scale=0.01, size=x.shape)).astype(np.float32)
    w = rng.random((3, 50)).astype(np.float32)
    w[2] = 0  # a zero correlation is degenerate: the identity
    got = procrustes.svd_rot_2d(_t(x), _t(y), _t(w)).numpy()
    want = np.asarray(jproc.svd_rot_2d(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    # a 2x2 correlation of 50 products in another summation order
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[2], np.eye(2))
    np.testing.assert_allclose(got[0], rot[0], atol=1e-2)

    got_d = procrustes.calculate_diameter(_t(x)).numpy()
    want_d = np.asarray(jproc.calculate_diameter(jnp.asarray(x)))
    np.testing.assert_allclose(got_d, want_d, rtol=8 * F32_EPS)


def test_scalar_tls_matches_jax_tie_free():
    """Per-measurement ranges, a padded row, float32; distinct endpoints, so
    the sort order is the same whatever its stability."""
    rng = np.random.default_rng(7)
    bsz, n = 3, 200
    x = np.concatenate([rng.normal(1.3, 0.002, (bsz, 80)),
                        rng.uniform(0, 5, (bsz, n - 80))], axis=1).astype(np.float32)
    ranges = rng.uniform(0.002, 0.05, (bsz, n)).astype(np.float32)
    valid = np.ones((bsz, n), bool)
    valid[2, 150:] = False
    ends = np.concatenate([x - ranges, x + ranges], axis=1)
    assert all(len(np.unique(e)) == e.size for e in ends)

    got = scalar_tls(_t(x), _t(ranges), _t(valid))
    want = _jit(j_scalar_tls)(jnp.asarray(x), jnp.asarray(ranges), jnp.asarray(valid))
    # float32 prefix sums in another order (XLA's scan against torch's):
    # the same event wins, and the estimate and cost differ by rounding
    np.testing.assert_allclose(got.estimate.numpy(), np.asarray(want.estimate), rtol=1e-5)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert not got.inliers.numpy()[2, 150:].any()
    np.testing.assert_allclose(got.estimate.numpy(), 1.3, atol=2e-3)


def _tls_sweep_float64(x, ranges):
    """The sweep of reference registration.cc:58-75 in float64, events in
    stable order (every open before every close of one position, as a stable
    sort of [opens, closes] gives), sequential sums: (estimate, cost)."""
    n = x.size
    pos = np.concatenate([x - ranges, x + ranges])
    order = np.argsort(pos, kind="stable")
    w = 1.0 / ranges**2
    card = sw = sxw = sx = sx2 = 0.0
    pen = float(ranges.sum())
    best = (np.inf, np.nan)
    for e in order:
        i, sign = e % n, (1.0 if e < n else -1.0)
        card += sign
        sw += sign * w[i]
        sxw += sign * w[i] * x[i]
        sx += sign * x[i]
        sx2 += sign * x[i] * x[i]
        pen -= sign * ranges[i]
        if card > 0.5:
            x_hat = sxw / sw
            cost = card * x_hat * x_hat + sx2 - 2.0 * sx * x_hat + pen
            if cost < best[0]:
                best = (cost, x_hat)
    return best[1], best[0]


def test_scalar_tls_with_ties_against_float64_sweep():
    """Duplicated measurements and endpoints that coincide exactly (an open
    on a close, in binary fractions): the port's stable order against a
    float64 sweep in the same order."""
    x = np.array([1.0, 1.0, 1.25, 1.5, 1.5, 1.5, 2.0, 2.25, 3.0, 1.125])
    ranges = np.array([0.25, 0.25, 0.125, 0.25, 0.25, 0.25, 0.25, 0.5, 0.25, 0.125])
    ends = np.concatenate([x - ranges, x + ranges])
    assert len(np.unique(ends)) < ends.size  # ties, opens on closes among them
    assert set(x - ranges) & set(x + ranges)
    got = scalar_tls(_t(x[None]), _t(ranges[None]))
    est, cost = _tls_sweep_float64(x, ranges)
    # float64 sums of ten exact binary fractions: equal to rounding
    np.testing.assert_allclose(got.cost.numpy()[0], cost, rtol=1e-12)
    np.testing.assert_allclose(got.estimate.numpy()[0], est, rtol=1e-12)
    np.testing.assert_array_equal(got.inliers.numpy()[0], np.abs(x - est) <= ranges)


@pytest.mark.parametrize("estimate_scaling", [True, False])
def test_scale_solvers_and_scale_stage_match_jax(batch, estimate_scaling):
    src, dst, valid, s_true, *_ = batch
    src = src.copy()
    src[0, :, 7] = src[0, :, 3]  # coincident source points: a pair of norm 0
    dst_in = dst if estimate_scaling else dst / s_true[:, None, None].astype(np.float32)
    n = src.shape[-1]
    jp = JParams(noise_bound=0.01, estimate_scaling=estimate_scaling)
    got = pipeline.scale_stage(_t(src), _t(dst_in), params_from_jax(jp), valid=_t(valid))
    want = _jit(jax.vmap(lambda s, d, v: jpipe.scale_stage(s, d, jp, valid=v)))(
        jnp.asarray(src), jnp.asarray(dst_in), jnp.asarray(valid))
    # the norms agree to a few ulps (above), so a pair's decision can differ
    # only within a few ulps of its threshold: none does on these inputs
    np.testing.assert_array_equal(got.pair_mask.numpy(), np.asarray(want.pair_mask))
    # float32 TLS over K = 7,140 weighted events, summed in another order
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-5)

    # the solvers on their own, one problem
    sn = tims.compute_tim_norms(_t(src[0]))
    dn = tims.compute_tim_norms(_t(dst_in[0]))
    solve, jsolve = ((scale.solve_scale_tls, jscale.solve_scale_tls) if estimate_scaling
                     else (scale.select_scale_inliers, jscale.select_scale_inliers))
    res = solve(sn, dn, 0.01)
    jres = _jit(jsolve, noise_bound=0.01)(jnp.asarray(sn.numpy()), jnp.asarray(dn.numpy()))
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(jres.inliers))
    np.testing.assert_allclose(res.scale.numpy(), np.asarray(jres.scale), rtol=1e-5)
    if estimate_scaling:
        np.testing.assert_allclose(got.scale.numpy(), s_true, rtol=2e-3)
        pair = n * 3 - 3 * 4 // 2 + (7 - 3 - 1)  # pair (3, 7) in row-major order
        assert tims.compute_tim_norms(_t(src[0]))[pair] == 0
        assert not res.inliers[pair]
    else:
        np.testing.assert_array_equal(got.scale.numpy(), np.ones(3, np.float32))


def _rotation_inputs(rng):
    """Two problems of chain-TIM-like pairs, 40% outliers, the second padded."""
    bsz, n = 2, 60
    r = np.stack([random_rotation(rng) for _ in range(bsz)])
    src = rng.uniform(-1, 1, (bsz, 3, n))
    dst = r @ src + rng.uniform(-0.005, 0.005, (bsz, 3, n))
    dst[:, :, :24] = rng.uniform(-2, 2, (bsz, 3, 24))
    valid = np.ones((bsz, n), bool)
    valid[1, 45:] = False
    return src.astype(np.float32), dst.astype(np.float32), valid, r


@pytest.mark.parametrize("alg", ["quatro", "fgr"])
def test_quatro_and_fgr_match_jax(alg):
    rng = np.random.default_rng(17)
    src, dst, valid, r_true = _rotation_inputs(rng)
    if alg == "quatro":  # Quatro solves a yaw: rotations about z
        for p, a in enumerate((0.4, -1.1)):
            r_true[p] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        dst[:, :, 24:] = (r_true @ src)[:, :, 24:] + 0.002
    nb = np.array([0.02, 0.03], np.float32)  # a noise bound per problem
    fn = {"quatro": (rotation.solve_rotation_quatro, jrot.solve_rotation_quatro),
          "fgr": (rotation.solve_rotation_fgr, jrot.solve_rotation_fgr)}[alg]
    # a steeper schedule than the default 1.4 keeps FGR's annealing from
    # ~80 rounds to ~25 here
    kw = dict(gnc_factor=3.0, cost_threshold=1e-6)
    got = fn[0](_t(src), _t(dst), _t(nb), valid=_t(valid), **kw)
    want = _jit(jax.vmap(lambda s, d, b, v: fn[1](s, d, b, valid=v, **kw)))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(nb), jnp.asarray(valid))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    # the same rounds on 60 columns, float32 sums in another order
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-3, atol=1e-6)
    assert not got.inliers.numpy()[1, 45:].any()
    for p in range(2):
        assert np.linalg.norm(got.rotation.numpy()[p] - r_true[p]) < 0.05
    assert (got.iterations.numpy() > 1).all()


@pytest.mark.parametrize("alg", ["GNC_TLS", "QUATRO"])
def test_rotation_translation_complete_matches_jax(alg):
    rng = np.random.default_rng(23)
    bsz, m = 2, 32
    r = np.stack([random_rotation(rng) for _ in range(bsz)])
    if alg == "QUATRO":
        r[:, 2] = [0, 0, 1]
        r[:, :, 2] = [0, 0, 1]
        r[:, :2, :2] = [[[0.6, -0.8], [0.8, 0.6]], [[0.0, 1.0], [-1.0, 0.0]]]
    s = np.array([1.3, 0.8], np.float32)
    t = rng.normal(size=(bsz, 3))
    src = rng.uniform(-1, 1, (bsz, 3, m))
    dst = s[:, None, None] * (r @ src) + t[..., None] + rng.uniform(-0.004, 0.004, (bsz, 3, m))
    dst[:, :, :4] += 0.5  # a few outliers inside the clique
    valid = np.ones((bsz, m), bool)
    valid[1, 27:] = False
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    jp = JParams(noise_bound=0.01, rotation_estimation_algorithm=JAlg[alg])
    got = solution_to_numpy(pipeline.rotation_translation_complete(
        _t(src), _t(dst), _t(valid), _t(s), params_from_jax(jp)))
    want = _jit(jax.vmap(
        lambda a, b, v, sc: jpipe.rotation_translation_complete(a, b, v, sc, jp)))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jnp.asarray(s))
    assert got.rotation_inlier_mask.shape == (bsz, m * (m - 1) // 2)
    for f in ("valid", "rotation_inlier_mask", "translation_inlier_mask",
              "rotation_iterations", "clique_mask"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)
    # float32 rounds over 496 pairs in another summation order
    np.testing.assert_allclose(got.rotation, np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.translation, np.asarray(want.translation), atol=1e-5)
    for p in range(bsz):
        assert np.linalg.norm(got.rotation[p] - r[p]) < 0.02
