"""Port parity: Jacobi eigensolver, Procrustes, scalar TLS, GNC-TLS rotation
and TLS translation against the JAX package, on the same float32 inputs.

Tolerances: both sides run the same float32 arithmetic in the same order,
but XLA may fuse a multiply-add or sum a reduction in another order than
PyTorch's CPU kernels, so float results agree to a few ulps of float32
(about 1e-7 relative), amplified by at most a few sweeps or GNC rounds.
Each tolerance below is stated beside its check.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.ops import procrustes as jproc
from teaserpp_tpu.ops import tls as jtls
from teaserpp_tpu.solvers import rotation as jrot
from teaserpp_tpu.solvers import translation as jtrans
from teaserpp_tpu_torch.device import resolve_device
from teaserpp_tpu_torch.ops import cuda_kernels as ck
from teaserpp_tpu_torch.ops import procrustes as tproc
from teaserpp_tpu_torch.ops import tls as ttls
from teaserpp_tpu_torch.solvers import rotation as trot
from teaserpp_tpu_torch.solvers import translation as ttrans

from conftest import random_rotation

T = torch.from_numpy


def test_jacobi_eigh_small_matches_jax(rng):
    a = rng.normal(size=(16, 4, 4)).astype(np.float32)
    a = a + np.swapaxes(a, -1, -2)
    a[0] = np.diag([3.0, 1.0, -2.0, 0.5])  # already diagonal: zero rotations
    t_vals, t_vecs = tproc.jacobi_eigh_small(T(a))
    j_vals, j_vecs = jproc.jacobi_eigh_small(jnp.asarray(a))
    # same sweeps, same pair order: 1e-5 absolute on O(1) entries covers
    # float32 rounding-order differences carried through 10 sweeps
    np.testing.assert_allclose(t_vals.numpy(), np.asarray(j_vals), atol=1e-5)
    np.testing.assert_allclose(t_vecs.numpy(), np.asarray(j_vecs), atol=1e-5)
    # and it is an eigendecomposition (float32 residual of a 4x4 solve)
    recon = t_vecs @ torch.diag_embed(t_vals) @ t_vecs.transpose(-1, -2)
    np.testing.assert_allclose(recon.numpy(), a, atol=1e-5)


def test_svd_rot_matches_jax(rng):
    b, n = 8, 50
    r = np.stack([random_rotation(rng) for _ in range(b)])
    x = rng.normal(size=(b, 3, n)).astype(np.float32)
    y = (r @ x + rng.normal(scale=0.01, size=(b, 3, n))).astype(np.float32)
    w = rng.random((b, n)).astype(np.float32)
    w[0] = 0.0  # degenerate: identity on both sides
    got = tproc.svd_rot(T(x), T(y), T(w)).numpy()
    ref = np.asarray(jax.vmap(jproc.svd_rot)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    # rotation entries are O(1); 1e-5 is float32 rounding through the 3x3
    # correlation sum (other order) and the Jacobi sweeps
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_array_equal(got[0], np.eye(3, dtype=np.float32))


def test_rotate_is_float32_and_leaves_global_matmul_settings(rng):
    r = np.stack([random_rotation(rng) for _ in range(4)]).astype(np.float32)
    x = rng.normal(size=(4, 3, 70)).astype(np.float32)
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    got = tproc.rotate(T(r), T(x)).numpy()
    # three float32 products summed, O(1) entries: a few ulps
    np.testing.assert_allclose(got, r.astype(np.float64) @ x, atol=1e-6)
    resolve_device("cpu")
    after = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    assert after == before


def test_scalar_tls_fixed_range_matches_jax(rng):
    b, n = 6, 120
    x = rng.uniform(-5, 5, (b, n)).astype(np.float32)
    x[:, :60] = (1.3 + rng.uniform(-0.01, 0.01, (b, 60))).astype(np.float32)
    valid = rng.random((b, n)) < 0.9
    beta = 0.02
    got = ttls.scalar_tls_fixed_range(T(x), beta, T(valid))
    ref = jtls.scalar_tls_fixed_range(jnp.asarray(x), beta, jnp.asarray(valid))
    # prefix sums of up to 2N float32 terms in another order: 1e-5 relative
    np.testing.assert_allclose(got.estimate.numpy(), np.asarray(ref.estimate), rtol=1e-5)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))


def _tim_problem(rng, b, n, outlier_frac, noise):
    r = np.stack([random_rotation(rng) for _ in range(b)])
    src = rng.uniform(-1, 1, (b, 3, n))
    dst = r @ src + rng.uniform(-noise, noise, (b, 3, n))
    n_out = int(outlier_frac * n)
    dst[:, :, :n_out] = rng.uniform(-1, 1, (b, 3, n_out))
    valid = np.ones((b, n), bool)
    valid[1, n // 2:] = False
    return src.astype(np.float32), dst.astype(np.float32), valid, r


def test_gnc_tls_rotation_matches_jax(rng):
    b, n = 4, 80
    src, dst, valid, r_true = _tim_problem(rng, b, n, 0.3, 0.002)
    nb = np.full((b,), 0.01, np.float32)
    nb[2] = 0.02
    kw = dict(gnc_factor=1.4, max_iterations=100, cost_threshold=1e-6)
    got = trot.solve_rotation_gnc_tls(T(src), T(dst), T(nb), valid=T(valid), **kw)
    ref = jax.vmap(lambda s, d, v, e: jrot.solve_rotation_gnc_tls(s, d, e, valid=v, **kw))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jnp.asarray(nb))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    # per-round 1e-6-level differences do not grow: the weights agree exactly
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(ref.rotation), atol=1e-5)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-4)
    assert (got.iterations.numpy() >= 2).all()
    for p in range(b):
        assert np.abs(got.rotation[p].numpy() - r_true[p]).max() < 1e-2


def test_gnc_tls_degenerate_and_iteration_cap(rng):
    """Exact data (mu <= 0 break on round one) and a cap of one round."""
    b, n = 2, 30
    src, _, _, r = _tim_problem(rng, b, n, 0.0, 0.0)
    dst = (r @ src).astype(np.float32)
    got = trot.solve_rotation_gnc_tls(T(src), T(dst), 0.05)
    ref = jax.vmap(lambda s, d: jrot.solve_rotation_gnc_tls(s, d, 0.05))(
        jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(ref.rotation), atol=1e-5)
    capped = trot.solve_rotation_gnc_tls(T(src), T(dst), 1e-4, max_iterations=1)
    assert capped.iterations.tolist() == [1, 1]


@pytest.mark.parametrize("d", [3, 2])
def test_solve_gnc_tls_on_the_cpu_is_the_plain_loop(d, rng):
    """On CPU tensors ``_solve_gnc_tls`` runs kernel R's plain version (the
    GNC-TLS loop of GNC-TLS at d = 3 and of Quatro at d = 2), bit for bit,
    launches nothing, and follows JAX's loop."""
    b, n = 4, 80
    src, dst, valid, _ = _tim_problem(rng, b, n, 0.3, 0.002)
    src, dst = np.ascontiguousarray(src[:, :d]), np.ascontiguousarray(dst[:, :d])
    nb = np.array([0.01, 0.02, 0.0, 0.01], np.float32)  # 0: the 1e-2 fallback
    t_proc, j_proc = {3: (tproc.svd_rot, jproc.svd_rot), 2: (tproc.svd_rot_2d,
                                                             jproc.svd_rot_2d)}[d]
    kw = (1.4, 100, 1e-6)
    ck.reset_launches()
    got = trot._solve_gnc_tls(T(src), T(dst), T(nb), *kw, T(valid), t_proc)
    assert not any(ck.LAUNCHES.values()), ck.LAUNCHES
    plain = ck.gnc_tls_plain(T(src), T(dst), T(nb), *kw, T(valid), t_proc)
    assert all(torch.equal(a, p) for a, p in zip(got, plain))
    ref = jax.vmap(lambda s_, d_, v, e: jrot._solve_gnc_tls(s_, d_, e, *kw, v, j_proc))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jnp.asarray(nb))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    threshold = 0.5 if d == 3 else 0.4
    np.testing.assert_array_equal(got[1].numpy() >= threshold, np.asarray(ref[1]) >= threshold)
    # as test_gnc_tls_rotation_matches_jax: float32 rounding in another order
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)


GNC_REFUSALS = ["dtype", "d", "dst shape", "valid dtype", "procrustes"]


@pytest.mark.parametrize("case", GNC_REFUSALS)
def test_gnc_tls_refuses_what_kernel_r_does_not_take(case):
    """The wrapper's checks hold on either device: integer points, a 4-D
    problem, a ``dst`` of another shape, a ``valid`` mask of bytes, and the
    3-D Procrustes for a 2-D problem; nothing counted."""
    pts = torch.ones(2, 3, 10)
    valid = torch.ones(2, 10, dtype=torch.bool)
    args = dict(src=pts, dst=pts, valid=valid, procrustes=tproc.svd_rot)
    args.update({"dtype": dict(src=pts.int(), dst=pts.int()),
                 "d": dict(src=pts.repeat(1, 2, 1)[:, :4], dst=pts.repeat(1, 2, 1)[:, :4]),
                 "dst shape": dict(dst=pts[:, :, :9]),
                 "valid dtype": dict(valid=valid.to(torch.uint8)),
                 "procrustes": dict(src=pts[:, :2], dst=pts[:, :2])}[case])
    ck.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        ck.gnc_tls(noise_bound=0.01, gnc_factor=1.4, max_iterations=100, cost_threshold=1e-6,
                   **args)
    assert not any(ck.LAUNCHES.values()), ck.LAUNCHES


def test_translation_tls_matches_jax(rng):
    b, n = 3, 90
    src = rng.uniform(-1, 1, (b, 3, n)).astype(np.float32)
    t = rng.uniform(-2, 2, (b, 3, 1))
    dst = src + t + rng.uniform(-0.004, 0.004, (b, 3, n))
    dst[:, :, :40] += rng.integers(5, 11, (b, 1, 40))
    dst = dst.astype(np.float32)
    valid = rng.random((b, n)) < 0.8
    got = ttrans.solve_translation_tls(T(src), T(dst), 0.005, valid=T(valid))
    ref = jax.vmap(lambda s, d, v: jtrans.solve_translation_tls(s, d, 0.005, valid=v))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid))
    # means of ~50 float32 values summed in another order: 1e-5 absolute
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(ref.translation), atol=1e-5)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.translation.numpy(), t[..., 0], atol=5e-3)
