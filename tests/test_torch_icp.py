"""Port parity for point-to-point ICP: the port's ``icp_point_to_point``
against the JAX package's on generated clouds with an initial error, in
float64 and float32, with padded and masked clouds of different sizes, and
at an iteration ceiling. The same matches and the same Procrustes in another
float order: the iteration counts and fitness are equal, R and t agree to the
tolerance stated per dtype."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.solvers.icp import icp_point_to_point as j_icp
from teaserpp_tpu_torch.solvers.icp import ICPResult, icp_point_to_point

from conftest import random_rotation

torch.set_num_threads(1)

# R (max abs entry) and t (max abs) between the packages: float64 agrees to
# rounding; float32 runs the Gram-form distances and the Jacobi q-method in
# another order, so a few float32 ulps of the rotation's entries
TOL = {np.float64: 1e-12, np.float32: 2e-6}
# rmse, absolute: the Gram form's squared distances carry an error of about
# eps |x|^2 each. The float64 cases are noise-free, rmse near 0, so it is
# known to sqrt(eps) |x| (1.5e-8 on unit clouds); the float32 case has
# rmse ~5e-4 and |x| ~0.5, so eps |x|^2 = 3e-8 moves it by at most
# 3e-8 / (2 * 5e-4) = 3e-5
RMSE_ATOL = {np.float64: 1e-7, np.float32: 3e-5}


def _small_rotation(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _angle_deg(r_a, r_b):
    cos = (np.trace(r_a.T @ r_b) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def _compare(got: ICPResult, want, dtype):
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-12)
    tol = TOL[dtype]
    assert np.abs(got.rotation.numpy() - np.asarray(want.rotation)).max() < tol
    assert np.abs(got.translation.numpy() - np.asarray(want.translation)).max() < tol
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), rtol=1e-3,
                               atol=RMSE_ATOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
def test_icp_matches_jax_from_perturbed_init(rng, dtype):
    """A bunny-sized cloud in a 0.15 m box, noise +-0.5 mm, started 2 deg and
    5 mm off."""
    n = 400
    src = rng.uniform(0, 0.15, size=(3, n))
    r_true = random_rotation(rng)
    t_true = np.array([0.2, -0.4, 0.1])
    dst = r_true @ src + t_true[:, None] + rng.uniform(-5e-4, 5e-4, (3, n))
    r0 = _small_rotation(rng, np.radians(2.0)) @ r_true
    t0 = t_true + 0.005
    args = [a.astype(dtype) for a in (src, dst, r0, t0)]
    want = j_icp(*[jnp.asarray(a) for a in args[:2]], 0.05, r_init=jnp.asarray(args[2]),
                 t_init=jnp.asarray(args[3]), max_iterations=50)
    got = icp_point_to_point(*args[:2], 0.05, r_init=args[2], t_init=args[3],
                             max_iterations=50, device="cpu")
    assert got.rotation.dtype == torch.from_numpy(args[0]).dtype
    _compare(got, want, dtype)
    assert _angle_deg(got.rotation.double().numpy(), r_true) < 0.1
    assert 1 < int(got.iterations) < 50


def test_icp_partial_overlap_and_padding_matches_jax(rng):
    """Different cloud sizes, padded and masked, far clutter in the target."""
    n_src, n_dst, pad = 200, 350, 32
    src = rng.uniform(-1, 1, size=(3, n_src))
    r_true = random_rotation(rng)
    t_true = np.array([-0.1, 0.3, 0.2])
    extra = rng.uniform(2.5, 3.5, size=(3, n_dst - n_src))
    dst = np.concatenate([r_true @ src + t_true[:, None], extra], axis=1)
    src_p = np.concatenate([src, np.zeros((3, pad))], axis=1)
    sv = np.concatenate([np.ones(n_src, bool), np.zeros(pad, bool)])
    dst_p = np.concatenate([dst, np.zeros((3, pad))], axis=1)
    dv = np.concatenate([np.ones(n_dst, bool), np.zeros(pad, bool)])
    r0 = _small_rotation(rng, 0.04) @ r_true
    want = j_icp(jnp.asarray(src_p), jnp.asarray(dst_p), 0.3, r_init=jnp.asarray(r0),
                 t_init=jnp.asarray(t_true), max_iterations=50, src_valid=jnp.asarray(sv),
                 dst_valid=jnp.asarray(dv))
    got = icp_point_to_point(src_p, dst_p, 0.3, r_init=r0, t_init=t_true, max_iterations=50,
                             src_valid=sv, dst_valid=dv, device="cpu")
    _compare(got, want, np.float64)
    assert _angle_deg(got.rotation.numpy(), r_true) < 0.05


def test_icp_iteration_ceiling_and_defaults_match_jax(rng):
    """Identity start (no ``r_init`` / ``t_init``) and a ceiling of 3
    iterations, which stops the run before the rmse settles."""
    n = 150
    src = rng.uniform(-1, 1, size=(3, n))
    r_true = _small_rotation(rng, 0.1)
    dst = r_true @ src + np.array([0.02, 0.0, -0.01])[:, None]
    want = j_icp(jnp.asarray(src), jnp.asarray(dst), 1.0, max_iterations=3)
    got = icp_point_to_point(src, dst, 1.0, max_iterations=3, device="cpu")
    assert int(got.iterations) == 3
    _compare(got, want, np.float64)
