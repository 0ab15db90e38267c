"""Port parity for the feature front end: the neighbour plans, normals and FPFH
of ``teaserpp_tpu_torch.features`` against the JAX package's on the same
seeded clouds, on the CPU.

Tolerances, and where they come from:
* plans: equal array for array (the same numpy code);
* normals: float64 within 1e-9 (JAX's own grid-vs-dense bound); float32
  within 64 eps32 lambda_max / (lambda_1 - lambda_0) of JAX's float64 per row
  (first-order eigenvector perturbation: the covariance carries ~eps32
  lambda_max of rounding, divided by the gap that separates the normal from
  the next eigenvector). Rows with fewer than 3 neighbours are invalid: their
  covariance has a double zero eigenvalue, so any vector of that plane is a
  normal and the two packages may pick different ones;
* SPFH/FPFH with shared (JAX's) normals: a pair whose swap test
  | |angle1| - |angle2| |, bin coordinate or squared distance lies within
  ``EDGE`` of a tie is decided by rounding in either package (PCL's swap rule,
  the bins and the atan2 cut are discontinuous there). SPFH counts are equal
  on every row but at most ``EDGE_ROWS`` of them, and each row that differs
  holds such a pair; FPFH rows whose neighbourhood holds no differing row are
  within 1e-8 (float64) or 2e-3 (float32: 100-scale values, float32 sums);
* the facades' descriptors differ through their normals (an ulp there can
  flip a swap): JAX's own grid-vs-dense gate, (err > 1e-6).mean() < 0.05 and
  err.mean() < 0.02, at radii where every point has a defined normal (3
  neighbours or more: with fewer, the covariance has a double zero
  eigenvalue and each package picks its own vector of that plane). At JAX's
  test radii (0.12, 0.2) 16 of the 576 points have none, and 7.5-8% of the
  entries differ between the packages. There the cause is checked instead:
  the defined normals agree within 1e-9, and every differing row lies within
  the FPFH radius of an SPFH row that may differ: an undefined normal, a
  neighbour of one, or a pair at a tie (neighbours with equal normals sit
  exactly on the swap test's tie). The port's own grid and dense routes stay
  inside the gate there, as JAX's do.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.features import fpfh as j_fpfh
from teaserpp_tpu.features import normals as j_normals
from teaserpp_tpu.features import spatial as j_spatial
from teaserpp_tpu.features.fpfh import FPFHEstimation as JFPFHEstimation
from teaserpp_tpu_torch.features import fpfh as t_fpfh
from teaserpp_tpu_torch.features import normals as t_normals
from teaserpp_tpu_torch.features import spatial as t_spatial
from teaserpp_tpu_torch.features import FPFHEstimation

torch.set_num_threads(1)

F32 = np.finfo(np.float32).eps
EDGE = {np.float64: 1e-9, np.float32: 1e-4}
FPFH_TOL = {np.float64: 1e-8, np.float32: 2e-3}
EDGE_ROWS = 0.05
# one query chunk holds a whole test cloud, so the JAX passes compile once
# per cloud, radius and dtype
CHUNK = 576
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}
DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])


def _wavy(seed=0, m=24, offset=2.0):
    """tests/test_features.py's surface: uneven density, away from the origin."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-1, 1, m), np.linspace(-1, 1, m))
    xs = np.sign(xs) * xs**2
    zs = 0.3 * np.sin(2.5 * xs) * np.cos(1.5 * ys) + 0.1 * np.sin(5 * xs * ys)
    pts = np.stack([xs.ravel(), ys.ravel(), zs.ravel() + offset], axis=1)
    return pts + rng.normal(scale=0.003, size=pts.shape)


def _sphere(seed=1, n=500):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


CLOUDS = {"wavy": (_wavy, 0.12), "sphere": (_sphere, 0.3)}


@pytest.mark.parametrize("radii", [(0.1, 0.18), (0.07, 0.3)], ids=["r0.1-0.18", "r0.07-0.3"])
def test_plans_equal_jax(radii):
    pts = _wavy(m=30)
    got = t_spatial.build_neighbor_plans(pts, radii, block=128, pad_multiple=64)
    want = j_spatial.build_neighbor_plans(pts, radii, block=128, pad_multiple=64)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in ("perm", "inv", "cand_idx"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert (g.n, g.block, g.nblocks, g.mpad, g.radius) == (
            w.n, w.block, w.nblocks, w.mpad, w.radius)
    sp = t_spatial.sorted_padded(pts, got[0], t_spatial.SENTINEL)
    assert np.array_equal(t_spatial.query_blocks(sp, got[0]),
                          j_spatial.query_blocks(sp, want[0]))


def test_plan_guards_raise_as_jax():
    pts = _wavy(m=16)
    (plan,) = t_spatial.build_neighbor_plans(pts, (0.1,), block=64, pad_multiple=64)
    with pytest.raises(ValueError, match="exceeds plan.radius"):
        t_normals.estimate_normals_pruned(pts, 0.2, plan, device="cpu")
    normals = t_normals.estimate_normals(torch.tensor(pts), 0.1, chunk_size=64).normals
    with pytest.raises(ValueError, match="exceeds plan.radius"):
        t_fpfh.compute_fpfh_pruned(pts, normals, 0.2, plan, device="cpu")
    for build in (t_spatial.build_neighbor_plans, j_spatial.build_neighbor_plans):
        with pytest.raises(ValueError, match="grid-hash regime"):
            build(pts, (0.005, 0.25))
        with pytest.raises(ValueError, match="radii must be positive"):
            build(pts, (0.0, 0.1))
    # 'auto' falls back to dense on the same ratio
    d = FPFHEstimation(device="cpu").computeFPFHFeatures(pts, 0.02, 0.3)
    assert d.shape == (len(pts), 33)
    # a mesh that is no port Mesh raises; a (1, 1) mesh without a process
    # group gives the mesh=None result
    from teaserpp_tpu_torch.parallel.multihost import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        FPFHEstimation(mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        t_normals.estimate_normals_pruned(pts, 0.1, plan, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        t_fpfh.compute_fpfh_pruned(pts, normals, 0.1, plan, mesh=object(), device="cpu")
    mesh = make_mesh()
    for a, b in zip(t_normals.estimate_normals_pruned(pts, 0.1, plan, mesh=mesh, device="cpu"),
                    t_normals.estimate_normals_pruned(pts, 0.1, plan, device="cpu")):
        assert torch.equal(a, b)
    assert torch.equal(t_fpfh.compute_fpfh_pruned(pts, normals, 0.1, plan, mesh=mesh, device="cpu"),
                       t_fpfh.compute_fpfh_pruned(pts, normals, 0.1, plan, device="cpu"))
    assert np.array_equal(
        FPFHEstimation(neighbor_mode="grid", mesh=mesh, device="cpu").computeFPFHFeatures(
            pts, 0.1, 0.1),
        FPFHEstimation(neighbor_mode="grid", device="cpu").computeFPFHFeatures(pts, 0.1, 0.1))
    with pytest.raises(TypeError, match="torch.Tensor"):
        t_normals.estimate_normals(pts, 0.1)


def _normals_tol(pts, radius, dtype):
    """Per-row bound of the module docstring, from JAX's float64 run."""
    if dtype == np.float64:
        return 1e-9
    cov, _ = t_normals._moments(torch.tensor(pts[None]), torch.tensor(pts[None]),
                                t_normals._r2_dense(radius, torch.float64, "cpu"))
    lam = np.linalg.eigvalsh(cov.numpy())
    return 64 * F32 * lam[:, 2] / np.maximum(lam[:, 1] - lam[:, 0], 1e-300)


def _check_normals(got, want, tol, ref64):
    """``got`` against JAX's ``want`` of the same dtype: equal valid masks;
    float64 normals within ``tol`` of JAX's, float32 within the per-row
    ``tol`` of JAX's float64 run ``ref64`` (as JAX's float32 is)."""
    ok = np.asarray(want.valid)
    assert np.array_equal(got.valid.numpy(), ok)
    n = got.normals.numpy().astype(np.float64)
    if ref64 is None:
        err = np.linalg.norm(n - np.asarray(want.normals), axis=1)
        assert err[ok].max() <= tol
        np.testing.assert_allclose(got.curvatures.numpy()[ok],
                                   np.asarray(want.curvatures)[ok], rtol=0, atol=1e-12)
    else:
        for normals in (n, np.asarray(want.normals, np.float64)):
            err = np.linalg.norm(normals - ref64, axis=1)
            assert np.all(err[ok] <= tol[ok]), float((err / tol)[ok].max())
        np.testing.assert_allclose(got.curvatures.numpy()[ok],
                                   np.asarray(want.curvatures)[ok], rtol=0, atol=1e-5)


@DTYPES
@pytest.mark.parametrize("cloud", ["wavy", "sphere"])
def test_dense_and_pruned_normals_match_jax(cloud, dtype):
    make, radius = CLOUDS[cloud]
    pts = make()
    x = pts.astype(dtype)
    tol = _normals_tol(pts, radius, dtype)
    ref64 = None
    if dtype == np.float32:
        ref64 = np.asarray(j_normals.estimate_normals(jnp.asarray(pts), radius,
                                                      chunk_size=CHUNK).normals)
    want = j_normals.estimate_normals(jnp.asarray(x), radius, chunk_size=CHUNK)
    assert np.asarray(want.valid).mean() > 0.95

    dense = t_normals.estimate_normals(torch.tensor(x), radius, chunk_size=CHUNK)
    assert dense.normals.dtype == TORCH_DTYPE[dtype]
    _check_normals(dense, want, tol, ref64)

    (plan,) = t_spatial.build_neighbor_plans(pts, (radius,), block=128, pad_multiple=64)
    pruned = t_normals.estimate_normals_pruned(x, radius, plan, device="cpu")
    assert pruned.normals.dtype == TORCH_DTYPE[dtype]
    # against JAX's dense run: JAX's grid route equals it within 1e-9 in
    # float64 (tests/test_features.py::test_normals_grid_matches_dense)
    _check_normals(pruned, want, tol, ref64)


def test_dense_normals_with_valid_mask_match_jax():
    pts = _wavy()
    valid = np.random.default_rng(4).random(len(pts)) > 0.2
    want = j_normals.estimate_normals(jnp.asarray(pts), 0.12, valid=jnp.asarray(valid),
                                      chunk_size=CHUNK)
    got = t_normals.estimate_normals(torch.tensor(pts), 0.12, valid=torch.tensor(valid),
                                     chunk_size=CHUNK)
    ok = np.asarray(want.valid)
    assert np.array_equal(got.valid.numpy(), ok) and not ok[~valid].any()
    assert np.abs(got.normals.numpy() - np.asarray(want.normals))[ok].max() <= 1e-9
    # the same neighbourhoods as the subset alone
    sub = t_normals.estimate_normals(torch.tensor(pts[valid]), 0.12)
    assert np.abs(sub.normals.numpy() - got.normals.numpy()[valid])[ok[valid]].max() <= 1e-9


def _edge_pairs(pts, nrm, radius):
    """(n, n) float64 margin of every neighbour pair to the nearest tie of the
    swap test, a bin edge or the radius (+inf where there is none), and the
    (n, n) neighbourhood mask (self included): an independent numpy version
    of the pair features (PCL computePairFeatures)."""
    d = pts[None, :, :] - pts[:, None, :]
    dist = np.sqrt((d * d).sum(-1))
    pair = (dist * dist <= radius * radius) & (dist > 0)
    safe = np.where(dist > 0, dist, 1.0)
    n_p = np.broadcast_to(nrm[:, None, :], d.shape)
    n_q = np.broadcast_to(nrm[None, :, :], d.shape)
    a1 = (n_p * d).sum(-1) / safe
    a2 = (n_q * d).sum(-1) / safe
    noswap = np.abs(a1) >= np.abs(a2)
    ns = np.where(noswap[..., None], n_p, n_q)
    nt = np.where(noswap[..., None], n_q, n_p)
    dvec = np.where(noswap[..., None], d, -d)
    f3 = np.where(noswap, a1, -a2)
    v = np.cross(dvec, ns)
    v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-300)
    w = np.cross(ns, v)
    f2 = (v * nt).sum(-1)
    f1 = np.arctan2((w * nt).sum(-1), (ns * nt).sum(-1))
    margin = np.abs(np.abs(a1) - np.abs(a2))
    x1 = 11 * (f1 + np.pi) / (2 * np.pi)
    margin = np.minimum(margin, np.abs(x1 - np.round(x1)))  # the atan2 cut at 0 / 11 too
    for x in (11 * (f2 + 1) * 0.5, 11 * (f3 + 1) * 0.5):
        edge = np.round(x)
        margin = np.minimum(margin, np.where((edge >= 1) & (edge <= 10), np.abs(x - edge), np.inf))
    margin = np.where(pair, margin, np.inf)
    # a pair on the radius itself is in or out by rounding too
    boundary = np.abs(dist * dist - radius * radius) / (radius * radius)
    margin = np.minimum(margin, np.where(boundary < 1e-3, boundary, np.inf))
    return margin, dist * dist <= radius * radius


def _counts(spfh, cnt):
    return np.round(np.asarray(spfh, np.float64) * np.maximum(cnt - 1, 1)[:, None] / 100.0)


@DTYPES
@pytest.mark.parametrize("route", ["dense", "grid"])
def test_spfh_and_fpfh_with_shared_normals_match_jax(route, dtype):
    pts = _wavy()
    rn, rf = 0.12, 0.2
    x = pts.astype(dtype)
    nrm = np.asarray(j_normals.estimate_normals(jnp.asarray(x), rn, chunk_size=CHUNK).normals)
    n = len(pts)
    if route == "dense":
        r2 = t_normals._r2_dense(rf, TORCH_DTYPE[dtype], "cpu")
        got_spfh = t_fpfh._spfh_core(torch.tensor(x[None]), torch.tensor(nrm[None]),
                                     torch.ones(1, n, dtype=TORCH_DTYPE[dtype]),
                                     torch.tensor(x[None]), torch.tensor(nrm[None]), r2).numpy()
        want_spfh = np.concatenate([np.asarray(j_fpfh._spfh_chunk(
            jnp.asarray(x[s:s + CHUNK]), jnp.asarray(nrm[s:s + CHUNK]), jnp.ones(CHUNK, dtype),
            jnp.asarray(x), jnp.asarray(nrm), rf)) for s in range(0, n, CHUNK)])
        got = t_fpfh.compute_fpfh(torch.tensor(x), torch.tensor(nrm), rf, chunk_size=CHUNK).numpy()
        want = np.asarray(j_fpfh.compute_fpfh(jnp.asarray(x), jnp.asarray(nrm), rf,
                                              chunk_size=CHUNK))
    else:
        plans = t_spatial.build_neighbor_plans(pts, (rn, rf), block=64, pad_multiple=64)
        plan = plans[1]
        assert plan.pair_fraction < 0.7  # the plan prunes
        sp = t_spatial.sorted_padded(x, plan, t_spatial.SENTINEL)
        sn = t_spatial.sorted_padded(nrm, plan, 0.0)
        qp, qn = t_spatial.query_blocks(sp, plan), t_spatial.query_blocks(sn, plan)
        want_sorted = np.asarray(j_fpfh._spfh_pruned(
            jnp.asarray(qp), jnp.asarray(qn), jnp.asarray(sp), jnp.asarray(sn),
            jnp.asarray(plan.cand_idx), jnp.asarray(rf, dtype))).reshape(-1, 33)
        rows = t_normals.query_rows(plan, "cpu")
        got_sorted = t_fpfh._spfh_sorted(
            torch.tensor(sp), torch.tensor(sn), rows, torch.tensor(plan.cand_idx).long(),
            t_normals._r2_grid(rf, TORCH_DTYPE[dtype], "cpu"), t_normals.block_steps(plan)).numpy()
        got_spfh = got_sorted[: plan.n][plan.inv]
        want_spfh = want_sorted[: plan.n][plan.inv]
        got = t_fpfh.compute_fpfh_pruned(x, torch.tensor(nrm), rf, plan, device="cpu").numpy()
        want = np.asarray(j_fpfh.compute_fpfh_pruned(x, nrm, rf, plan))

    margin, nbr = _edge_pairs(pts, nrm.astype(np.float64), rf)
    edge = margin.min(1) <= EDGE[dtype]
    cnt = nbr.sum(1)
    differ = (_counts(got_spfh, cnt) != _counts(want_spfh, cnt)).any(1)
    assert differ.mean() <= EDGE_ROWS
    # every row whose counts differ holds a pair at a tie: no other row may
    assert edge[differ].all(), np.nonzero(differ & ~edge)[0]
    np.testing.assert_allclose(got_spfh[~differ], want_spfh[~differ], rtol=0,
                               atol=1e-9 if dtype == np.float64 else 1e-4)
    clean = ~(nbr & differ[None, :]).any(1)
    assert clean.mean() > 0.8
    assert np.abs(got - want)[clean].max() <= FPFH_TOL[dtype]
    # every 11-bin block of a row with neighbours sums to 100
    for blk in range(3):
        s = got[:, blk * 11:(blk + 1) * 11].sum(1)
        np.testing.assert_allclose(s[s > 0], 100.0, rtol=1e-5)


@pytest.mark.parametrize("mode", ["auto", "dense", "grid"])
def test_facade_matches_jax_facade(mode):
    """Radii at which every point has 3 neighbours or more, so every normal is
    defined (see the module docstring)."""
    pts = _wavy()
    rn, rf = 0.2, 0.3
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    assert (d2 <= rn * rn).sum(1).min() >= 3
    want = JFPFHEstimation(neighbor_mode=mode).computeFPFHFeatures(pts, rn, rf)
    est = FPFHEstimation(neighbor_mode=mode, device="cpu", dtype=torch.float64)
    got = est.computeFPFHFeatures(pts, rn, rf)
    assert got.shape == want.shape == (len(pts), 33) and got.dtype == np.float64
    err = np.abs(got - want)
    assert (err > 1e-6).mean() < 0.05
    assert err.mean() < 0.02
    assert est.getNormals().shape == (len(pts), 3)
    if mode == "auto":  # a small cloud takes the dense route
        dense = FPFHEstimation(neighbor_mode="dense", device="cpu", dtype=torch.float64)
        assert np.array_equal(got, dense.computeFPFHFeatures(pts, rn, rf))
    f32 = FPFHEstimation(neighbor_mode=mode, device="cpu").computeFPFHFeatures(pts, rn, rf)
    assert f32.dtype == np.float32
    err32 = np.abs(f32 - want)
    assert (err32 > 1e-3).mean() < 0.05 and err32.mean() < 0.02


@pytest.mark.parametrize("mode", ["dense", "grid"])
def test_facade_differences_at_jax_radii_have_their_cause(mode):
    """At JAX's test radii, where the gate above does not hold between the
    packages: each differing descriptor row is explained by an undefined
    normal or a tie of the pair features (see the module docstring)."""
    pts = _wavy()
    rn, rf = 0.12, 0.2
    j_est = JFPFHEstimation(neighbor_mode=mode)
    want = j_est.computeFPFHFeatures(pts, rn, rf)
    est = FPFHEstimation(neighbor_mode=mode, device="cpu", dtype=torch.float64)
    got = est.computeFPFHFeatures(pts, rn, rf)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    undefined = (d2 <= rn * rn).sum(1) < 3
    assert 0 < undefined.sum() < 0.05 * len(pts)
    j_nrm = np.asarray(j_est.getNormals(), np.float64)
    dn = np.linalg.norm(est.getNormals() - j_nrm, axis=1)
    assert dn[~undefined].max() <= 1e-9
    margin, nbr = _edge_pairs(pts, j_nrm, rf)
    spfh_may = undefined | (nbr & undefined[None, :]).any(1) | (margin.min(1) <= EDGE[np.float64])
    fpfh_may = (nbr & spfh_may[None, :]).any(1)
    differ = (np.abs(got - want) > 1e-6).any(1)
    assert differ.any()
    assert not (differ & ~fpfh_may).any(), np.nonzero(differ & ~fpfh_may)[0]


def test_facade_grid_matches_dense():
    """tests/test_features.py::test_fpfh_estimation_grid_facade_matches_dense
    on the port, at its radii (16 points there have fewer than 3 neighbours,
    so the normals are computed, undefined or not, by one package's
    arithmetic on both routes)."""
    pts = _wavy()
    d_dense = FPFHEstimation(neighbor_mode="dense", device="cpu",
                             dtype=torch.float64).computeFPFHFeatures(pts, 0.12, 0.2)
    d_grid = FPFHEstimation(neighbor_mode="grid", device="cpu",
                            dtype=torch.float64).computeFPFHFeatures(pts, 0.12, 0.2)
    err = np.abs(d_dense - d_grid)
    assert (err > 1e-6).mean() < 0.05
    assert err.mean() < 0.02
