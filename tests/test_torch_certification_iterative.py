"""Port parity for the ITERATIVE certifier (warm-started shift-invert DRS with
Cholesky-proven certificates) and ``certify_checkpointed``, float64 against
the JAX package under x64.

The port's seed blocks come from a ``torch.Generator``, not JAX's
``PRNGKey``, so the two packages' ITERATIVE runs agree step for step only
from a shared state: JAX's ``_iterative_init`` output is carried across by
``convert.drs_state_from_numpy``, and both run the same segment. There the
trajectories agree within 1e-6 relative plus 1e-8 absolute (the DENSE
tolerance of test_torch_certification.py: the same fixed point, another
eigensolver's roundings, a gap near 0 known to ~1e-13 (N+1)/mu), with equal
iteration counts and saturation flags. From independent inits only the
outcome is compared: the verdict, and both gaps under ``sub_optimality``.
Checkpoints are interchangeable: either package resumes the other's file.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.certification import drs as jdrs
from teaserpp_tpu.params import DRSCertifierParams as JParams
from teaserpp_tpu.params import EigSolverType as JEig
from teaserpp_tpu.solvers.rotation import solve_rotation_gnc_tls as j_gnc
from teaserpp_tpu_torch.certification import drs
from teaserpp_tpu_torch.certification.drs import (
    DRSCertifier,
    certify_batch,
    certify_checkpointed,
)
from teaserpp_tpu_torch.convert import drs_state_from_numpy, drs_state_to_numpy
from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType

from test_torch_certification import NB, TRAJ_ATOL, TRAJ_RTOL, make_gnc_problem

torch.set_num_threads(1)

ITER = EigSolverType.ITERATIVE
SEG = 25
# one params value for every JAX call of this file, so that each shape
# compiles once
JAX_PARAMS = JParams(noise_bound=NB, eig_decomposition_solver=JEig.ITERATIVE,
                     iterations_per_dispatch=SEG)
PORT_PARAMS = DRSCertifierParams(noise_bound=NB, eig_decomposition_solver=ITER,
                                 iterations_per_dispatch=SEG)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_problem(seed, n=30, n_out=7):
    """A noisy GNC problem solved by JAX's GNC-TLS -> (R, v1, v2, theta)."""
    rng = np.random.default_rng(seed)
    v1 = rng.standard_normal((3, n))
    r0, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(r0) < 0:
        r0[:, 0] *= -1
    v2 = r0 @ v1 + rng.standard_normal((3, n)) * (NB / 4)
    idx = rng.choice(n, n_out, replace=False)
    v2[:, idx] = rng.standard_normal((3, n_out)) * 2
    rot = j_gnc(jnp.asarray(v1), jnp.asarray(v2), NB)
    return (np.asarray(rot.rotation), v1, v2,
            np.where(np.asarray(rot.inliers), 1.0, -1.0))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's init state, a 60-iteration segment from it, its uninterrupted
    checkpointed run and a checkpoint it abandoned after one segment, on two
    seeded N=30 problems."""
    out = {}
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    for seed in (1, 2):
        prob = _jax_problem(seed)
        args = [jnp.asarray(a) for a in prob]
        state0, consts = jdrs._cert_init_jit(*args, JAX_PARAMS)
        seg = jdrs._cert_segment_jit(state0, consts, JAX_PARAMS, jnp.asarray(60, jnp.int32))
        ck = str(tmp / f"jax_{seed}.npz")
        assert jdrs.certify_checkpointed(*prob, JAX_PARAMS, checkpoint_path=ck,
                                         checkpoint_every=1, _stop_after_segments=1) is None
        full = jdrs.certify_checkpointed(*prob, JAX_PARAMS)
        out[seed] = dict(prob=prob, state0=[np.asarray(x) for x in state0],
                         consts=[np.asarray(x) for x in consts],
                         seg=[np.asarray(x) for x in seg], ckpt=ck, full=full)
    return out


def _assert_traj_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_segment_from_jax_state_matches_jax(jax_runs, seed):
    """From JAX's carried-over init state, 60 iterations of the port's
    segment follow JAX's: trajectory, best gap, counter and saturation."""
    run = jax_runs[seed]
    state, consts = drs_state_from_numpy(run["state0"], run["consts"], "cpu", torch.float64)
    assert state[0].dtype == torch.int32 and state[4].dtype == torch.bool
    got = drs._iterative_segment(state, consts, PORT_PARAMS, 60)
    want = run["seg"]
    it = int(want[0])
    assert int(got[0]) == it
    _assert_traj_close(got[3][:it].numpy(), want[3][:it])
    _assert_traj_close(float(got[2]), float(want[2]))
    assert bool(got[9]) == bool(want[9])
    assert bool(got[4]) == bool(want[4])
    # the port's own state round-trips to JAX's dtypes and shapes
    host, host_consts = drs_state_to_numpy(got, consts)
    assert [(a.dtype, a.shape) for a in host] == [(a.dtype, a.shape) for a in want]
    assert len(host_consts) == 3


@pytest.mark.parametrize("seed", [1, 2])
def test_iterative_certify_outcome_matches_jax(jax_runs, seed):
    """From independent inits (the seed streams differ) only the outcome is
    compared: the same verdict, and both gaps under ``sub_optimality``."""
    run = jax_runs[seed]
    got = DRSCertifier(PORT_PARAMS, device="cpu").certify(*run["prob"])
    want = run["full"]
    assert got.is_optimal == want.is_optimal
    if want.is_optimal:
        assert got.best_suboptimality < PORT_PARAMS.sub_optimality
        assert want.best_suboptimality < PORT_PARAMS.sub_optimality
        assert not got.rank_saturated


@pytest.mark.parametrize("seed", [1, 2])
def test_port_resumes_a_jax_checkpoint(jax_runs, seed, tmp_path):
    """JAX abandoned its run after one segment; the port accepts the file's
    fingerprint and resumes it: the first segment is JAX's bit for bit (it
    comes from the file), the rest follows JAX's uninterrupted run."""
    run = jax_runs[seed]
    ck = str(tmp_path / "from_jax.npz")
    with open(run["ckpt"], "rb") as src, open(ck, "wb") as dst:
        dst.write(src.read())
    with np.load(ck) as z:
        assert str(z["fingerprint"]) == drs._ckpt_fingerprint(
            *run["prob"], PORT_PARAMS, torch.float64)
    got = certify_checkpointed(*run["prob"], PORT_PARAMS, checkpoint_path=ck,
                               checkpoint_every=1, device="cpu")
    want = run["full"]
    assert got.is_optimal == want.is_optimal
    assert len(got.suboptimality_traj) == len(want.suboptimality_traj)
    assert got.suboptimality_traj[:SEG] == want.suboptimality_traj[:SEG]
    _assert_traj_close(got.suboptimality_traj, want.suboptimality_traj)


def test_jax_resumes_a_port_checkpoint(jax_runs, tmp_path):
    """The other way: the port's abandoned run, in JAX's format, resumed by
    JAX, continues the port's trajectory."""
    run = jax_runs[1]
    ck = str(tmp_path / "from_port.npz")
    assert certify_checkpointed(*run["prob"], PORT_PARAMS, checkpoint_path=ck,
                                checkpoint_every=1, _stop_after_segments=1,
                                device="cpu") is None
    with np.load(ck) as z, np.load(run["ckpt"]) as zj:
        assert sorted(z.files) == sorted(zj.files)
        for key in z.files:
            assert (z[key].dtype, z[key].shape) == (zj[key].dtype, zj[key].shape), key
    port_full = certify_checkpointed(*run["prob"], PORT_PARAMS, device="cpu")
    resumed = jdrs.certify_checkpointed(*run["prob"], JAX_PARAMS, checkpoint_path=ck)
    assert resumed.is_optimal == port_full.is_optimal
    assert resumed.suboptimality_traj[:SEG] == port_full.suboptimality_traj[:SEG]
    _assert_traj_close(resumed.suboptimality_traj, port_full.suboptimality_traj)


def test_fingerprint_guards_dtype_and_params():
    prob = make_gnc_problem(np.random.default_rng(0), 12)
    fp = drs._ckpt_fingerprint(*prob, PORT_PARAMS, torch.float64)
    assert fp == jdrs._ckpt_fingerprint(*prob, JAX_PARAMS)
    assert fp != drs._ckpt_fingerprint(*prob, PORT_PARAMS, torch.float32)
    assert fp != drs._ckpt_fingerprint(*prob, PORT_PARAMS.replace(max_iterations=100),
                                       torch.float64)


# --- mirrors of the JAX package's ITERATIVE tests (tests/test_certification.py)

def test_iterative_mode_matches_dense_synthetic():
    """At N=40 (the JAX test's 60 costs this file 4 s more)."""
    rng = np.random.default_rng(12345)
    r, v1, v2, theta = make_gnc_problem(rng, 40, NB, n_out=10)
    dense = DRSCertifier(DRSCertifierParams(noise_bound=NB), device="cpu").certify(
        r, v1, v2, theta)
    it = DRSCertifier(DRSCertifierParams(noise_bound=NB, eig_decomposition_solver=ITER),
                      device="cpu").certify(r, v1, v2, theta)
    assert dense.is_optimal and it.is_optimal
    assert not it.rank_saturated
    assert it.best_suboptimality < 1e-3
    assert abs(it.best_suboptimality - dense.best_suboptimality) < 1e-3


def _starved_problem():
    """N=32 (the JAX tests use 48; rank 4 saturates here too, ~npm/8 = 16
    negative eigenvalues) and its rank-4 params."""
    prob = make_gnc_problem(np.random.default_rng(12345), 32, NB, n_out=8)
    params = DRSCertifierParams(noise_bound=NB, eig_decomposition_solver=ITER,
                                psd_projection_rank=4)
    return prob, params


def test_iterative_rank_saturation_recovers():
    prob, starved = _starved_problem()
    _, _, _, sat_raw = drs._certify_dispatch(*map(_t, prob), starved)
    assert bool(sat_raw)  # the raw core saturates, else the test is vacuous
    dense = DRSCertifier(DRSCertifierParams(noise_bound=NB), device="cpu").certify(*prob)
    adaptive = DRSCertifier(starved, device="cpu").certify(*prob)
    assert adaptive.is_optimal == dense.is_optimal
    assert abs(adaptive.best_suboptimality - dense.best_suboptimality) < 1e-3
    assert adaptive.is_optimal or not adaptive.rank_saturated


def test_chunked_dispatch_matches_single():
    """Segments are host loop boundaries: the segmented run is bit-identical
    to one segment, single and batched."""
    prob = make_gnc_problem(np.random.default_rng(40), 24, NB, n_out=6)
    base = DRSCertifierParams(noise_bound=NB, eig_decomposition_solver=ITER)
    single = DRSCertifier(base, device="cpu").certify(*prob)
    chunked = DRSCertifier(base.replace(iterations_per_dispatch=7), device="cpu").certify(*prob)
    assert chunked.is_optimal == single.is_optimal
    assert chunked.best_suboptimality == single.best_suboptimality
    assert chunked.suboptimality_traj == single.suboptimality_traj
    stacked = [np.stack([a, a]) for a in prob]
    b_single = certify_batch(*stacked, base, device="cpu")
    b_chunked = certify_batch(*stacked, base.replace(iterations_per_dispatch=7), device="cpu")
    for a, b in zip(b_single, b_chunked):
        assert a.is_optimal == b.is_optimal
        assert a.best_suboptimality == b.best_suboptimality == single.best_suboptimality


def test_checkpointed_certification_resumes_bit_identical(tmp_path):
    rng = np.random.default_rng(41)
    prob = make_gnc_problem(rng, 24, NB, n_out=6)
    params = DRSCertifierParams(noise_bound=NB, eig_decomposition_solver=ITER,
                                iterations_per_dispatch=7)
    baseline = DRSCertifier(params, device="cpu").certify(*prob)
    assert len(baseline.suboptimality_traj) > 14  # several segments
    ck = str(tmp_path / "drs_ckpt.npz")
    assert certify_checkpointed(*prob, params, checkpoint_path=ck, checkpoint_every=1,
                                _stop_after_segments=1, device="cpu") is None
    assert os.path.exists(ck)
    resumed = certify_checkpointed(*prob, params, checkpoint_path=ck, checkpoint_every=1,
                                   device="cpu")
    assert resumed.is_optimal == baseline.is_optimal
    assert resumed.best_suboptimality == baseline.best_suboptimality
    assert resumed.suboptimality_traj == baseline.suboptimality_traj
    # another problem does not resume from the stale file
    other_prob = make_gnc_problem(rng, 24, NB, n_out=6)
    other = certify_checkpointed(*other_prob, params, checkpoint_path=ck, checkpoint_every=1,
                                 device="cpu")
    fresh = certify_checkpointed(*other_prob, params, checkpoint_path=str(tmp_path / "f.npz"),
                                 checkpoint_every=1, device="cpu")
    assert other.best_suboptimality == fresh.best_suboptimality
    assert other.suboptimality_traj == fresh.suboptimality_traj


def test_round_extension_matches_single_long_run():
    prob = make_gnc_problem(np.random.default_rng(42), 40, NB, n_out=10)
    base = dict(noise_bound=NB, eig_decomposition_solver=ITER, iterations_per_dispatch=25)
    long_run = certify_checkpointed(*prob, DRSCertifierParams(max_iterations=75, **base),
                                    device="cpu")
    multi = certify_checkpointed(*prob, DRSCertifierParams(max_iterations=25, **base),
                                 rounds=3, device="cpu")
    assert len(long_run.suboptimality_traj) > 25  # crosses a round boundary
    assert multi.is_optimal == long_run.is_optimal
    assert multi.best_suboptimality == long_run.best_suboptimality
    assert multi.suboptimality_traj == long_run.suboptimality_traj


def test_checkpointed_rank_escalation_self_recovers(tmp_path):
    prob, starved = _starved_problem()
    starved = starved.replace(iterations_per_dispatch=50)
    ck = str(tmp_path / "starved.npz")
    res = certify_checkpointed(*prob, starved, checkpoint_path=ck, checkpoint_every=1,
                               device="cpu")
    assert res.is_optimal and not res.rank_saturated
    with np.load(ck, allow_pickle=False) as z:
        assert z["s5"].shape[-1] > 4  # the escalation fired
    inert = certify_checkpointed(*prob, starved, adaptive_rank=False, device="cpu")
    assert not inert.is_optimal and inert.rank_saturated


def test_checkpointed_escalated_resume_bit_identical(tmp_path):
    prob, starved = _starved_problem()
    starved = starved.replace(max_iterations=60, iterations_per_dispatch=20)
    baseline = certify_checkpointed(*prob, starved, device="cpu")
    ck = str(tmp_path / "esc.npz")
    # 3 segments spend the rank-4 budget, the escalation saves the widened
    # state, segment 4 is the first escalated one; then the crash
    assert certify_checkpointed(*prob, starved, checkpoint_path=ck, checkpoint_every=1,
                                _stop_after_segments=4, device="cpu") is None
    with np.load(ck, allow_pickle=False) as z:
        assert z["s5"].shape[-1] > 4
    resumed = certify_checkpointed(*prob, starved, checkpoint_path=ck, checkpoint_every=1,
                                   device="cpu")
    assert resumed.is_optimal == baseline.is_optimal
    assert resumed.best_suboptimality == baseline.best_suboptimality
    assert resumed.suboptimality_traj == baseline.suboptimality_traj


def test_iterative_gap_gate_blocks_false_certificate():
    """At full rank the ITERATIVE run tracks DENSE (the same m trajectory and
    stopping point), certifying only when proven (at N=40, where both certify
    at the same iteration; the JAX test's N=48 runs both 200 iterations)."""
    prob = make_gnc_problem(np.random.default_rng(12345), 40, NB, n_out=10)
    npm = 4 * 40 + 4
    args = list(map(_t, prob))
    dense_p = DRSCertifierParams(noise_bound=NB)
    bd, _, itd, _ = drs._certify_dispatch(*args, dense_p)
    full_p = dense_p.replace(eig_decomposition_solver=ITER, psd_projection_rank=npm)
    bi, _, iti, _ = drs._certify_dispatch(*args, full_p)
    assert int(iti) == int(itd) < full_p.max_iterations
    assert abs(float(bi) - float(bd)) < 1e-6
