"""The front end's two rotation-stage problems (``.e2e_cert_synth100k.npz``,
a chain of 1,732 TIMs; ``.e2e_cert_scene60k.npz``, 1,360 TIMs with 16 TLS
outliers) through scripts/bench_frontend_e2e.py::certify_saved's flow in
both packages, float64: a GNC-TLS over the chain, a 150-TIM subset that
keeps every outlier, GNC again on the subset (the same subset, outliers,
theta and GNC iterations as JAX; R within 1e-12), then the port's
``certify_checkpointed`` on synth100k. scene60k's certification (~2,300
iterations) runs on the card only (``tests/test_torch_chip_certification.py``).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.solvers.rotation import solve_rotation_gnc_tls as j_gnc
from teaserpp_tpu_torch.certification.drs import certify_checkpointed
from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType
from teaserpp_tpu_torch.solvers.rotation import solve_rotation_gnc_tls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.array(a))


NCERT = 150


def _certified_subset(v1f, v2f, nb, gnc):
    """scripts/bench_frontend_e2e.py::certify_saved's subset: every TLS outlier
    of the chain and evenly spaced inliers up to 150 TIMs, then GNC again."""
    _, th_full, _ = gnc(v1f, v2f, nb)
    out_idx, in_idx = np.nonzero(~th_full)[0], np.nonzero(th_full)[0]
    keep_out = out_idx[: NCERT // 2]
    n_in = min(NCERT - len(keep_out), len(in_idx))
    keep_in = in_idx[np.linspace(0, len(in_idx) - 1, n_in).astype(int)]
    sel = np.sort(np.concatenate([keep_in, keep_out]))
    r, inl, iters = gnc(v1f[:, sel], v2f[:, sel], nb)
    return dict(sel=sel, chain_outliers=len(out_idx), rotation=r,
                theta=np.where(inl, 1.0, -1.0), gnc_iterations=iters)


def _jax_gnc(a, b, nb):
    res = j_gnc(jnp.asarray(a), jnp.asarray(b), nb)
    return np.asarray(res.rotation), np.asarray(res.inliers), int(res.iterations)


def _port_gnc(a, b, nb):
    res = solve_rotation_gnc_tls(_t(a)[None], _t(b)[None], nb)
    return res.rotation[0].numpy(), res.inliers[0].numpy(), int(res.iterations.reshape(-1)[0])


def _fixture(name):
    with np.load(os.path.join(ROOT, f".e2e_cert_{name}.npz")) as z:
        return z["v1"], z["v2"], float(z["nb_rot"])


@pytest.mark.parametrize("name,outliers", [("synth100k", 0), ("scene60k", 10)])
def test_frontend_subset_matches_jax(name, outliers):
    """The port's float64 GNC picks JAX's 150-TIM subset, outliers and theta."""
    v1f, v2f, nb = _fixture(name)
    want = _certified_subset(v1f, v2f, nb, _jax_gnc)
    got = _certified_subset(v1f, v2f, nb, _port_gnc)
    assert np.array_equal(got["sel"], want["sel"]) and len(got["sel"]) == NCERT
    assert got["chain_outliers"] == want["chain_outliers"]
    assert np.array_equal(got["theta"], want["theta"])
    assert int((got["theta"] < 0).sum()) == outliers
    assert got["gnc_iterations"] == want["gnc_iterations"]
    assert np.abs(got["rotation"] - want["rotation"]).max() < 1e-12


def test_synth100k_certifies_on_cpu(tmp_path):
    """certify_saved's ITERATIVE run (rank 128, 25-iteration segments, 20
    rounds of 200) on synth100k's subset: certified with gap 0, as the JAX
    package is in 75 iterations; the port's seed blocks differ, so its count
    may differ a little (76 with this torch)."""
    v1f, v2f, nb = _fixture("synth100k")
    sub = _certified_subset(v1f, v2f, nb, _port_gnc)
    params = DRSCertifierParams(noise_bound=nb, eig_decomposition_solver=EigSolverType.ITERATIVE,
                                iterations_per_dispatch=25, psd_projection_rank=128,
                                max_iterations=200)
    res = certify_checkpointed(sub["rotation"], v1f[:, sub["sel"]], v2f[:, sub["sel"]],
                               sub["theta"], params, checkpoint_path=str(tmp_path / "ck.npz"),
                               rounds=20, device="cpu")
    assert res.is_optimal and res.best_suboptimality == 0.0 and not res.rank_saturated
    assert abs(len(res.suboptimality_traj) - 75) <= 8
