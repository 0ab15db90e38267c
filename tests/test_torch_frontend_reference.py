"""The port's registration from raw clouds against the benchmark's plain
reference of it (``regbench/reference/fpfh_frontend.py``), on the CPU at a
small pair of the ``synth100k`` configuration's density.

The configuration's recipe (``regbench/generators/synth_pair.py``) at
``N`` points in a cube holding 12,500 points a cubic metre, as the
configuration's 100,000 in [-1, 1]^3 do, with its radii (0.05 m, 0.10 m)
and solver. Each step is held on shared inputs, where the two must agree:
the normals where they are defined (three neighbours or more), FPFH from
the same normals, the matcher on the same descriptors, the facade on the
same correspondences. A normal of fewer than three neighbours is undefined
in both, and the SPFH pairs that hold one add nothing. The whole front
ends, each from its own normals, part only where a float32 normal of an
ill-conditioned neighbourhood differs: their correspondence lists differ
by at most ``CORR_DIFFER_SHARE``.
"""

import time

import numpy as np
import pytest
import torch

from regbench import checks
from regbench.run import load_cell, load_module, run_cell
from teaserpp_tpu_torch import RobustRegistrationSolver
from teaserpp_tpu_torch.features import FPFHEstimation, Matcher, spatial
from teaserpp_tpu_torch.params import InlierSelectionMode, RobustRegistrationSolverParams

CELL = "synth100k.frontend"
N = 6000
SEED = 2_210_000_021
DENSITY = 100_000 / 8.0  # the configuration's points a cubic metre
OVERRIDE = {"config": {"problem": {"n": N, "half_width": 0.5 * (N / DENSITY) ** (1 / 3)}},
            "traffic": {"pool": 1}}
# 1 - |n_port . n_ref| of a defined normal: float32 eigenvectors of one
# covariance summed in two orders, at this density's eigengaps
NORMAL_TOL = 1e-4
# FPFH entries (0-100) of the same normals and neighbours: float32 sums in
# two orders, and a pair whose swap or bin test falls on an ulp tie
FPFH_TOL = 1e-3
FPFH_DIFFER_SHARE = 1e-3
# correspondences in one whole front end's list and not the other's, as a
# share of the reference's list: 2.5% at this pair (16 of 630 each way)
CORR_DIFFER_SHARE = 0.05

CELL_DOC, CONFIG, _ = load_cell(CELL, OVERRIDE)
FRONTEND = CONFIG["solver"]["frontend"]
RADII = (FRONTEND["normal_search_radius"], FRONTEND["fpfh_search_radius"])
FLAGS = (FRONTEND["use_absolute_scale"], FRONTEND["use_crosscheck"],
         FRONTEND["use_tuple_test"], FRONTEND["tuple_scale"])
CPU = torch.device("cpu")


def solver_params():
    fields = {k: v for k, v in CONFIG["solver"].items() if k != "frontend"}
    fields["inlier_selection_mode"] = InlierSelectionMode[fields["inlier_selection_mode"]]
    return RobustRegistrationSolverParams(**fields)


@pytest.fixture(scope="module")
def ref():
    return load_module("reference", CONFIG["reference"])


@pytest.fixture(scope="module")
def pair():
    """The pair (``(n, 3)`` float32 host clouds) and its planted (R, t)."""
    gen = load_module("generators", CONFIG["generator"])
    src, dst = gen.make(CONFIG["problem"], SEED, range(1))
    _, _, r, t = gen.draw(CONFIG["problem"],
                          np.random.default_rng(np.random.SeedSequence([SEED, 0])))
    return src[0].T.copy(), dst[0].T.copy(), r, t


@pytest.fixture(scope="module")
def reference(pair, ref):
    """The reference's steps on the pair: neighbour tables, normals,
    descriptors, correspondences and its solve."""
    src, dst, _, _ = pair
    out = {}
    for name, cloud in (("src", src), ("dst", dst)):
        pts = torch.from_numpy(cloud)
        idx_n, _ = ref.radius_table(pts, RADII[0])
        idx_f, d2_f = ref.radius_table(pts, RADII[1])
        nrm = ref.normals(pts, idx_n)
        k = (idx_n < len(cloud)).sum(1)
        out[name] = {"k": k.numpy(), "normals": nrm, "table": (idx_f, d2_f),
                     "fpfh": ref.fpfh(ref.spfh(pts, nrm, idx_f, d2_f, k >= 3), idx_f, d2_f)}
    out["corr"] = ref.correspondences(out["src"]["fpfh"], out["dst"]["fpfh"]).numpy()
    out["solve"] = ref.solve(*(torch.from_numpy(c.T.copy())[None] for c in (src, dst)),
                             CONFIG["solver"])
    return out


@pytest.fixture(scope="module", params=["auto", "grid"])
def port_fpfh(request, pair):
    """The port's ``FPFHEstimation`` on the source cloud (auto takes the
    dense route at this size): (descriptors, normals, stage timings, the
    front end's counts, the mode, the estimator)."""
    spatial.reset_frontend()
    fp = FPFHEstimation(neighbor_mode=request.param, device="cpu")
    desc = fp.computeFPFHFeatures(pair[0], *RADII)
    return (desc, fp.getNormals(), fp.getStageTimings(), dict(spatial.FRONTEND), request.param,
            fp)


def test_defined_normals_equal_the_reference(port_fpfh, reference):
    """Every normal of three neighbours or more points the reference's way."""
    _, normals, _, _, _, _ = port_fpfh
    k = reference["src"]["k"]
    dot = (normals * reference["src"]["normals"].numpy()).sum(1)
    assert (k >= 3).mean() > 0.9
    assert (1.0 - dot[k >= 3]).max() <= NORMAL_TOL


def test_descriptors_equal_the_reference_on_the_same_normals(port_fpfh, reference, ref, pair):
    """The port's FPFHEstimation descriptors against the reference's FPFH
    computed from the port's normals: at most a share FPFH_DIFFER_SHARE of
    the entries further apart than FPFH_TOL."""
    desc, normals, _, _, _, _ = port_fpfh
    idx, d2 = reference["src"]["table"]
    defined = torch.from_numpy(reference["src"]["k"] >= 3)
    want = ref.fpfh(ref.spfh(torch.from_numpy(pair[0]), torch.from_numpy(normals), idx, d2,
                             defined), idx, d2).numpy()
    assert (np.abs(desc - want) > FPFH_TOL).mean() <= FPFH_DIFFER_SHARE


@pytest.fixture(scope="module")
def port_front_end(pair):
    """The port's whole front end on the pair, as the cell's entry runs it:
    (correspondences ``(m, 2)``, the two clouds' normals)."""
    fp = FPFHEstimation(device="cpu")
    feats, normals = [], []
    for cloud in pair[:2]:
        feats.append(fp.computeFPFHFeatures(cloud, *RADII))
        normals.append(fp.getNormals())
    corr = Matcher(device="cpu").calculateCorrespondences(*pair[:2], *feats, *FLAGS)
    return np.asarray(corr, np.int64).reshape(-1, 2), normals


def test_reference_on_the_port_s_normals_matches_the_port(pair, reference, ref, port_front_end):
    """The reference's FPFH and matcher fed the port's normals give the
    port's correspondence list: the front ends part at their normals alone."""
    corr, normals = port_front_end
    feats = []
    for cloud, nrm, name in zip(pair[:2], normals, ("src", "dst")):
        idx, d2 = reference[name]["table"]
        defined = torch.from_numpy(reference[name]["k"] >= 3)
        feats.append(ref.fpfh(ref.spfh(torch.from_numpy(cloud), torch.from_numpy(nrm), idx, d2,
                                       defined), idx, d2))
    assert len(corr) > 0
    assert np.array_equal(ref.correspondences(*feats).numpy(), corr)


def test_whole_front_ends_share_their_correspondences(reference, port_front_end):
    """Each from its own normals, the two lists differ by at most
    ``CORR_DIFFER_SHARE`` of the reference's each way."""
    got = set(map(tuple, port_front_end[0].tolist()))
    want = set(map(tuple, reference["corr"].tolist()))
    assert len(want) > 0
    assert len(got - want) <= CORR_DIFFER_SHARE * len(want)
    assert len(want - got) <= CORR_DIFFER_SHARE * len(want)


def test_matcher_equals_the_reference_on_the_same_descriptors(pair, reference):
    """Mutual nearest neighbours with cross-check, the same list."""
    src, dst, _, _ = pair
    corr = Matcher(device="cpu").calculateCorrespondences(
        src, dst, reference["src"]["fpfh"].numpy(), reference["dst"]["fpfh"].numpy(), *FLAGS)
    assert len(corr) > 0
    assert np.array_equal(np.asarray(corr, np.int64), reference["corr"])


def test_facade_on_the_same_correspondences_is_within_the_cell_s_limits(pair, reference):
    """The facade (PMC_EXACT) on the reference's correspondences against the
    reference's solve, by the cell's comparison."""
    src, dst, _, _ = pair
    corr = [tuple(c) for c in reference["corr"].tolist()]
    solver = RobustRegistrationSolver(solver_params(), device="cpu")
    sol = solver.solve(src, dst, corr)
    mask = np.zeros((1, len(src)), bool)
    mask[0, reference["corr"][solver.getInlierMaxClique(), 0]] = True
    want = reference["solve"]
    v = checks.compare(sol.rotation[None], sol.translation[None], np.array([sol.scale]), mask,
                       *(x.numpy() for x in want), CELL_DOC["limits"])
    assert v.correct, v.worst


def test_reference_recovers_the_planted_transform(pair, reference):
    _, _, r, t = pair
    want = reference["solve"]
    assert bool(want.decided[0])
    assert checks.rotation_gap_deg(want.rotation[0].numpy(), r) < 0.1
    assert np.linalg.norm(want.translation[0].numpy() - t) < 0.01


def test_stage_timings_and_counters_are_the_last_call_s(port_fpfh, pair, reference):
    """FPFHEstimation's stages and the front end's counts of one call: the
    pairs each pass tested (N^2 on the dense route, fewer on the grid
    route) and the pairs within its radius, the reference's count (an ulp
    at the radius aside). A second call starts both afresh."""
    _, _, timings, counts, mode, fp = port_fpfh
    assert set(timings) == {"plans", "normals", "fpfh"}
    assert all(s >= 0 for s in timings.values())
    for p, name in enumerate(("normals", "fpfh")):
        want = int((reference["src"]["table"][0] < N).sum()) if p else int(
            reference["src"]["k"].sum())
        assert abs(counts[f"{name}_neighbors"] - want) <= 2
        cand = counts[f"{name}_candidates"]
        assert cand == N * N if mode == "auto" else 0 < cand < N * N
    assert counts["correspondences"] == counts["match_rows"] == 0

    spatial.reset_frontend()
    t0 = time.perf_counter()
    fp.computeFPFHFeatures(pair[0][: N // 2], *RADII)
    wall = time.perf_counter() - t0
    assert set(fp.getStageTimings()) == {"plans", "normals", "fpfh"}
    assert sum(fp.getStageTimings().values()) <= wall
    assert spatial.FRONTEND["fpfh_neighbors"] < counts["fpfh_neighbors"]


def test_matcher_timing_and_counters(pair, reference):
    """``Matcher.getStageTimings()`` holds the last call's ``match``; the
    counts are its correspondences and its 2N rows of feature distances."""
    src, dst, _, _ = pair
    feats = (reference["src"]["fpfh"].numpy(), reference["dst"]["fpfh"].numpy())
    m = Matcher(device="cpu")
    m.calculateCorrespondences(src, dst, *feats, *FLAGS)
    spatial.reset_frontend()
    t0 = time.perf_counter()
    corr = m.calculateCorrespondences(src[: N // 2], dst[: N // 2],
                                      feats[0][: N // 2], feats[1][: N // 2], *FLAGS)
    wall = time.perf_counter() - t0
    assert set(m.getStageTimings()) == {"match"} and m.getStageTimings()["match"] <= wall
    assert spatial.FRONTEND["correspondences"] == len(corr)
    assert spatial.FRONTEND["match_rows"] == 2 * (N // 2)


def test_cell_at_a_small_size_passes_the_comparison():
    """``regbench.run.run_cell`` of the cell, its configuration and traffic
    cut to N points and a pool of one: the entry's calls, every answer
    against the reference by the cell's limits, the end-to-end metrics."""
    res, verdict = run_cell(CELL, SEED, 0.1, False, CPU, OVERRIDE, t0=time.perf_counter())
    assert verdict.correct and res["failed"] == 0, res["checks"]
    assert {"solve_s", "setup_s"} <= set(res["metrics"])
