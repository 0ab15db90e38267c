"""The comparison that decides ``correct``: the five numbers as they were,
and an answer's optimality certificate against the reference's in a cell
whose limits name ``cert_flips`` and ``subopt_diff``; on fixed arrays, and
through ``run.run_cell`` of a stub cell built in a temporary directory."""

import json
import math
import shutil
import time

import numpy as np
import pytest
import torch

from regbench import checks, run
from regbench.control import control_readings

FIVE = ["set_diff", "rot_gap_deg", "trans_gap_m", "scale_gap", "undecided"]
LIMITS = {"set_diff": 1, "rot_gap_deg": 0.01, "trans_gap_m": 1e-4, "scale_gap": 0,
          "undecided": 0}
CERT_LIMITS = dict(LIMITS, cert_flips=0, subopt_diff=1e-6)


def _answers():
    """Three answers and their references: the first sound, the second a
    quarter turn off, the third NaN in its translation, double in its scale
    and undecided by its reference."""
    rot = np.stack([np.eye(3)] * 3)
    rot[1] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    trans = np.array([[0, 0, 0], [1e-5, 0, 0], [np.nan, 0, 0]])
    inl = np.array([[1, 1, 0, 0, 1], [1, 0, 0, 0, 1], [1, 1, 1, 1, 1]], bool)
    ref_inl = np.array([[1, 1, 0, 0, 1]] * 3, bool)
    got = (rot, trans, np.array([1.0, 1.0, 2.0]), inl)
    want = (np.stack([np.eye(3)] * 3), np.zeros((3, 3)), np.ones(3), ref_inl,
            np.array([True, True, False]))
    return got, want


def test_a_cell_without_certificate_limits_compares_the_five_numbers_as_before():
    got, want = _answers()
    v = checks.compare(*got, *want, LIMITS)
    # the readings of the comparison before certificates were added, on these arrays
    assert v.as_json() == {"set_diff": {"value": 2, "limit": 1},
                           "rot_gap_deg": {"value": 90.0, "limit": 0.01},
                           "trans_gap_m": {"value": 1e30, "limit": 1e-4},
                           "scale_gap": {"value": 1.0, "limit": 0},
                           "undecided": {"value": 1, "limit": 0}}
    assert (v.failed, v.compared, v.correct) == (2, 3, False)
    assert [line.split()[0] for line in v.lines()] == FIVE
    # certificates handed to a cell that does not name their numbers are not read
    v2 = checks.compare(*got, *want, LIMITS, optimal=np.zeros(3, bool),
                        suboptimality=np.full(3, np.nan))
    assert v2 == v
    sound = checks.compare(*(x[:1] for x in got), *(x[:1] for x in want), LIMITS)
    assert sound.correct and list(sound.as_json()) == FIVE and sound.worst["set_diff"] == 0


def _certified(optimal, sub, ref_optimal, ref_sub, limits=CERT_LIMITS):
    got, want = _answers()
    k = len(ref_optimal)
    ok = lambda x: np.asarray(x)[:1].repeat(k, axis=0)  # noqa: E731  (the sound answer)
    return checks.compare(*map(ok, got), *map(ok, want), limits, optimal=optimal,
                          suboptimality=sub, ref_optimal=np.asarray(ref_optimal),
                          ref_suboptimality=np.asarray(ref_sub, np.float64))


def test_verdict_flips_are_counted_and_each_fails_its_answer():
    v = _certified(np.array([True, False, True, False]), np.zeros(4),
                   [True, True, False, False], np.zeros(4))
    assert list(v.as_json()) == FIVE + ["cert_flips", "subopt_diff"]
    assert v.worst["cert_flips"] == 2 and v.failed == 2 and not v.correct
    assert [line.split()[0] for line in v.lines()][-2:] == ["cert_flips", "subopt_diff"]
    same = _certified(np.array([True, False]), np.zeros(2), [True, False], np.zeros(2))
    assert same.correct and same.worst["cert_flips"] == 0 and same.failed == 0


@pytest.mark.parametrize("sub, ref_sub, reading", [
    (0.25, 0.2, 0.05),  # a finite gap reads as itself
    (np.nan, 0.2, 1e30),  # a NaN on either side
    (0.2, np.nan, 1e30),
    (np.nan, np.nan, 1e30),
    (math.inf, math.inf, 0.0),  # equal infinities
    (-math.inf, -math.inf, 0.0),
    (math.inf, 0.2, 1e30),  # an infinite gap stays a JSON number
    (math.inf, -math.inf, 1e30),
])
def test_subopt_diff_reads(sub, ref_sub, reading):
    v = _certified(np.array([True]), np.array([sub]), [True], [ref_sub])
    assert v.worst["subopt_diff"] == pytest.approx(reading, rel=1e-12, abs=0)
    assert v.worst["cert_flips"] == 0
    assert v.failed == int(reading > CERT_LIMITS["subopt_diff"])
    json.dumps(v.as_json(), allow_nan=False)


def test_answers_without_a_certificate_fail_in_a_certifying_cell():
    v = _certified(None, None, [True, False, True], [0.0, 0.5, 0.0])
    assert v.worst["cert_flips"] == 3 and v.worst["subopt_diff"] == 1e30
    assert v.failed == v.compared == 3 and not v.correct
    # one answer of three without one (NaN in both, as the harness gives it)
    v = _certified(np.array([1.0, np.nan, 1.0]), np.array([0.0, np.nan, 0.0]),
                   [True, True, True], [0.0, 0.0, 0.0])
    assert v.worst["cert_flips"] == 1 and v.failed == 1


def test_a_reference_without_a_certificate_raises():
    got, want = _answers()
    with pytest.raises(ValueError, match="reference gives none"):
        checks.compare(*got, *want, CERT_LIMITS, optimal=np.ones(3, bool),
                       suboptimality=np.zeros(3))
    with pytest.raises(ValueError, match="reference gives none"):
        checks.compare(*got, *want, CERT_LIMITS, optimal=np.ones(3, bool),
                       suboptimality=np.zeros(3), ref_optimal=np.ones(3, bool))


@pytest.mark.parametrize("named", ["cert_flips", "subopt_diff"])
def test_one_certificate_number_without_the_other_is_a_configuration_error(named):
    got, want = _answers()
    with pytest.raises(ValueError, match=f"limits name {named} alone"):
        checks.compare(*got, *want, dict(LIMITS, **{named: 0}))


# A stub cell: a tiny configuration whose problems are a translation, an
# entry and a reference in plain numpy and torch that both certify it.
ENTRY = '''
import time
import numpy as np


class _Entry:
    stage_timing = False

    def __init__(self, args):
        self.args, self.calls = args, 0

    def solve(self, src, dst, stage_ms=None):
        self.calls += 1
        time.sleep(0.005)
        k, _, n = src.shape
        t = (dst - src).mean(axis=-1).astype(np.float64)
        out = (np.repeat(np.eye(3)[None], k, 0), t, np.ones(k), np.ones((k, n), bool))
        if not self.args.get("certify", True):
            return out
        optimal = t[:, 0] > 0
        if self.calls == self.args.get("flip_call"):
            optimal[0] = ~optimal[0]
        return out + (optimal, np.abs(t[:, 1]) * 1e-3)


def open(solver, args, device):
    return _Entry(args)
'''

GENERATOR = '''
import numpy as np


def make(problem, seed, ids):
    src, dst = [], []
    for i in ids:
        rng = np.random.default_rng([seed, i])
        s = rng.standard_normal((3, problem["n"]))
        src.append(s)
        dst.append(s + rng.uniform(-1, 1, (3, 1)))
    return np.asarray(src, np.float32), np.asarray(dst, np.float32)
'''

REFERENCE = '''
from typing import NamedTuple
import torch


class Reference(NamedTuple):
    rotation: torch.Tensor
    translation: torch.Tensor
    scale: torch.Tensor
    inliers: torch.Tensor
    decided: torch.Tensor
    optimal: torch.Tensor
    suboptimality: torch.Tensor


def solve(src, dst, solver, dtype=torch.float64, graph_dtype=torch.float64):
    p, _, n = src.shape
    t = (dst.to(dtype) - src.to(dtype)).mean(dim=-1)
    f = torch.float64
    return Reference(torch.eye(3, dtype=f).expand(p, 3, 3), t.to(f), torch.ones(p, dtype=f),
                     torch.ones(p, n, dtype=torch.bool), torch.ones(p, dtype=torch.bool),
                     t[:, 0] > 0, (t[:, 1].abs() * 1e-3).to(f))
'''

# the same without a certificate
REFERENCE_PLAIN = '''
import torch


def solve(src, dst, solver, dtype=torch.float64, graph_dtype=torch.float64):
    import collections
    p, _, n = src.shape
    t = (dst.to(dtype) - src.to(dtype)).mean(dim=-1).to(torch.float64)
    ref = collections.namedtuple("Reference", "rotation translation scale inliers decided")
    return ref(torch.eye(3, dtype=torch.float64).expand(p, 3, 3), t,
               torch.ones(p, dtype=torch.float64), torch.ones(p, n, dtype=torch.bool),
               torch.ones(p, dtype=torch.bool))
'''


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The checkout of a stub cell ``stub.cert``, with the real closed-loop
    driver and end-to-end readers; ``run.HERE`` and ``run.ROOT`` point at it."""
    here = tmp_path / "bench"
    files = {
        "entries/stub.py": ENTRY,
        "generators/stub.py": GENERATOR,
        "reference/stub.py": REFERENCE,
        "reference/stub_plain.py": REFERENCE_PLAIN,
        "configs/stub.json": {"generator": "stub", "reference": "stub", "problem": {"n": 6},
                              "solver": {}},
        "traffic/stub_closed.json": {"driver": "closed_loop", "entry": "stub", "batch": 2,
                                     "pool": 8, "warmup_requests": 1, "traced_requests": 1,
                                     "args": {}},
        "workloads/stub.cert.json": {"name": "stub.cert", "config": "stub",
                                     "traffic": "stub_closed", "chips": 1,
                                     "limits": dict(LIMITS, set_diff=0, trans_gap_m=1e-5,
                                                    cert_flips=0, subopt_diff=1e-9)},
    }
    for name, body in files.items():
        (here / name).parent.mkdir(parents=True, exist_ok=True)
        (here / name).write_text(body if isinstance(body, str) else json.dumps(body))
    shutil.copy(run.HERE / "traffic" / "closed_loop.py", here / "traffic")
    (here / "end_to_end").mkdir()
    for name in ("solve_s", "setup_s"):
        shutil.copy(run.HERE / "end_to_end" / f"{name}.py", here / "end_to_end")
    metric = {"unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "end_to_end": [dict(metric, name="solve_s"), dict(metric, name="setup_s")],
        "per_layer": []}))
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(run, "ROOT", tmp_path)


def _run_stub(override=None):
    return run.run_cell("stub.cert", 2 ** 33 + 5, 0.1, False, torch.device("cpu"), override,
                        t0=time.perf_counter())


def test_run_cell_compares_an_entry_s_certificates(stub):
    res, verdict = _run_stub()
    assert res["correct"] is True and res["failed"] == 0 and verdict.compared >= 4
    assert list(res["checks"]) == FIVE + ["cert_flips", "subopt_diff"]
    assert res["checks"]["cert_flips"] == {"value": 0, "limit": 0}
    assert res["checks"]["subopt_diff"]["value"] <= 1e-9
    assert list(res["metrics"]) == ["solve_s", "setup_s"]
    json.dumps(res, allow_nan=False)


def test_run_cell_fails_the_one_answer_whose_verdict_the_entry_flipped(stub):
    # the entry's second call is the window's first request (one warm-up)
    res, verdict = _run_stub({"traffic": {"args": {"flip_call": 2}}})
    assert res["correct"] is False and res["failed"] == 1, verdict.lines()
    assert res["checks"]["cert_flips"]["value"] == 1
    assert res["checks"]["subopt_diff"]["value"] <= 1e-9


def test_run_cell_fails_every_answer_without_a_certificate(stub):
    res, verdict = _run_stub({"traffic": {"args": {"certify": False}}})
    assert res["correct"] is False and res["failed"] == verdict.compared == res["attempted"]
    assert res["checks"]["cert_flips"]["value"] == verdict.compared
    assert res["checks"]["subopt_diff"]["value"] == 1e30


def test_run_cell_without_the_reference_s_certificate_gives_no_result(stub):
    with pytest.raises(ValueError, match="reference gives none"):
        _run_stub({"config": {"reference": "stub_plain"}})


def test_the_control_compares_the_certificates(stub):
    got = control_readings("stub.cert", 7, torch.device("cpu"))
    assert list(got["checks"]) == FIVE + ["cert_flips", "subopt_diff"]
    # the certificate's gap worked out in bfloat16
    assert got["correct"] is False
    assert got["checks"]["subopt_diff"]["value"] > got["checks"]["subopt_diff"]["limit"]


def test_an_entry_without_certificates_leaves_a_plain_cell_as_it_was(stub, monkeypatch):
    doc = json.loads((run.HERE / "workloads" / "stub.cert.json").read_text())
    doc["limits"] = {k: v for k, v in doc["limits"].items() if k in FIVE}
    (run.HERE / "workloads" / "stub.cert.json").write_text(json.dumps(doc))
    for args in ({"certify": False}, {}):  # certificates in a plain cell are not read
        res, verdict = _run_stub({"traffic": {"args": args}})
        assert res["correct"] is True and list(res["checks"]) == FIVE
        assert [line.split()[0] for line in verdict.lines()] == FIVE
