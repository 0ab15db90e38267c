"""The result line: its keys, the numbers compared last with their limits,
no result without a card, none when JAX was loaded, and none in a checkout
that holds the benchmark but not the program."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from regbench import run
from regbench.tests.small import CELLS, SMALL

torch.set_num_threads(2)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_on_the_cpu(cell, trace):
    # the traced run reads stage times after the profiled requests, which
    # take a second or more here
    res, verdict = run.run_cell(cell, 2 ** 31 + 99, 4.0 if trace else 0.5, bool(trace),
                                torch.device("cpu"), SMALL[cell], t0=time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics"] + (
        ["breakdown"] if trace else []) + ["device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res["checks"]) == ["set_diff", "rot_gap_deg", "trans_gap_m", "scale_gap",
                                   "undecided"]
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}
    got = set(res["metrics"])
    if trace:  # on the CPU only the program's stage times have something to read
        assert got and got <= want and not any("roofline" in m or "idle" in m for m in got)
        assert res["device"]["busy_s"] == 0.0
    else:
        assert got == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.dumps(res, allow_nan=False)
    assert verdict.lines()[-1].startswith("undecided ")


def _run_main(args, env=None):
    return subprocess.run([sys.executable, "-m", "regbench.run", *args], capture_output=True,
                          text=True, cwd=env.pop("_cwd", run.ROOT) if env else run.ROOT,
                          env=env, timeout=300)


def test_no_card_no_result():
    out = _run_main(["--workload", "bunny1889.batch", "--seed", "5", "--seconds", "1",
                     "--trace", "0"], env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 3 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_jax_loaded_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: None)  # no CUDA context here
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: ({"correct": True}, None))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "bunny1889.batch", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 4 and out.out == "" and "jax" in out.err


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("jaxtyping_like"))
    monkeypatch.setitem(sys.modules, "teaserpp_tpu_torch_like", types.ModuleType("x"))
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "teaserpp_tpu.ops", types.ModuleType("teaserpp_tpu.ops"))
    assert run.banned_modules() == ["teaserpp_tpu"]


def test_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "regbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, _cwd=str(tmp_path), PYTHONPATH="")
    out = _run_main(["--workload", "bunny1889.batch", "--seed", "5", "--seconds", "1",
                     "--trace", "0"], env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
