"""Each cell end to end on the card, a short window each: the line as the
driver reads it. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from regbench.run import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace, cuda_card):
    out = subprocess.run([sys.executable, "-m", "regbench.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 7), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    if trace:
        assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
