"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from regbench.run import HERE, ROOT, load_json

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

LOAD_CELL = r"""
import json, sys
from regbench import run
cell, config, traffic = run.load_cell(sys.argv[1])
run.load_module("generators", config["generator"])
run.load_module("entries", traffic["entry"])
run.load_module("traffic", traffic["driver"])
import regbench.checks, regbench.trace, regbench.yardstick, regbench.control
import regbench.reference.registration
import teaserpp_tpu_torch
bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
for kind, folder in (("end_to_end", "end_to_end"), ("per_layer", "metrics")):
    for m in bench[kind]:
        run.reader(folder, m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_cell_driver_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", LOAD_CELL, cell], capture_output=True,
                         text=True, cwd=ROOT, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "teaserpp_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "teaserpp_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "teaserpp_tpu"), mod


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for mod in _imports(path):
        assert mod.split(".")[0] in ("__future__", "math", "typing", "torch", "numpy"), mod


def test_harness_reads_no_jax_era_script():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("chip_smoke", "bench.py", "scripts/"):
            assert name not in text, (path, name)
