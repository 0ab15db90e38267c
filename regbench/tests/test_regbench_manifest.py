"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix, driver, entry, generator and metric it names
is a file of its own that the harness finds by name."""

import inspect
import json
import math
import re

import pytest

from regbench.run import HERE, ROOT, load_json, load_module, reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["regbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
    assert 1 <= len(CELLS) <= 24 and 1 <= len(CONFIGS) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for group in (CELLS, CONFIGS, [m["name"] for m in METRICS]):
        assert len(group) == len(set(group)) and all(NAME.match(n) for n in group)


def test_a_full_check_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_matches_the_manifest(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    doc = load_json("workloads", cell)
    for key in ("config", "traffic", "chips", "why"):
        assert doc[key] == entry[key]
    assert entry["chips"] == 1 and entry["config"] in CONFIGS
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]
    traffic = load_json("traffic", doc["traffic"])
    load_module("entries", traffic["entry"])
    driver = load_module("traffic", traffic["driver"])
    assert callable(driver.warm_up) and callable(driver.drive)
    five = {"set_diff", "rot_gap_deg", "trans_gap_m", "scale_gap", "undecided"}
    assert set(doc["limits"]) in (five, five | {"cert_flips", "subopt_diff"})
    for v in doc["limits"].values():
        assert isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
    assert doc["limits"]["undecided"] == 0
    # correspondences given: the program's clique is the reference's; from raw
    # clouds, the two front ends' matches part by a share of it (PERF.md, section 2)
    frontend = "frontend" in load_json("configs", doc["config"])["solver"]
    assert (doc["limits"]["set_diff"] > 0) if frontend else (doc["limits"]["set_diff"] == 0)
    if cell == "synth100k.frontend":  # the accepted limit that section 2 argues
        assert doc["limits"]["set_diff"] == 700
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("config", CONFIGS)
def test_config_file_matches_the_manifest(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"regbench/configs/{config}.json"
    doc = json.loads((ROOT / entry["file"]).read_text())
    assert doc["name"] == config and doc["source"] == entry["source"]
    assert doc["reduced"] == entry["reduced"] == []
    assert isinstance(doc["assumed"], list) and doc["precision"] == "float32"
    load_module("generators", doc["generator"])
    assert any(config == w["config"] for w in BENCH["workloads"])


@pytest.mark.parametrize("config", CONFIGS)
def test_config_names_its_reference(config):
    doc = load_json("configs", config)
    assert NAME.match(doc["reference"]) and (HERE / "reference" / f"{doc['reference']}.py").exists()
    params = inspect.signature(load_module("reference", doc["reference"]).solve).parameters
    assert list(params)[:3] == ["src", "dst", "solver"]
    assert {"dtype", "graph_dtype"} <= set(params)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_its_reader(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert hasattr(reader("metrics" if per_layer else "end_to_end", metric["name"]), "read")
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
    if per_layer:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])


def test_nothing_in_the_harness_lists_cells_or_metrics():
    code = "".join(p.read_text() for p in HERE.rglob("*.py") if "tests" not in p.parts)
    for name in CELLS + CONFIGS + [m["name"] for m in METRICS]:
        assert f'"{name}"' not in code and f"'{name}'" not in code, name


def test_a_reader_is_found_by_its_full_name_or_its_first_part(tmp_path, monkeypatch):
    from regbench import run

    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x_ms.py").write_text("def read(layers):\n    return 1\n")
    (tmp_path / "metrics" / "x_ms.facade.py").write_text("def read(layers):\n    return 2\n")
    monkeypatch.setattr(run, "HERE", tmp_path)
    assert reader("metrics", "x_ms.batch").read(None) == 1
    assert reader("metrics", "x_ms.facade").read(None) == 2
    with pytest.raises(FileNotFoundError):
        reader("metrics", "y_ms.batch")
