"""Every part of the benchmark is a file found by its name in
BENCHMARK.json, and a later change adds a cell or a metric by adding files
and entries alone. BENCHMARK.json keeps to its contract's forms."""

import json
import re
import shutil

import pytest

from benchmark import harness

from conftest import ROOT, root_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_configuration_and_metric_is_found_by_name():
    found = harness.listing(ROOT)
    assert set(found["cells"]) == {w["name"] for w in SPEC["workloads"]}
    assert set(found["metrics"]) == {m["name"] for m in SPEC["per_layer"]}
    for w in SPEC["workloads"]:
        cell = found["cells"][w["name"]]
        assert cell["workload"].name == f"{w['name']}.json"
        assert cell["config"].exists() and cell["traffic"].exists()
    for name, path in found["metrics"].items():
        assert callable(harness.load_module(path, f"t_{name}").read)


def test_the_deferred_cells_name_files_that_are_there():
    deferred = json.loads((ROOT / "benchmark/deferred.json").read_text())
    names = [w["name"] for w in deferred["workloads"]]
    assert names and not set(names) & {w["name"] for w in SPEC["workloads"]}
    found = harness.listing(root_of(names[0]))
    assert set(names) <= set(found["cells"])
    assert {m["name"] for m in deferred["per_layer"]} <= set(found["metrics"])


def test_a_new_cell_and_metric_are_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "deepfm-criteo.train-dummy", "config": "deepfm-criteo",
                              "traffic": "train-dummy", "chips": 1, "why": "a dummy"})
    spec["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "train_examples_per_s",
                              "workloads": ["deepfm-criteo.train-dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = json.loads((ROOT / "benchmark/workloads/deepfm-criteo.train-zipf.json").read_text())
    cell["params"]["pool_batches"] = 20
    (root / "benchmark/workloads/deepfm-criteo.train-dummy.json").write_text(json.dumps(cell))
    (root / "benchmark/metrics/dummy_share.py").write_text("def read(ctx):\n    return 42.0\n")
    found = harness.listing(root)
    assert "deepfm-criteo.train-dummy" in found["cells"] and "dummy_share" in found["metrics"]
    assert harness.load_module(found["metrics"]["dummy_share"], "t_dummy").read({}) == 42.0
    assert set(found["cells"]) - {"deepfm-criteo.train-dummy"} == set(harness.listing(ROOT)["cells"])
    run = harness.Run("deepfm-criteo.train-dummy", 1, 1, False, "cpu", 0.0, root)
    assert run.params["pool_batches"] == 20 and run.config["model"] == "deepfm"
    run.close()


def test_a_missing_file_is_an_error(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "benchmark/metrics/cin_fwd_roofline.py").unlink()
    with pytest.raises(FileNotFoundError):
        harness.listing(root)


def test_benchmark_json_keeps_to_its_forms():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == []
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # each reports setup_s, another end-to-end metric and a per-layer one
        assert sum(harness.applies(m, cell) for m in SPEC["end_to_end"]) >= 2
        assert any(harness.applies(m, cell) for m in SPEC["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_each_cell_file_names_its_kind_parameters_and_limits():
    for w in SPEC["workloads"]:
        cell = json.loads(harness.cell_file(ROOT, w["name"]).read_text())
        assert harness.traffic_file(ROOT, cell["kind"]).exists()
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
        assert cell["params"]
