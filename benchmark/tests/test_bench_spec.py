"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name; a configuration, a traffic mix, a metric and a step kind
added as new files load and run without an edit to any file that is there."""

import json
import re
import shutil
import time

import pytest
import torch

from benchmark.lib import cells, harness, kinds, steps

from .helpers import run_cpu, tiny_sizes

SPEC = cells.read_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELL_NAMES = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
    assert (cells.ROOT / SPEC["command"][1]).is_file()
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_allowed_keys_and_names(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert set(e) <= KEYS[section] and set(e) >= KEYS[section] - {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_metrics_units_bounds_and_sources():
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in SPEC["per_layer"]:
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", CELL_NAMES):
            assert cell in CELL_NAMES
            assert cell in moved.get("workloads", CELL_NAMES), (m["name"], cell)


def check_cell_resolves(cell: cells.Cell) -> None:
    assert cell.chips == 1
    assert callable(cell.generator().make)
    kind = kinds.step_class(cell.bench_dir, cell.traffic["entry"])
    for method in ("__call__", "failed", "release", "work", "check"):
        assert callable(getattr(kind, method)), (kind, method)
    assert set(tiny_sizes(cell.config_dir)) <= set(cell.config)  # the CPU size sets the configuration's keys
    reported = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell_resolves_by_name(name):
    check_cell_resolves(cells.load(name))


def _copy(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark under tmp_path; the
    benchmark's files and their bytes."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(SPEC))
    return root, {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_a_traffic_naming_no_step_kind_fails(tmp_path):
    root, _ = _copy(tmp_path)
    (root / "benchmark" / "traffic" / "nowhere.json").write_text(json.dumps({"entry": "no_kind", "warmup_steps": 0}))
    (root / "benchmark" / "traffic" / "misnamed.json").write_text(json.dumps({"entry": "misnamed", "warmup_steps": 0}))
    (root / "benchmark" / "entries" / "misnamed.py").write_text(
        "from benchmark.lib.steps import DecodeStep\n\nclass Step(DecodeStep):\n    pass\n")  # its entry: 'decode'
    spec = json.loads(json.dumps(SPEC))
    for traffic in ("nowhere", "misnamed"):
        spec["workloads"].append({"name": f"beacon_state.{traffic}", "config": "beacon_state", "traffic": traffic,
                                  "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for traffic in ("nowhere", "misnamed"):
        cell = cells.load(f"beacon_state.{traffic}", root=root)
        with pytest.raises(LookupError, match=traffic if traffic == "misnamed" else "no step kind"):
            check_cell_resolves(cell)
    cell = cells.load("beacon_state.nowhere", root=root)
    with pytest.raises(FileNotFoundError):
        steps.make(cell.traffic, cell.config, None, [], None, "cpu", cell.bench_dir)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_holds_the_configuration(conf):
    body = json.loads((cells.ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"] and body["reduced"] == conf["reduced"]
    assert all(key in body for key in conf["reduced"])
    assert (cells.ROOT / conf["file"]).parent.name == conf["name"]
    assert conf["source"].startswith("https://")


def test_a_new_config_traffic_and_metric_load_without_edits(tmp_path):
    """A later change adds files and entries only: copy the benchmark, add
    a configuration with its CPU size, a traffic mix, a metric and a step
    kind beside what is there, and load and run the new cells from the
    copy as the real cells are."""
    root, before = _copy(tmp_path)
    conf_dir = root / "benchmark" / "configs" / "dummy"
    conf_dir.mkdir()
    (conf_dir / "config.json").write_text(json.dumps({"name": "dummy", "frame_bytes": 65536, "level": 1, "reduced": []}))
    (conf_dir / "generate.py").write_text(
        "import torch\n\ndef make(cfg, seed, device):\n"
        "    return torch.full((100,), seed % 251, dtype=torch.uint8, device=device), [100]\n")
    (root / "benchmark" / "traffic" / "dummy_decode.json").write_text(json.dumps({"entry": "decode", "warmup_steps": 0}))
    (root / "benchmark" / "metrics" / "dummy_steps.py").write_text("def read(run):\n    return run.steps\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                            "file": "benchmark/configs/dummy/config.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy.decode", "config": "dummy", "traffic": "dummy_decode",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "dummy_steps", "unit": "steps", "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "setup_s", "workloads": ["dummy.decode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load("dummy.decode", root=root)
    assert cell.config["name"] == "dummy" and cell.traffic["entry"] == "decode"
    data, sizes = cell.generator().make(cell.config, 7, "cpu")
    assert sizes == [100] and int(data[0]) == 7
    assert [m["name"] for m in cell.per_layer] == ["dummy_steps"]
    assert cell.reader("dummy_steps")(type("R", (), {"steps": 3})()) == 3
    assert all(p.read_bytes() == b for p, b in before.items())
    line, checks = harness.execute(cell, 7, 0.0, False, time.perf_counter(), torch.device("cpu"))
    assert line["correct"] and line["attempted"] == 1 and "setup_s" in line["metrics"]
    # a new kind of step is a file too: entries/<entry>.py with a class Step,
    # and the configuration's CPU size is tiny.json beside its config.json
    (root / "benchmark" / "entries" / "dummy_kind.py").write_text(
        "from benchmark.lib.steps import DecodeStep\n\nclass Step(DecodeStep):\n    entry = 'dummy_kind'\n")
    (root / "benchmark" / "traffic" / "dummy_kind.json").write_text(json.dumps({"entry": "dummy_kind", "warmup_steps": 0}))
    (conf_dir / "tiny.json").write_text(json.dumps({"level": 1}))
    spec["workloads"].append({"name": "dummy.dummy_kind", "config": "dummy", "traffic": "dummy_kind",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_gbps", "unit": "GB/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["dummy.dummy_kind"]})
    spec["per_layer"][-1]["workloads"].append("dummy.dummy_kind")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "metrics" / "dummy_gbps.py").write_text(
        "def read(run):\n    return run.payload_bytes * run.steps / run.window_s / 1e9\n")
    for name in ("dummy.decode", "dummy.dummy_kind"):
        check_cell_resolves(cells.load(name, root=root))
    line, checks = run_cpu("dummy.dummy_kind", seed=7, root=root)
    assert line["correct"] and line["attempted"] == 1 and not any(checks.values())
    assert {"setup_s", "dummy_gbps"} <= set(line["metrics"])
    assert all(p.read_bytes() == b for p, b in before.items())
