"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's ``file`` is a JSON object, and the directory
that holds it also holds ``generate.py``, whose ``make(config, seed,
device)`` returns the cell's messages.  The traffic mix is
``traffic/<traffic>.json``.  Every metric, end-to-end or per-layer, is read
by ``metrics/<name>.py``, whose ``read(run)`` returns a number or None;
where there is no such file, by that of the name's longest dotted prefix
that has one, so that ``glue_ms.decode.beacon_state`` is read by
``metrics/glue_ms.py``: a metric split by kind or configuration, for a
bound of its own, needs no new reader.  Adding any of them is adding
files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]  # the checkout
HERE = ROOT / "benchmark"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    config_dir: Path
    traffic_name: str
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    bench_dir: Path = HERE

    def generator(self) -> ModuleType:
        return load_module(self.config_dir / "generate.py", f"bench_config_{self.config_name}")

    def reader(self, metric: str):
        parts = metric.split(".")
        for k in range(len(parts), 0, -1):
            name = ".".join(parts[:k])
            path = self.bench_dir / "metrics" / f"{name}.py"
            if path.is_file():
                return load_module(path, "bench_metric_" + name.replace(".", "_").replace("-", "_")).read
        raise FileNotFoundError(f"no reader for {metric!r} under {self.bench_dir / 'metrics'}")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT, bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; its traffic and
    metric readers are looked up under ``bench_dir`` (``root/benchmark``)."""
    spec = read_spec(root)
    bench_dir = bench_dir or root / "benchmark"
    cells: Dict[str, dict] = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    conf_file = root / conf["file"]
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=conf["name"], config=json.loads(conf_file.read_text()), config_dir=conf_file.parent,
        traffic_name=w["traffic"],
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir,
    )
