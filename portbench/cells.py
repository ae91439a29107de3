"""A cell of ``BENCHMARK.json`` with the files it names: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``, which
names its driver in ``drivers/``) and the metrics that the cell reports."""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def path(self, rel: str) -> Path:
        """A file named in the cell's configuration or traffic, relative to
        the benchmark's folder."""
        return HERE / rel

    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.traffic['driver']}")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
                config=json.loads((ROOT / conf["file"]).read_text()),
                traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def metric_path(name: str) -> Path:
    """``metrics/<name>.py``, or where there is none, the reader of the
    quantity that the name splits by cell: ``metrics/<name before its first
    dot>.py`` (``mfu.denoise`` → ``mfu.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    return path if path.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def metric_reader(name: str):
    """The ``read(reading)`` function of the metric's reader."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, *tags) -> int:
    """A seed for one use of the run's seed (weights, a traffic piece, a
    sample), as a 63-bit integer; the same tags give the same seed."""
    h = hashlib.sha256(":".join(str(t) for t in (seed,) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def check_entry(value: float, limit: float) -> Dict[str, float]:
    return {"value": value, "limit": limit}
