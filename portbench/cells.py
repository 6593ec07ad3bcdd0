"""Finding a cell's parts by name: its entry in BENCHMARK.json, its
configuration file, its traffic file, its limits file and its per-layer
metric readers.  A cell, configuration, traffic mix or metric that a later
change adds is a new file and a new entry; nothing here names one.

  BENCHMARK.json workloads[name]  -> config, traffic
  configs[config]["file"]         -> the port's overrides, classes, frame size
  portbench/traffic/<traffic>.json -> path (train or serve), batch, pool, frames
  portbench/limits/<workload>.json -> the limit of each number `correct` compares
  portbench/metrics/<metric>.py    -> read(ctx), for `<metric>` or `<metric>.<suffix>`
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config_name: str
    config: dict  # the configuration file
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # the BENCHMARK.json metrics the cell reports with --trace 0
    per_layer: List[dict]  # with --trace 1
    chips: int


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _read(root / conf["file"])
    traffic = _read(root / "portbench" / "traffic" / f"{entry['traffic']}.json")
    limits = _read(root / "portbench" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if ("workloads" in m and name in m["workloads"])
                 or ("workloads" not in m and m["moves"] in names)]
    return Cell(name, entry["config"], config, entry["traffic"], traffic, limits, e2e, per_layer,
                int(entry["chips"]))


def reader(metric: str, root: Path = ROOT) -> Optional[Callable]:
    """The `read(ctx)` of metrics/<metric>.py, or of the file named by the
    part before the first dot (one reader for `x.train` and `x.serve`)."""
    base = root / "portbench" / "metrics"
    for stem in (metric, metric.split(".", 1)[0]):
        path = base / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    return None


def read_metrics(cell: Cell, ctx: dict, root: Path = ROOT) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something for."""
    out = {}
    for m in cell.per_layer:
        fn = reader(m["name"], root)
        if fn is None:
            raise FileNotFoundError(f"no reader for per-layer metric {m['name']}")
        value = fn(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
