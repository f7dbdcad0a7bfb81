"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's ``file`` holds the deployment as it is run; the
mix is ``traffic/<traffic>.json``; each metric is read by
``metrics/<base>.py``, where ``base`` is the metric's name up to its
first dot (``idle_share.rate`` and ``idle_share.latency`` share one
reader and differ in the cells they are reported in).  Nothing here
knows a cell, a configuration or a metric by name.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple[str, ...] | None   # None: every cell

    @property
    def base(self) -> str:
        return self.name.split(".")[0]

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]

    def metrics(self, trace: bool) -> tuple[Metric, ...]:
        return self.per_layer if trace else self.end_to_end


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _metrics(entries, cell: str) -> tuple[Metric, ...]:
    out = []
    for m in entries:
        wl = m.get("workloads")
        metric = Metric(m["name"], m["unit"], m["better"], m["source"],
                        None if wl is None else tuple(wl))
        if metric.applies(cell):
            out.append(metric)
    return tuple(out)


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    root = Path(root)
    spec = load(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json")
        .read_text())
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=_metrics(spec["end_to_end"], name),
                per_layer=_metrics(spec["per_layer"], name))


def reader(metric: Metric):
    """The ``read(record)`` function of ``metrics/<base>.py``."""
    return importlib.import_module(f"portbench.metrics.{metric.base}").read


def generator(config: dict):
    """The module ``graphs/<config["generator"]>.py``."""
    return importlib.import_module(f"portbench.graphs.{config['generator']}")
