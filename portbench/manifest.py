"""The benchmark's manifest, ``BENCHMARK.json``, and the files it names.

Everything that belongs to one configuration, one traffic mix, one metric
or one cell's limits sits in a file of its own, found by its name:

* ``configs/<config>.json`` (the path the manifest's ``file`` gives);
* ``traffic/<traffic>.json``;
* ``metrics/<metric>.py``, a module with ``read(ctx)`` that returns the
  metric's value or ``None`` where it finds nothing to read;
* ``limits/<workload>.json``, the limits of the comparison that decides
  ``correct`` in that cell.

Adding a cell, a mix or a metric adds files and manifest entries; no file
that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration file's contents
    traffic: dict       # the traffic file's contents
    limits: dict        # the cell's limits file
    end_to_end: list    # the manifest's entries that this cell reports
    per_layer: list


def _applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load(root: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; data files are
    looked up under ``bench_dir``."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def reader(name: str, bench_dir: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
