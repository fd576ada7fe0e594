"""Fixtures of the benchmark's tests: a copy of the benchmark's files in a
temporary directory, cut to a size the CPU runs in seconds (the program's
kernels run their plain twins there), and the check for a card that the
``cuda`` tests make inside a fixture."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
TINY_RAYS = 512


def tiny_copy(dest: Path) -> Path:
    """``dest`` with a ``BENCHMARK.json`` and a ``pb/`` copy of the
    benchmark's data and readers: every configuration at ``TINY_RAYS``
    rays, a day cut to two launches, a step loop restarting every 20 steps,
    the windows' samples drawn among their first requests."""
    pb = dest / "pb"
    shutil.copytree(BENCH, pb, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in m["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        conf["n_ray"] = TINY_RAYS
        c["file"] = f"pb/configs/{c['name']}.json"
        (dest / c["file"]).write_text(json.dumps(conf))
    edits = {"days": {"steps_per_request": 144, "trace_requests": 1,
                      "check": {"requests": 1, "within": 3, "launches": 2}},
             "per_step": {"restart_every": 20, "trace_requests": 5,
                          "check": {"requests": 3, "within": 30, "launches": 1}}}
    for name, edit in edits.items():
        path = pb / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(edit)
        path.write_text(json.dumps(t))
    (dest / "BENCHMARK.json").write_text(json.dumps(m))
    return dest


@pytest.fixture
def tiny(tmp_path):
    """``run(workload, seed, seconds)``: a run of the cut copy's cell on
    the CPU, its result line as a dict."""
    from portbench import manifest, run

    root = tiny_copy(tmp_path)

    def go(workload: str, seed: int = 7, seconds: float = 0.5) -> dict:
        cell = manifest.load(root, workload, root / "pb")
        return run.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                            time.time(), root / "pb")

    go.root = root
    return go


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
