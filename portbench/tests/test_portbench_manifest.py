"""The harness finds every piece by its name, and ``BENCHMARK.json`` keeps
to the form the benchmark's contract gives it."""

import json
import re

import pytest

from portbench import manifest
from portbench.tests.conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"] and 1 <= M["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in M[k]}) == len(M[k])
    assert len({m["name"] for m in M["end_to_end"] + M["per_layer"]}) == \
        len(M["end_to_end"]) + len(M["per_layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_finds_its_files_by_name():
    configs = {c["name"]: c for c in M["configs"]}
    for c in M["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] == []
    for w in M["workloads"]:
        cell = manifest.load(REPO, w["name"])
        assert cell.config == json.loads((REPO / configs[w["config"]]["file"]).read_text())
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits["limits"]) >= {"flux_gap"}
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.reader(m["name"]))
        for m in cell.per_layer:
            assert m["moves"] in reported


def test_per_layer_metrics_of_one_layer_agree_and_name_their_cells():
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert set(m["workloads"]) <= cells and m["workloads"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_config_mix_and_metric_are_found_by_name(tiny):
    """A later change adds files and manifest entries only: a mix of two-
    step requests, a configuration at another ray count and a metric that
    reads the window's request count."""
    root = tiny.root
    conf = json.loads((root / "pb/configs/ref_1e6.json").read_text())
    conf.update(name="ref_small", n_ray=256)
    (root / "pb/configs/ref_small.json").write_text(json.dumps(conf))
    mix = json.loads((root / "pb/traffic/per_step.json").read_text())
    mix.update(name="two_steps", steps_per_request=2, save_every=2)
    (root / "pb/traffic/two_steps.json").write_text(json.dumps(mix))
    (root / "pb/metrics/requests_seen.py").write_text(
        "def read(ctx):\n    return ctx.requests\n")
    limits = json.loads((root / "pb/limits/ref_1e6.per_step.json").read_text())
    (root / "pb/limits/ref_small.two_steps.json").write_text(json.dumps(limits))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append(dict(m["configs"][0], name="ref_small",
                             file="pb/configs/ref_small.json"))
    m["workloads"].append({"name": "ref_small.two_steps", "config": "ref_small",
                           "traffic": "two_steps", "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "requests_seen", "unit": "requests",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["ref_small.two_steps"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    before = {p: p.read_bytes() for p in (root / "pb").rglob("*.py")
              if p.name != "requests_seen.py"}
    res = tiny("ref_small.two_steps", seconds=0.3)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"ray_steps_per_s", "setup_s", "requests_seen"}
    assert res["metrics"]["requests_seen"]["value"] == res["attempted"]
    assert all(p.read_bytes() == b for p, b in before.items())
    # the other cells report no metric of the new cell
    other = tiny("ref_1e6.per_step", seconds=0.2)
    assert set(other["metrics"]) == {"ray_steps_per_s", "setup_s"}


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        manifest.load(REPO, "no_such.cell")
