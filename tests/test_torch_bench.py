"""The port's benchmark (``python -m msgwam_tpu_torch bench``,
:mod:`msgwam_tpu_torch.bench`) against the JAX package's root ``bench.py``
on the CPU (``device="cpu"``, <= 512 rays): the bench population, short
runs on the plain paths, the adjoint row, the matrix's row list, and the
command line."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
import msgwam_tpu as mt
from msgwam_tpu_torch import bench as tbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 512
SETUP_BAR = 1e-6     # the population, float32, relative to each field's maximum
RUN_BAR = 1e-5       # five float32 steps on the plain paths
GRAD_BAR = 1e-4      # grad_max_abs of the adjoint row, relative

torch.set_num_threads(1)


def _rel(want, got):
    a = np.asarray(want, np.float64)
    b = np.asarray(got, np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


def _leaves(tree):
    """The arrays of a (nested) NamedTuple, with their dotted names."""
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            for name, x in _leaves(getattr(tree, f)):
                yield (f + ("." + name if name else "")), x
    else:
        yield "", tree


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


CFG_FIELDS = ("saturate_online", "hprop", "dtype", "projection_backend",
              "interp_backend", "rhs_backend", "window_cells", "flux_accum",
              "window_cells2")


@pytest.mark.parametrize("backend,accum", [("mxu", "native"),
                                           ("mxu", "compensated"),
                                           ("xla", "native"),
                                           ("pallasw", "native")])
def test_setup_matches_jax(backend, accum):
    jcfg, jbg, jstate, jstatics = jbench._setup(N, backend, accum)
    cfg, bg, state, statics = tbench._setup(N, backend, accum, device="cpu")
    for f in CFG_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for want, got in ((jstate, state), (jstatics, statics), (jbg, bg)):
        for (name, a), (_, b) in zip(_leaves(want), _leaves(got)):
            a, b = _host(a), _host(b)
            if b.dtype == np.bool_:
                np.testing.assert_array_equal(a, b, err_msg=name)
                continue
            assert b.dtype == np.float32, name
            assert _rel(a, b) <= SETUP_BAR, (name, _rel(a, b))


@pytest.mark.parametrize("backend", ["mxu", "xla"])
def test_run_matches_jax_simulate(backend):
    """Five steps of run_one's own run against msgwam_tpu.simulate on the
    JAX bench's population."""
    row, out = tbench._run(N, 5, backend, device="cpu")
    jcfg, jbg, jstate, jstatics = jbench._setup(N, backend, "native")
    run = mt.RunConfig(dt=jbench.DT, n_steps=5, save_every=5)
    jfinal = mt.simulate(jstate, jstatics, jbg, jcfg, run)[0]
    for (name, a), (_, b) in zip(_leaves(jfinal), _leaves(out[0])):
        assert _rel(_host(a), _host(b)) <= RUN_BAR, name
    assert backend in row["metric"] and f"{N:,} rays" in row["metric"]
    assert row["value"] > 0 and row["card"] == "cpu"


def test_run_grad_matches_jax():
    want = jbench.run_grad(256, 4, remat="full")
    got = tbench.run_grad(256, 4, remat="full", device="cpu")
    assert got["gradient_finite"] == want["gradient_finite"]
    assert got["grad_max_abs"] > 0.0
    assert abs(got["grad_max_abs"] - want["grad_max_abs"]) <= \
        GRAD_BAR * want["grad_max_abs"]
    assert got["metric"] == want["metric"]
    assert set(want) <= set(got)


def _recorder(real, calls, fail_at=None):
    """A stand-in for run_one that records its bound arguments (the
    port's ``device`` aside) and raises on call ``fail_at``."""
    sig = inspect.signature(real)

    def fake(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.arguments.pop("device", None)
        calls.append(dict(bound.arguments))
        if len(calls) - 1 == fail_at:
            raise MemoryError("out of memory on the ceiling row")
        return {"metric": f"row {len(calls)}", "value": 1.0}

    return fake


@pytest.mark.parametrize("n_steps", [jbench.N_STEPS, 80])
def test_run_matrix_rows_match_jax(monkeypatch, tmp_path, n_steps):
    jcalls, tcalls = [], []
    monkeypatch.setattr(jbench, "run_one", _recorder(jbench.run_one, jcalls))
    monkeypatch.setattr(jbench, "_write_matrix", lambda rows: None)
    monkeypatch.setattr(tbench, "run_one", _recorder(tbench.run_one, tcalls))
    jbench.run_matrix(n_steps)
    rows = tbench.run_matrix(n_steps, str(tmp_path), device="cpu")
    assert tcalls == jcalls
    assert len(rows) == len(jcalls) == 15
    with open(tmp_path / "bench_matrix.json") as f:
        assert json.load(f) == rows


def test_run_matrix_error_row_keeps_later_rows(monkeypatch, tmp_path, capsys):
    calls = []
    monkeypatch.setattr(tbench, "run_one",
                        _recorder(tbench.run_one, calls, fail_at=6))
    rows = tbench.run_matrix(8, str(tmp_path / "out"), device="cpu")
    assert len(rows) == 15
    assert rows[6] == {"metric": "mega at 10,000,000 rays (1 steps)",
                       "error": "MemoryError: out of memory on the ceiling row"}
    assert all("error" not in r for i, r in enumerate(rows) if i != 6)
    with open(tmp_path / "out" / "bench_matrix.json") as f:
        assert json.load(f) == rows
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in printed] == rows


def test_bench_main_tiny(capsys):
    tbench.main(n_ray=N, n_steps=5, device="cpu")
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "card",
            "power_limit"} <= set(payload)
    assert payload["value"] > 0
    assert "mega" in payload["metric"] and "extra" not in payload


@pytest.mark.parametrize("backend", ["pallas", "pallasw", "mega"])
def test_hprop_with_a_kernel_backend_raises(backend):
    with pytest.raises(ValueError, match="--hprop requires"):
        tbench.run_one(N, 2, backend, hprop=True, device="cpu")


def test_sharded_world_of_one_is_unsharded_pallasw():
    """--sharded falls back from mega to pallasw, as a gloo world of 1
    on the CPU that leaves no process group behind, with the unsharded
    run's result."""
    row, out = tbench._run(N, 4, "mega", sharded=True, device="cpu")
    assert not torch.distributed.is_initialized()
    assert "pallasw+sharded" in row["metric"]
    _, want = tbench._run(N, 4, "pallasw", device="cpu")
    for (name, a), (_, b) in zip(_leaves(want[0]), _leaves(out[0])):
        assert _rel(_host(a), _host(b)) <= 1e-6, name


@pytest.mark.parametrize("backend,kw,keys", [
    ("pallasw", {}, {"fallback_rate_end"}),
    ("mega", {"w2": 48}, {"fallback_rate_end", "full_rate_end"}),
    ("mega", {"save_every": 4, "launch_sort": "on"},
     {"fallback_rate_end", "fallback_rate_end_internal"}),
])
def test_fallback_rates(backend, kw, keys):
    row = tbench.run_one(N, 8, backend, fallback=True, device="cpu", **kw)
    got = {k for k in row if "rate" in k}
    assert got == keys
    assert all(0.0 <= row[k] <= 1.0 for k in keys)


def _module(*args, env=None):
    return subprocess.run([sys.executable, "-m", "msgwam_tpu_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_bench_subcommand_forwards_flags():
    r = _module("bench", "--n-ray", str(N), "--steps", "5", "--backend", "mxu",
                "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    payload = json.loads(r.stdout.strip().splitlines()[-1])
    assert "512" in payload["metric"] and "mxu" in payload["metric"]

    r2 = _module("run", "--bogus-flag")
    assert r2.returncode != 0
    assert "unrecognized arguments" in r2.stderr

    r3 = _module("bench", "--help")
    assert r3.returncode == 0, r3.stderr[-2000:]
    assert "--matrix" in r3.stdout and "--out" in r3.stdout


def test_bench_without_a_card_fails_at_once(monkeypatch):
    """Without --device and without a card, nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*a, **k):
        raise AssertionError("the bench ran without a device")

    monkeypatch.setattr(tbench, "_setup", refuse)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.cli(["--n-ray", str(N), "--steps", "5", "--backend", "mxu"])

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _module("bench", "--n-ray", str(N), "--steps", "5", env=env)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout.strip() == ""


def test_port_bench_imports_no_jax():
    code = ("import sys, msgwam_tpu_torch.bench; "
            "bad = [m for m in ('jax', 'msgwam_tpu', 'bench') if m in sys.modules]; "
            "sys.exit(repr(bad) if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
