"""The port's experiment driver (``python -m msgwam_tpu_torch run``)
against msgwam_tpu.cli on the same specs, on the CPU (``--device cpu``):
the config loader, the float64 reference preset, a float32 source, the
kernel routes (their twins here), the tidal lifecycle, resume, streamed
history and the refusals."""

import argparse
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import msgwam_tpu.cli as jcli
import msgwam_tpu_torch.cli as tcli
from msgwam_tpu_torch.utils.history_io import read_state_history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("wave_action", "flux", "tendency", "u", "v")

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300)


def _port(spec, out, **kw):
    tcli.run_experiment(spec, str(out), make_plot=False, device="cpu", **kw)
    return dict(np.load(os.path.join(out, "diagnostics.npz")))


def _jax(spec, out, **kw):
    jcli.run_experiment(json.loads(json.dumps(spec)), str(out),
                        make_plot=False, **kw)
    return dict(np.load(os.path.join(out, "diagnostics.npz")))


def _assert_close(want, got, tol, fields=FIELDS):
    """Each field within ``tol`` of ``want``'s maximum; v (zero or
    roundoff at phi0 = 0) against the wind's maximum."""
    np.testing.assert_array_equal(want["time"], got["time"])
    for f in fields:
        a, b = np.float64(want[f]), np.float64(got[f])
        assert a.shape == b.shape, f
        scale = np.max(np.abs(a))
        if f == "v":
            scale = max(scale, np.max(np.abs(np.float64(want["u"]))))
        err = np.max(np.abs(a - b)) / max(scale, 1e-300)
        assert err <= tol, (f, err)


def _spec(n_ray=512, n_steps=20, save_every=5, kernels=None, **model):
    spec = {
        "model": {"u0": 4.0, "phi0": 0.0, "kappa": 1.0, "hprop": False,
                  "saturate_online": True, "rr0": 40000.0,
                  "projection_backend": "mxu", "interp_backend": "mxu",
                  **model},
        "grid": {"n_face": 101, "z_max": 100e3},
        "run": {"dt": 120.0, "n_steps": n_steps, "save_every": save_every},
        "source": {"kind": "gaussian_spectrum", "n_ray": n_ray,
                   "z_launch": 2000.0, "dz_launch": 500.0,
                   "amplitude_alpha": 0.003},
        "background": "sine",
        "dtype": "float32",
    }
    if kernels:
        spec["kernels"] = kernels
    return _loaded(spec)


def _tidal_spec(n_ray=300, n_steps=12, save_every=4):
    spec = _spec(n_ray, n_steps, save_every, cull=True, relaunch=True,
                 prognostic_mean=False)
    spec["background"] = {"kind": "tidal", "period": 43200.0,
                          "lambda_z": 30000.0}
    return spec


def _loaded(spec, kernels=None):
    """``spec`` through ``_load_config`` as a config file with
    ``--kernels kernels``."""
    ns = argparse.Namespace(config=None, preset="_", steps=None,
                            kernels=kernels, window2=None)
    with mock.patch.dict(tcli.PRESETS, {"_": spec}):
        return tcli._load_config(ns)


@pytest.mark.parametrize("steps", [None, 7, 15, 20])
@pytest.mark.parametrize("kernels", [None, "xla", "mxu", "pallas", "windowed",
                                     "mega"])
@pytest.mark.parametrize("preset", ["reference", "fast"])
def test_load_config_matches_jax(preset, kernels, steps):
    ns = argparse.Namespace(config=None, preset=preset, steps=steps,
                            kernels=kernels, window2=None)
    assert tcli._load_config(ns) == jcli._load_config(ns)


@pytest.mark.parametrize("case", ["file_mega", "file_windowed_explicit",
                                  "flag_over_file", "window2"])
def test_load_config_file_matches_jax(tmp_path, case):
    """A file-level ``"kernels"`` fills only the backends the file left
    unset; ``--kernels`` overrides the file's model block; ``--window2``
    sets ``window_cells2``."""
    base = {"model": {}, "grid": {}, "run": {"dt": 120.0, "n_steps": 4,
                                             "save_every": 4},
            "source": {"kind": "gaussian_spectrum", "n_ray": 64},
            "dtype": "float32"}
    spec, kw = {
        "file_mega": ({**base, "kernels": "mega"}, {}),
        "file_windowed_explicit": ({**base, "kernels": "windowed",
                                    "model": {"window_cells": 32}}, {}),
        "flag_over_file": ({**base, "model": {"rhs_backend": "xla"}},
                           {"kernels": "pallas"}),
        "window2": ({**base, "kernels": "windowed"}, {"window2": 48}),
    }[case]
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(spec))
    ns = argparse.Namespace(config=str(path), preset="reference", steps=None,
                            kernels=kw.get("kernels"),
                            window2=kw.get("window2"))
    assert tcli._load_config(ns) == jcli._load_config(ns)


def test_reference_preset_matches_jax_and_resumes_from_its_checkpoint(tmp_path):
    """``--preset reference --steps 20 --device cpu``: diagnostics.npz and
    final_state.npz within 1e-10 of msgwam_tpu's in float64; then both
    packages resume from msgwam_tpu's checkpoint for 5 more steps."""
    ns = argparse.Namespace(config=None, preset="reference", steps=20,
                            kernels=None, window2=None)
    spec = jcli._load_config(ns)
    tcli.main(["run", "--preset", "reference", "--steps", "20", "--device",
               "cpu", "--out", str(tmp_path / "t"), "--no-plot"])
    got = dict(np.load(tmp_path / "t" / "diagnostics.npz"))
    want = _jax(spec, tmp_path / "j")
    _assert_close(want, got, 1e-10)
    jstate = np.load(tmp_path / "j" / "final_state.npz")
    tstate = np.load(tmp_path / "t" / "final_state.npz")
    assert sorted(jstate.files) == sorted(tstate.files)
    for name in jstate.files:
        if name.startswith(("rays.", "mean.")):
            assert jstate[name].dtype == tstate[name].dtype == np.float64
            assert _rel(jstate[name], tstate[name]) <= 1e-10, name

    spec5 = jcli._load_config(argparse.Namespace(
        config=None, preset="reference", steps=5, kernels=None, window2=None))
    ckpt = str(tmp_path / "j" / "final_state.npz")
    got = _port(spec5, tmp_path / "tr", resume_from=ckpt)
    want = _jax(spec5, tmp_path / "jr", resume_from=ckpt)
    assert got["time"][0] == 20 * 120.0 + 120.0
    _assert_close(want, got, 1e-10)


def test_gaussian_spectrum_float32_matches_jax(tmp_path):
    """512 float32 rays of the gaussian source, 20 steps on the mxu route,
    within 1e-4 of msgwam_tpu's."""
    spec = _spec(kernels="mxu")
    _assert_close(_jax(spec, tmp_path / "j"), _port(spec, tmp_path / "t"),
                  1e-4)


@pytest.fixture(scope="module")
def mxu_run(tmp_path_factory):
    return _port(_spec(kernels="mxu"), tmp_path_factory.mktemp("mxu"))


@pytest.mark.parametrize("kernels", ["pallas", "windowed", "mega"])
def test_kernel_routes_match_the_plain_route(tmp_path, mxu_run, kernels,
                                             capsys):
    """``--kernels pallas|windowed|mega`` (K2, K4, K5: their twins on the
    CPU) within 1e-4 of the port's mxu route, with no fallback."""
    got = _port(_spec(kernels=kernels), tmp_path)
    assert "falling back" not in capsys.readouterr().out
    _assert_close(mxu_run, got, 1e-4)


def test_tidal_lifecycle_matches_jax_and_mega(tmp_path, capsys):
    """The tidal background with cull and relaunch at 300 rays:
    ``--kernels xla`` within 1e-4 of msgwam_tpu's xla route, and ``mega``
    (K6's twin) within 1e-4 of the port's xla route."""
    spec = _loaded(_tidal_spec(), "xla")
    got = _port(spec, tmp_path / "t")
    _assert_close(_jax(spec, tmp_path / "j"), got, 1e-4)
    mega = _port(_loaded(_tidal_spec(), "mega"), tmp_path / "m")
    assert "falling back" not in capsys.readouterr().out
    _assert_close(got, mega, 1e-4)


@pytest.mark.parametrize("kernels", ["mxu", "mega"])
def test_resume_continues_the_run(tmp_path, kernels):
    """10 steps, then ``--resume`` for 10 more, equal to a straight 20-step
    run to the bit, through the tidal phase (t0) and relaunch."""
    full = _loaded(_tidal_spec(n_steps=20, save_every=5), kernels)
    half = _loaded(_tidal_spec(n_steps=10, save_every=5), kernels)
    want = _port(full, tmp_path / "full")
    _port(half, tmp_path / "a")
    got = _port(half, tmp_path / "b",
                resume_from=str(tmp_path / "a" / "final_state.npz"))
    np.testing.assert_array_equal(want["time"][2:], got["time"])
    for f in FIELDS:
        np.testing.assert_array_equal(want[f][2:], got[f], err_msg=f)
    a = np.load(tmp_path / "full" / "final_state.npz")
    b = np.load(tmp_path / "b" / "final_state.npz")
    for name in a.files:
        if name != "__msgwam_manifest__":      # holds each run's own spec
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_stream_history_reads_back(tmp_path, mxu_run):
    """``--log-every 5 --stream-history``: the streamed file holds every
    saved frame, its u, v equal diagnostics.npz's, and the diagnostics
    equal the unchunked run's."""
    got = _port(_spec(kernels="mxu"), tmp_path, log_every=5,
                stream_history=True)
    hist = read_state_history(tmp_path / "state_history.msgw")
    assert hist["dens"].shape == (4, 512)
    assert hist["active"].dtype == bool and hist["active"].all()
    np.testing.assert_array_equal(hist["u"], got["u"])
    np.testing.assert_array_equal(hist["v"], got["v"])
    for f in FIELDS:
        np.testing.assert_array_equal(mxu_run[f], got[f], err_msg=f)


@pytest.mark.parametrize("kernels", ["pallas", "windowed", "mega"])
def test_float64_with_a_kernel_route_raises(tmp_path, kernels):
    """The CUDA kernels compute in float32: a float64 spec with a kernel
    route raises and names the plain routes; it does not fall back."""
    ns = argparse.Namespace(config=None, preset="reference", steps=2,
                            kernels=kernels, window2=None)
    with pytest.raises(ValueError, match="float32.*--kernels xla\\|mxu"):
        tcli.run_experiment(tcli._load_config(ns), str(tmp_path),
                            device="cpu")
    assert not os.listdir(tmp_path)


def test_shard_and_no_card_raise(tmp_path):
    """``--shard`` refuses a transient background, as msgwam_tpu does;
    without ``--device`` the run (sharded or not) goes to the card, and
    where there is none it raises instead of running on the CPU."""
    path = tmp_path / "tidal.json"
    path.write_text(json.dumps(_tidal_spec()))
    with pytest.raises(ValueError, match="--shard does not support transient"):
        tcli.main(["run", "--config", str(path), "--device", "cpu", "--shard",
                   "--no-plot", "--out", str(tmp_path / "t")])
    assert not torch.distributed.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for shard in ([], ["--shard"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["run", "--preset", "reference", "--steps", "2",
                       "--no-plot", "--out", str(tmp_path / "c"), *shard])
    assert not os.path.exists(tmp_path / "c")


def _shard_spec():
    """The reference preset on the mxu route, 20 steps of 64 rays: a ray
    count that divides over msgwam_tpu's 8 devices and over 1 or 2 ranks.
    (msgwam_tpu's sharded run fails on the xla route: its diagnostics'
    scatter cannot resolve the sharded history's layout.)"""
    spec = _loaded(jcli.PRESETS["reference"], "mxu")
    spec["run"].update(n_steps=20, save_every=5)
    spec["source"]["n_ray"] = 64
    return spec


@pytest.fixture(scope="module")
def shard_one(tmp_path_factory):
    """``--shard`` as a world of 1 in this process, in float64: its
    diagnostics and final state."""
    out = tmp_path_factory.mktemp("shard1")
    got = _port(_shard_spec(), out, shard=True)
    assert not torch.distributed.is_initialized()
    return got, dict(np.load(out / "final_state.npz"))


def test_shard_world_of_one_matches_jax_shard(tmp_path, shard_one):
    """``--shard --kernels mxu`` in float64 as a world of 1 against
    msgwam_tpu's ``run_experiment(shard=True)`` over its 8 devices: the
    diagnostics and the final state at 1e-12."""
    spec = _shard_spec()
    want = _jax(spec, tmp_path / "j", shard=True)
    got, state = shard_one
    _assert_close(want, got, 1e-12)
    jstate = np.load(tmp_path / "j" / "final_state.npz")
    for name in jstate.files:
        if name.startswith(("rays.", "mean.")):
            assert _rel(jstate[name], state[name]) <= 1e-12, name


def test_shard_over_two_ranks_under_torchrun(tmp_path, shard_one):
    """``torchrun --nproc_per_node 2 -m msgwam_tpu_torch run --shard
    --device cpu``: two gloo ranks, rank 0 alone writes and prints; the
    diagnostics and the final state within 1e-12 of the world of 1."""
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(_shard_spec()))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "msgwam_tpu_torch", "run", "--shard",
         "--device", "cpu", "--config", str(path), "--no-plot", "--out",
         str(tmp_path / "t")],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("rays split over 2 rank(s)") == 1
    assert out.stdout.count('"checkpoint"') == 1
    want, state = shard_one
    _assert_close(want, dict(np.load(tmp_path / "t" / "diagnostics.npz")),
                  1e-12)
    got = np.load(tmp_path / "t" / "final_state.npz")
    for name in got.files:
        if name.startswith(("rays.", "mean.")):
            assert _rel(state[name], got[name]) <= 1e-12, name


def test_shard_demotes_mega(tmp_path, capsys):
    """``--kernels mega --shard`` prints the fallback, as msgwam_tpu does,
    and runs the sharded scan path through K4 (its twin here): a world of
    1 equal to the unsharded ``--kernels windowed`` run."""
    got = _port(_spec(kernels="mega"), tmp_path / "m", shard=True)
    printed = capsys.readouterr().out
    assert "falling back" in printed and "--shard uses the scan path" in printed
    assert "rays split over 1 rank(s)" in printed
    want = _port(_spec(kernels="windowed"), tmp_path / "w")
    _assert_close(want, got, 1e-12)


def test_python_m_run(tmp_path):
    """``python -m msgwam_tpu_torch run`` writes the checkpoint, the
    diagnostics and the figure, and prints the result as JSON."""
    env = dict(os.environ, MPLBACKEND="Agg")
    out = subprocess.run(
        [sys.executable, "-m", "msgwam_tpu_torch", "run", "--preset",
         "reference", "--steps", "4", "--device", "cpu", "--out",
         str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert os.path.isfile(result["checkpoint"])
    assert os.path.isfile(result["figure"])
    d = np.load(tmp_path / "diagnostics.npz")
    assert d["wave_action"].shape == (4, 100)
    assert np.all(np.isfinite(d["wave_action"]))
