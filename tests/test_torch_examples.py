"""The port's examples (``msgwam_tpu_torch.examples``) against the JAX
examples (``examples/*.py``, loaded by path and left as they are) at cut
sizes on the CPU, on the same inputs: float32 runs within 1e-4 of the
maximum over at most 30 steps, float64 runs within 1e-9, the inversion's
optimizer within 1e-12 of the optax chain on 150 seeded gradients.  Where
the JAX example's work sits in ``main``, the test runs that ``main`` with
cut flags and compares what it writes or plots (``critical_level_relaunch``,
``reference_experiment``), or rebuilds its few lines from ``msgwam_tpu``
calls (``megakernel_day``).  Every example imports with jax blocked and,
without ``--device`` and without a card, fails naming the card."""

import importlib
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu.api as jshim
import msgwam_tpu_torch as mtt
import msgwam_tpu_torch.api as tshim
from msgwam_tpu_torch.examples import (config_ladder, critical_level_relaunch,
                                       megakernel_day, reference_experiment,
                                       source_inversion)
from msgwam_tpu_torch.utils.history_io import read_history

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_BAR = 1e-4        # float32, <= 30 steps, relative to the maximum
F64_BAR = 1e-9         # float64 runs, relative to the maximum
OPT_BAR = 1e-12        # the optimizer against the optax chain
EXAMPLES = ("megakernel_day", "config_ladder", "critical_level_relaunch",
            "reference_experiment", "source_inversion")
CUT_ARGS = {
    "megakernel_day": ["--n-ray", "256", "--steps", "4", "--save-every", "2"],
    "config_ladder": [],
    "critical_level_relaunch": ["--nray", "64", "--hours", "1"],
    "reference_experiment": ["--steps", "4"],
    "source_inversion": ["--iters", "1"],
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30))


def _jax_example(name):
    """``examples/<name>.py`` as a fresh module."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_without_jax(name):
    code = ("import sys\n"
            "for m in ('jax', 'optax', 'msgwam_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"import msgwam_tpu_torch.examples.{name}\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_device_names_the_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"msgwam_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(CUT_ARGS[name])


# ---------------------------------------------------------------------------
# megakernel_day: simulate_resident on the bench population
# ---------------------------------------------------------------------------

def test_megakernel_day_matches_jax(tmp_path):
    """examples/megakernel_day.py:41-64 rebuilt at 1024 rays, 20 steps
    (Pallas in interpret mode), against the port's main on the CPU (K5's
    twin); the port's --plot writes its figure."""
    n, steps, every = 1024, 20, 10
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(
        cfg, bg, n, z_launch=2000.0, dz_launch=500.0,
        amplitude_alpha=0.003, dtype=jnp.float32,
    )
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    run = mt.RunConfig(dt=120.0, n_steps=steps, save_every=every)
    want, _, _ = mt.simulate_resident(state, statics, bg, cfg, run)

    plot = tmp_path / "panels.png"
    got = megakernel_day.main(["--n-ray", str(n), "--steps", str(steps),
                               "--save-every", str(every), "--device", "cpu",
                               "--plot", str(plot)])
    assert plot.exists()
    assert got["history"][0].rays.r.shape == (steps // every, n)
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), getattr(got["final"].rays, f)) \
            < TRAJ_BAR, f
    assert _rel(want.mean.u, got["final"].mean.u) < TRAJ_BAR


# ---------------------------------------------------------------------------
# config_ladder: configs 1, 2 and 5 at 256 rays, 24 steps (config 5: 6)
# ---------------------------------------------------------------------------

@pytest.fixture
def ladders(monkeypatch):
    jax_cl = _jax_example("config_ladder")
    for mod in (jax_cl, config_ladder):
        monkeypatch.setattr(mod, "N_RAY", 256)
        monkeypatch.setattr(mod, "N_STEPS", 24)
    return jax_cl, config_ladder


def test_config_1_matches_jax(ladders):
    jax_cl, cl = ladders
    want, got = jax_cl.config_1_fixed_background(), \
        cl.config_1_fixed_background("cpu")
    assert want.shape == got.shape == (12, 100)
    assert _rel(want, got) < TRAJ_BAR


def test_config_2_matches_jax(ladders):
    jax_cl, cl = ladders
    want, got = jax_cl.config_2_coupled(), cl.config_2_coupled("cpu")
    assert want.shape == got.shape == (2, 100)
    assert _rel(want, got) < TRAJ_BAR
    assert _rel(want[1] - want[0], got[1] - got[0]) < TRAJ_BAR


def test_config_5_matches_jax(ladders):
    """The ensemble on the same members: JAX's PRNGKey(i) draws handed to
    the port through ``draw``; JAX shards the members over its 8 virtual
    devices, the port runs them in turn (``scan``)."""
    jax_cl, cl = ladders
    jcfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    _, jbg, _ = jax_cl.base_setup(jcfg)

    def jax_draw(i, cfg, bg):
        return mtt.from_numpy(mt.gaussian_spectrum_source(
            jcfg, jbg, cl.N_RAY // 4, z_launch=4000.0, dz_launch=2000.0,
            amplitude_alpha=0.01, key=jax.random.PRNGKey(i),
            dtype=jnp.float32), device="cpu")

    want = jax_cl.config_5_ensemble()
    got = cl.config_5_ensemble("cpu", draw=jax_draw)
    assert want.shape == got.shape == (8, 100)
    assert _rel(want, got) < TRAJ_BAR


def test_config_5_default_members_are_keyed():
    """The default members come from host Generators seeded 0-7: the same
    draws on any device, and different members."""
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(dtype="float32")
    _, bg, _ = config_ladder.base_setup(cfg, "cpu")
    a = config_ladder.keyed_member(3, cfg, bg)
    b = config_ladder.keyed_member(3, cfg, bg)
    c = config_ladder.keyed_member(4, cfg, bg)
    assert torch.equal(a[0].m, b[0].m) and torch.equal(a[0].r, b[0].r)
    assert not torch.equal(a[0].m, c[0].m)


# ---------------------------------------------------------------------------
# critical_level_relaunch: two chunks of 30 steps, t0 of each
# ---------------------------------------------------------------------------

def test_critical_level_relaunch_matches_jax(tmp_path, monkeypatch):
    jax_cr = _jax_example("critical_level_relaunch")
    flags = ["--nray", "256", "--hours", "2"]
    monkeypatch.setattr(sys, "argv", ["critical_level_relaunch.py", *flags,
                                      "--out", str(tmp_path / "jax")])
    jax_cr.main()
    want = read_history(tmp_path / "jax" / "wa_history.msgw")
    got = critical_level_relaunch.main(
        [*flags, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert want.shape == got["history"].shape == (2, 2, 99)
    np.testing.assert_array_equal(got["history"], got["pushed"])
    for c in range(2):
        assert _rel(want[c], got["history"][c]) < TRAJ_BAR, c


# ---------------------------------------------------------------------------
# reference_experiment: the shim's run in float64
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_shims():
    """Both shims' module state restored after the test."""
    shims = (jshim, tshim)
    saved = [(dict(m.model_config), dict(m.statics), m.HPROP_GLOBAL, m.grid,
              m.grids, m.rhobar, m.pressure_gradient) for m in shims]
    device = tshim.DEVICE
    yield
    tshim.DEVICE = device
    for m, (mc, st, hprop, grid, grids, rhobar, pg) in zip(shims, saved):
        m.model_config.clear()
        m.model_config.update(mc)
        m.statics.clear()
        m.statics.update(st)
        (m.HPROP_GLOBAL, m.grid, m.grids, m.rhobar,
         m.pressure_gradient) = hprop, grid, grids, rhobar, pg


def test_reference_experiment_matches_jax(fresh_shims, tmp_path, monkeypatch):
    """The JAX example's main over 20 steps, its figure's arrays captured
    from ``plot_wave_action_panels``, against the port's main with
    ``--device cpu`` (and its --plot)."""
    jax_re = _jax_example("reference_experiment")
    plotted = {}

    def capture(time, grids, wa, tendency, **kw):
        plotted.update(time=time, grids=grids, wa=wa, tendency=tendency, **kw)

    monkeypatch.setattr(jax_re, "plot_wave_action_panels", capture)
    monkeypatch.setattr(sys, "argv", ["reference_experiment.py", "--steps",
                                      "20", "--out", str(tmp_path / "j.png")])
    jax_re.main()
    plot = tmp_path / "port.png"
    got = reference_experiment.main(["--steps", "20", "--device", "cpu",
                                     "--plot", str(plot)])
    assert plot.exists()
    assert plotted["wa"].shape == got["wa"].shape == (16, 100)
    np.testing.assert_array_equal(plotted["time"], got["time"][:16])
    np.testing.assert_array_equal(plotted["grids"], got["grids"])
    assert plotted["plot_max_s"] == got["plot_max_s"]
    assert _rel(plotted["wa"], got["wa"]) < F64_BAR
    assert _rel(plotted["tendency"], got["tendency"]) < F64_BAR


# ---------------------------------------------------------------------------
# source_inversion: the forward problem and the optimizer
# ---------------------------------------------------------------------------

def test_source_inversion_problem_matches_jax(monkeypatch):
    """``hidden_pattern`` and ``simulate_wind`` at the sizes of
    tests/test_source_inversion.py (100 rays, 60 steps, 6 frames), float64,
    at the truth and at the unmodulated source."""
    jax_si = _jax_example("source_inversion")
    for mod in (jax_si, source_inversion):
        monkeypatch.setattr(mod, "N_RAY", 100)
        monkeypatch.setattr(mod, "N_STEPS", 60)
        monkeypatch.setattr(mod, "N_FRAMES", 6)
    truth = np.asarray(jax_si.hidden_pattern(100))
    got_truth = source_inversion.hidden_pattern(100, "cpu")
    np.testing.assert_allclose(got_truth.numpy(), truth, rtol=1e-15, atol=1e-15)
    want_fn = jax_si.build_problem()
    got_fn = source_inversion.build_problem("cpu")
    for log_amp in (truth, np.zeros(100)):
        want = np.asarray(want_fn(jnp.asarray(log_amp)))
        with torch.no_grad():
            got = got_fn(torch.from_numpy(log_amp.copy())).numpy()
        assert want.shape == got.shape == (6, 100)
        assert _rel(want, got) < F64_BAR


def test_source_inversion_optimizer_matches_optax():
    """The port's clip, Adam and cosine schedule against
    ``optax.chain(clip_by_global_norm(10), adam(cosine_decay_schedule(0.5,
    150, alpha=0.05)))`` on the same 150 seeded gradients, some above the
    clip norm and some below."""
    optax = pytest.importorskip("optax")
    rng = np.random.default_rng(0)
    grads = rng.normal(size=(150, 200)) * rng.uniform(0.1, 2.0, (150, 1))
    assert (np.linalg.norm(grads, axis=1) > 10).any()
    assert (np.linalg.norm(grads, axis=1) < 10).any()

    sched = optax.cosine_decay_schedule(0.5, 150, alpha=0.05)
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(sched))
    want = jnp.zeros(200)
    opt_state = opt.init(want)
    params = torch.zeros(200, dtype=torch.float64, requires_grad=True)
    topt, tsched = source_inversion.make_optimizer([params])
    for t, g in enumerate(grads):
        np.testing.assert_allclose(
            source_inversion.LR * source_inversion.cosine_decay(t),
            float(sched(t)), rtol=1e-15)
        updates, opt_state = opt.update(jnp.asarray(g), opt_state)
        want = optax.apply_updates(want, updates)
        params.grad = torch.from_numpy(g.copy())
        source_inversion.optimizer_step([params], topt, tsched)
        np.testing.assert_allclose(params.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=OPT_BAR)
