"""The port's whole time loop against msgwam_tpu.simulate: the float32
fused-kernel trajectory (K2's twin on CPU) and the float64 reference
experiment."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.ops.dispersion import cg_r as jax_cg_r
from msgwam_tpu.ops.projection import project as jax_project
from msgwam_tpu_torch.ops.dispersion import cg_r as torch_cg_r
from msgwam_tpu_torch.ops.projection import project as torch_project

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300)


def _tcfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def _trun(run):
    return mtt.RunConfig(**dataclasses.asdict(run))


def _f32_setup(n=500, pad_to=1024):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(cfg, bg, n, dtype=jnp.float32)
    rays, statics = mt.pad_rays(rays, statics, pad_to)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def test_fused_step_trajectory_matches_msgwam_tpu():
    """5 RK3 steps with ``rhs_backend="pallas", window_cells=0`` on both
    sides (the Pallas kernel in interpret mode; K2's twin in the port), at
    the bar of tests/test_rhs_fused.py::test_fused_step_trajectory."""
    cfg, bg, state, statics = _f32_setup()
    cfgp = cfg.replace(rhs_backend="pallas", window_cells=0)
    run = mt.RunConfig(dt=120.0, n_steps=5, save_every=5)
    want, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfgp, run))(
        state, statics)
    s, st, b = mtt.from_numpy((state, statics, bg))
    got, _, hist = mtt.simulate(s, st, b, _tcfg(cfgp), _trun(run))
    assert got.rays.r.dtype == torch.float32
    assert _rel(want.rays.r, got.rays.r) < 1e-4
    assert _rel(want.rays.m, got.rays.m) < 1e-4
    assert _rel(want.rays.dens, got.rays.dens) < 1e-4
    assert _rel(want.mean.u, got.mean.u) < 1e-4
    # padded slots stayed frozen, frozen fields untouched
    np.testing.assert_array_equal(got.rays.r[500:].numpy(),
                                  np.asarray(state.rays.r[500:]))
    assert got.rays.k is s.rays.k and got.rays.dr is s.rays.dr
    # the composable port path lands on the same trajectory
    plain, _, _ = mtt.simulate(s, st, b, _tcfg(cfg.replace(
        flux_accum="compensated")), _trun(run))
    assert _rel(plain.rays.r, got.rays.r) < 1e-4
    assert _rel(plain.mean.u, got.mean.u) < 1e-4


def _reference_setup():
    cfg = mt.REFERENCE_RUN_CONFIG
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(gc.centers()), cfg))
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu))
    rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=60)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def _flux_profile(project, cg_r, s, st, bg, cfg, lib):
    rays = s.rays
    cgr = cg_r(rays.k, rays.l, rays.m, rays.phi, cfg.bvf)
    vals = lib.stack([cgr * rays.k * rays.dens, cgr * rays.l * rays.dens])
    pv = abs(st.dkk * st.dll * rays.dm)
    return np.asarray(project(vals, rays.r - 0.5 * rays.dr,
                              rays.r + 0.5 * rays.dr, pv, st.active,
                              bg.centers, cfg.max_span))


def _reference_experiment(n_steps, flux_bar, field_bar):
    cfg, bg, state, statics = _reference_setup()
    run = mt.RunConfig(dt=120.0, n_steps=n_steps, save_every=10)
    want, wst, whist = mt.simulate(state, statics, bg, cfg, run, include_t0=True)
    s, st, b = mtt.from_numpy((state, statics, bg))
    got, gst, ghist = mtt.simulate(s, st, b, _tcfg(cfg), _trun(run),
                                   include_t0=True)
    for f in want.rays._fields:
        assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < field_bar, f
    assert _rel(want.mean.u, got.mean.u) < field_bar
    # v is roundoff-scale in this run: compare it absolutely
    assert np.max(np.abs(np.asarray(want.mean.v) - got.mean.v.numpy())) < 1e-15
    fw = _flux_profile(jax_project, jax_cg_r, want, wst, bg, cfg, jnp)
    fg = _flux_profile(torch_project, torch_cg_r, got, gst, b, cfg, torch)
    assert _rel(fw, fg) < flux_bar
    # same history layout: (state, active, dens_prop), n_steps/10 + 1 frames
    assert jax.tree.structure(whist).num_leaves == 9 + 2 + 2
    assert tuple(ghist[0].rays.r.shape) == np.asarray(whist[0].rays.r).shape
    assert tuple(ghist[2].shape) == np.asarray(whist[2]).shape
    assert _rel(whist[2], ghist[2]) < field_bar
    np.testing.assert_array_equal(ghist[1].numpy(), np.asarray(whist[1]))


def test_reference_experiment_100_steps_f64():
    """The reference experiment (60 rays, offline saturation, xla/gather
    backends, float64) for 100 steps: every field and the flux profile
    within 1e-9 of msgwam_tpu relative to the maximum."""
    _reference_experiment(100, flux_bar=1e-9, field_bar=1e-9)


@pytest.mark.slow
def test_reference_experiment_full_run_f64():
    """The full 1440-step reference experiment, at ROADMAP's bar of 1e-8
    on the flux profile."""
    _reference_experiment(1440, flux_bar=1e-8, field_bar=1e-8)


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_other_integrators_match(integrator):
    cfg, bg, state, statics = _reference_setup()
    cfg = cfg.replace(integrator=integrator, saturate_online=True)
    run = mt.RunConfig(dt=120.0, n_steps=10, save_every=5)
    want, _, _ = mt.simulate(state, statics, bg, cfg, run)
    s, st, b = mtt.from_numpy((state, statics, bg))
    got, _, hist = mtt.simulate(s, st, b, _tcfg(cfg), _trun(run))
    assert hist[0].rays.r.shape == (2, 60)
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < 1e-12, f
    assert _rel(want.mean.u, got.mean.u) < 1e-12


def test_unported_options_raise_and_inputs_are_validated():
    cfg, bg, state, statics = _reference_setup()
    s, st, b = mtt.from_numpy((state, statics, bg))
    tcfg, run = _tcfg(cfg), mtt.RunConfig(dt=120.0, n_steps=2, save_every=1)
    for kw in (dict(source=(s.rays, st)), dict(wind_fn=lambda t: (0.0, 0.0)),
               dict(sort_every=10), dict(remat=True), dict(axis_name="rays")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mtt.simulate(s, st, b, tcfg, run, **kw)
    with pytest.raises(NotImplementedError):
        mtt.simulate(s, st, b, tcfg.replace(cull=True), run)
    with pytest.raises(TypeError, match="dtype"):
        mtt.simulate(s, st, b, tcfg.replace(dtype="float32"), run)
    with pytest.raises(ValueError, match="max_span"):
        mtt.simulate(s, st, b, tcfg.replace(max_span=1), run)
    with pytest.raises(ValueError, match="divisible"):
        mtt.simulate(s, st, b, tcfg, mtt.RunConfig(dt=120.0, n_steps=3,
                                                   save_every=2))
