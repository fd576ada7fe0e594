"""K4 (the windowed kernel with the RK3 stage fused in) and the slice as a
whole against msgwam_tpu: ``simulate`` with ``rhs_backend="pallas"`` and a
nonzero ``window_cells`` (the default -1 included) takes the stage-fused
step on both sides, at the bar of tests/test_windowed.py (5e-5 after 4
steps; the Pallas kernel runs in interpret mode on one 8192-ray block)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.models import integrate
from msgwam_tpu_torch.ops import ray_physics, rhs_cuda, rhs_cuda_windowed

torch.set_num_threads(1)


def _setup(n, pad_to, spread=None, **cfg_kw):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32",
        "projection_backend": "mxu", "interp_backend": "mxu", **cfg_kw,
    })
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(cfg, bg, n, dtype=jnp.float32)
    if spread is not None:
        r = np.sort(np.linspace(spread[0], spread[1], n).astype(np.float32))
        rays = rays._replace(r=jnp.asarray(r))
    rays, statics = mt.pad_rays(rays, statics, pad_to)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def _tcfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def _trun(run):
    return mtt.RunConfig(**dataclasses.asdict(run))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


def _assert_close(want, got, tol):
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < tol, f
    assert _rel(want.mean.u, got.mean.u) < tol


class _Spy:
    """Counts the calls of the kernel entry points the port's step takes."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for module, name in ((rhs_cuda_windowed, "rk3_step_fused_windowed"),
                             (rhs_cuda_windowed, "rhs_fused_windowed"),
                             (rhs_cuda, "rhs_fused")):
            monkeypatch.setattr(module, name, self._wrap(name, getattr(module, name)))

    def _wrap(self, name, fn):
        def spy(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **kw)
        return spy


def test_k4_trajectory_matches_msgwam_tpu(monkeypatch):
    """4 steps with ``window_cells=32``: the stage-fused step of both
    packages, and ``rk3_step`` takes K4 (not K2, not the generic
    integrator over K3)."""
    cfg, bg, state, statics = _setup(4000, 8192, spread=(2e3, 12e3))
    cfgw = cfg.replace(rhs_backend="pallas", window_cells=32)
    run = mt.RunConfig(dt=120.0, n_steps=4, save_every=4)
    want, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfgw, run))(
        state, statics)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    spy = _Spy(monkeypatch)
    got, _, _ = mtt.simulate(s, st, b, _tcfg(cfgw), _trun(run))
    assert spy.calls == {"rk3_step_fused_windowed": 4}
    _assert_close(want, got, 5e-5)
    # the caller's state is left as it was, frozen fields are untouched
    np.testing.assert_array_equal(s.rays.r.numpy(), np.asarray(state.rays.r))
    assert got.rays.k is s.rays.k and got.rays.dr is s.rays.dr


@pytest.mark.parametrize("prognostic", [True, False])
@pytest.mark.parametrize("online", [True, False])
def test_k4_twin_modes_match_msgwam_tpu(online, prognostic):
    """The K4 twin (the wind updated as the kernel's tail does, the flux
    summed by the kernel's block plan) against msgwam_tpu's stage-fused
    step over 4 steps, online and offline saturation, with the
    prognostic wind and without."""
    cfg, bg, state, statics = _setup(4000, 8192, spread=(2e3, 12e3),
                                     saturate_online=online,
                                     prognostic_mean=prognostic)
    cfgw = cfg.replace(rhs_backend="pallas", window_cells=-1)
    run = mt.RunConfig(dt=120.0, n_steps=4, save_every=4)
    want, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfgw, run))(
        state, statics)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    got, _, _ = mtt.simulate(s, st, b, _tcfg(cfgw), _trun(run))
    _assert_close(want, got, 5e-5)
    assert _rel(want.mean.v, got.mean.v) < 5e-5
    if not prognostic:
        assert torch.equal(got.mean.u, s.mean.u)


@pytest.mark.parametrize("online", [True, False])
def test_k4_twin_matches_the_generic_step(online):
    """One stage-fused step against the generic RK3 over the same RHS
    (K3's twin), online and offline, and against the composable path."""
    cfg, bg, state, statics = _setup(1500, 2048, saturate_online=online)
    tcfg = _tcfg(cfg.replace(rhs_backend="pallas", window_cells=24))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    fused = rhs_cuda_windowed.rk3_step_fused_windowed(120.0, s, st, b, tcfg)
    twin = rhs_cuda_windowed.rk3_step_fused_windowed_reference(120.0, s, st, b,
                                                               tcfg)
    for f in ("dens", "r", "m"):
        assert torch.equal(getattr(fused.rays, f), getattr(twin.rays, f))
    generic = integrate.williamson_rk3(
        lambda y: integrate.rhs_default(120.0, y, st, b, tcfg), s, 120.0)
    _assert_close(generic, fused, 1e-5)
    plain = integrate.rk3_step(120.0, s, st, b, _tcfg(cfg))
    _assert_close(plain, fused, 2e-5)


def test_default_window_slice_matches_msgwam_tpu():
    """The slice as a user runs it: ``rhs_backend="pallas"``, the default
    ``window_cells=-1`` (the 16-cell floor on both sides) and float32
    through ``simulate``, 5 steps and the history, against msgwam_tpu."""
    cfg, bg, state, statics = _setup(500, 1024)
    cfgp = cfg.replace(rhs_backend="pallas")
    assert cfgp.window_cells == -1
    run = mt.RunConfig(dt=120.0, n_steps=5, save_every=5)
    want, _, whist = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfgp, run))(
        state, statics)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    got, _, hist = mtt.simulate(s, st, b, _tcfg(cfgp), _trun(run))
    assert got.rays.r.dtype == torch.float32
    _assert_close(want, got, 1e-4)
    assert _rel(whist[2], hist[2]) < 1e-4
    np.testing.assert_array_equal(got.rays.r[500:].numpy(),
                                  np.asarray(state.rays.r[500:]))


def test_windowed_route_refuses_float64_and_axis_name():
    """K4 follows K2: a float64 state raises instead of a silent cast;
    an axis name that is not a ProcessGroup (JAX's mesh-axis string) raises
    too."""
    cfg, bg, state, statics = _setup(100, 256)
    run = mtt.RunConfig(dt=120.0, n_steps=1, save_every=1)
    s64, st64, b64 = mtt.from_numpy((state, statics, bg), dtype="float64", device="cpu")
    tcfg = _tcfg(cfg.replace(rhs_backend="pallas", dtype="float64"))
    with pytest.raises(TypeError, match="float32"):
        mtt.simulate(s64, st64, b64, tcfg, run)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    with pytest.raises(TypeError, match="axis_name must be the ProcessGroup"):
        integrate.rk3_step(120.0, s, st, b, _tcfg(cfg.replace(
            rhs_backend="pallas")), axis_name="rays")


def test_rk4_runs_k3_four_times_a_step(monkeypatch):
    """The generic integrators take the windowed RHS (K3), not K4: 4
    evaluations per rk4 step, on the composable path's trajectory."""
    cfg, bg, state, statics = _setup(1500, 2048, integrator="rk4")
    run = mtt.RunConfig(dt=120.0, n_steps=3, save_every=3)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    spy = _Spy(monkeypatch)
    got, _, _ = mtt.simulate(s, st, b, _tcfg(cfg.replace(rhs_backend="pallas")),
                             run)
    assert spy.calls == {"rhs_fused_windowed": 12}
    plain, _, _ = mtt.simulate(s, st, b, _tcfg(cfg), run)
    _assert_close(plain, got, 1e-4)


def test_k4_twin_block_plan_changes_only_rounding():
    """The flux's block plan orders float64 sums only: the twin's step on
    another card's plan (one SM, four blocks) agrees with the H100's to
    float32 rounding."""
    cfg, bg, state, statics = _setup(1500, 2048, spread=(2e3, 30e3))
    tcfg = _tcfg(cfg.replace(rhs_backend="pallas"))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    h100 = rhs_cuda_windowed.rk3_step_fused_windowed_reference(120.0, s, st, b,
                                                               tcfg)
    small = ray_physics.stage_plan(2048, 99, sms=1)
    assert small.blocks == 4
    other = rhs_cuda_windowed.rk3_step_fused_windowed_reference(
        120.0, s, st, b, tcfg, plan=small)
    _assert_close(h100, other, 1e-6)
