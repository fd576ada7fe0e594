"""K5 (``simulate_resident``, whole RK3 steps per launch) against
msgwam_tpu's ``simulate_resident`` (the Pallas kernel in interpret mode,
900 rays padded to 1024, 9 steps, ``save_every=3``) at the bar of
tests/test_megakernel.py (3e-5 relative to the maximum), with its history
framing and guard rails; K5's twin runs on CPU tensors."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.ops.step_pallas import simulate_resident as jax_resident
from msgwam_tpu_torch.ops import step_cuda

torch.set_num_threads(1)

TOL = 3e-5


@pytest.fixture
def cuda_device():
    """The card, for the tests that run a CUDA kernel; they skip without
    one (decided here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _setup(n=900, pad_to=1024, dens_scale=1.0, **cfg_kw):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32",
        "projection_backend": "mxu", "interp_backend": "mxu", **cfg_kw,
    })
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(cfg, bg, n, dtype=jnp.float32)
    rays = rays._replace(dens=rays.dens * dens_scale)
    rays, statics = mt.pad_rays(rays, statics, pad_to)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def _tcfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


RUN = mt.RunConfig(dt=120.0, n_steps=9, save_every=3)
TRUN = mtt.RunConfig(dt=120.0, n_steps=9, save_every=3)
MODES = {
    "online": dict(),
    "offline_faithful_rates": dict(saturate_online=False, dens_scale=50.0),
    "offline_corrected_rates": dict(saturate_online=False, dens_scale=50.0,
                                    faithful_offline_rates=False),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_k5_matches_msgwam_tpu(mode):
    """Online saturation, and offline (the density amplified so that the
    cap clamps) with faithful and corrected height rates: trajectory,
    history frames and the pre-saturation ``dens_prop``."""
    cfg, bg, state, statics = _setup(**MODES[mode])
    want, _, whist = jax_resident(state, statics, bg, cfg, RUN)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    got, gst, hist = mtt.simulate_resident(s, st, b, _tcfg(cfg), TRUN)
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < TOL, f
    assert _rel(want.mean.u, got.mean.u) < TOL
    assert gst is st
    # frozen fields pass through untouched; the input state is not modified
    assert got.rays.k is s.rays.k and got.rays.phi is s.rays.phi
    np.testing.assert_array_equal(s.rays.r.numpy(), np.asarray(state.rays.r))
    wstate, wact, wprop = whist
    hstate, hact, hprop = hist
    assert tuple(hstate.rays.dens.shape) == np.asarray(wstate.rays.dens).shape
    np.testing.assert_array_equal(hact.numpy(), np.asarray(wact))
    for t in range(3):
        assert _rel(wstate.rays.r[t], hstate.rays.r[t]) < TOL
        assert _rel(wstate.mean.u[t], hstate.mean.u[t]) < TOL
        assert _rel(wprop[t], hprop[t]) < TOL


def test_k5_offline_clamp_fires():
    """The in-kernel offline cap changes the density: an effectively
    uncapped run (kappa huge) ends elsewhere."""
    cfg, bg, state, statics = _setup(dens_scale=50.0, saturate_online=False)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    tcfg = _tcfg(cfg)
    capped, _, hist = mtt.simulate_resident(s, st, b, tcfg, TRUN)
    free, _, _ = mtt.simulate_resident(s, st, b, tcfg.replace(kappa=1e9), TRUN)
    assert not torch.equal(capped.rays.dens, free.rays.dens)
    assert not torch.equal(hist[2][-1], capped.rays.dens)   # pre-cap density


def test_k5_include_t0_and_observe():
    cfg, bg, state, statics = _setup(n=300, pad_to=512)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    tcfg, run = _tcfg(cfg), mtt.RunConfig(dt=120.0, n_steps=4, save_every=2)
    final, _, hist = mtt.simulate_resident(s, st, b, tcfg, run, include_t0=True)
    assert hist[0].rays.r.shape == (3, 512)      # t0 + 2 save points
    assert torch.equal(hist[0].rays.r[0], s.rays.r)
    assert torch.equal(hist[0].rays.r[2], final.rays.r)
    assert torch.equal(hist[2][0], s.rays.dens)

    def observe(state_, statics_, aux):
        return (state_.mean.u, aux.dens_prop.sum())

    _, _, obs = mtt.simulate_resident(s, st, b, tcfg, run, include_t0=True,
                                      observe=observe)
    assert obs[0].shape == (3, 100) and obs[1].shape == (3,)
    np.testing.assert_array_equal(obs[0].numpy(), hist[0].mean.u.numpy())
    # the same run through simulate's own loop frames the same way
    _, _, sim_obs = mtt.simulate(s, st, b, tcfg.replace(rhs_backend="pallas"),
                                 run, include_t0=True, observe=observe)
    assert _rel(sim_obs[0].numpy(), obs[0].numpy()) < TOL


def test_k5_guard_rails():
    cfg, bg, state, statics = _setup(n=300, pad_to=512)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    tcfg, run = _tcfg(cfg), mtt.RunConfig(dt=120.0, n_steps=4, save_every=2)
    with pytest.raises(ValueError, match="hprop"):
        mtt.simulate_resident(s, st, b, tcfg.replace(hprop=True), run)
    # the lifecycle and wind_fn take K6's route, with its own guards
    with pytest.raises(ValueError, match="source template"):
        mtt.simulate_resident(s, st, b, tcfg.replace(relaunch=True), run)
    for kw, over in ((dict(cull=True), {}), ({}, dict(wind_fn=lambda t: (0.0, 0.0)))):
        step_cuda.LAUNCHES = 0
        _, got_st, hist = mtt.simulate_resident(s, st, b, tcfg.replace(**kw), run,
                                                **over)
        assert step_cuda.LAUNCHES == 0 and hist[1].shape == (2, 512)
    s64, st64, b64 = mtt.from_numpy((state, statics, bg), dtype="float64", device="cpu")
    with pytest.raises(TypeError, match="float32"):
        mtt.simulate_resident(s64, st64, b64, tcfg.replace(dtype="float64"), run)
    with pytest.raises(ValueError, match="divisible"):
        mtt.simulate_resident(s, st, b, tcfg,
                              mtt.RunConfig(dt=120.0, n_steps=3, save_every=2))


def test_k5_deposit_accuracy_vs_f64_oracle():
    """One prognostic step at 4096 rays (16 tiles): with phi0 = 0 the wind
    increment is a pure flux observable, within 1e-6 of the float64
    composable path of msgwam_tpu (tests/test_megakernel.py:129-153)."""
    cfg, bg, state, statics = _setup(n=4096, pad_to=4096)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    run = mtt.RunConfig(dt=120.0, n_steps=1, save_every=1)
    got, _, _ = mtt.simulate_resident(s, st, b, _tcfg(cfg), run)
    du32 = got.mean.u.double().numpy() - np.asarray(state.mean.u, np.float64)

    cfg64 = cfg.replace(dtype="float64", projection_backend="xla",
                        interp_backend="gather", rhs_backend="xla",
                        window_cells=0)
    uu64 = np.asarray(state.mean.u, np.float64)
    bg64 = mt.make_background(mt.GridConfig(), cfg64, uu64, np.zeros_like(uu64))
    to64 = lambda t: type(t)(*(x.astype(jnp.float64) if x.dtype == jnp.float32
                               else x for x in t))
    want, _, _ = mt.simulate(
        mt.State(to64(state.rays), to64(state.mean)), to64(statics), bg64,
        cfg64, mt.RunConfig(dt=120.0, n_steps=1, save_every=1))
    du64 = np.asarray(want.mean.u) - uu64
    assert np.max(np.abs(du32 - du64)) / np.max(np.abs(du64)) < 1e-6


@pytest.mark.cuda
def test_k5_kernel_matches_twin_on_gpu(cuda_device):
    for mode in MODES.values():
        cfg, bg, state, statics = _setup(n=20_000, pad_to=20_123, **mode)
        s, st, b = mtt.from_numpy((state, statics, bg), device=cuda_device)
        tcfg = _tcfg(cfg)
        before = step_cuda.LAUNCHES
        got, _, hist = mtt.simulate_resident(s, st, b, tcfg, TRUN)
        again, _, _ = mtt.simulate_resident(s, st, b, tcfg, TRUN)
        assert step_cuda.LAUNCHES == before + 6
        ops = step_cuda.operands(s, st, b, tcfg, TRUN.dt)
        uv = torch.stack([s.mean.u, s.mean.v])
        dens, r, m, uv, prop = step_cuda.step_resident_reference(
            ops, s.rays.dens, s.rays.r, s.rays.m, uv, TRUN.n_steps)
        for want, have in ((dens, got.rays.dens), (r, got.rays.r),
                           (m, got.rays.m), (uv[0], got.mean.u),
                           (prop, hist[2][-1])):
            assert _rel(want.cpu(), have.cpu()) < TOL
        assert torch.equal(got.rays.dens, again.rays.dens)
        assert torch.equal(got.mean.u, again.mean.u)
