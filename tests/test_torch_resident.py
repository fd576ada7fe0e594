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


def _order_tiles(monkeypatch, on=True):
    """K5's tile order on every launch of these small runs, or on none."""
    monkeypatch.setattr(step_cuda, "ORDER_MIN_STEPS", 0)
    monkeypatch.setattr(step_cuda, "ORDER_MIN_RAYS", 0 if on else 1 << 40)


def _shuffled(state, statics, perm):
    """The same population with slot ``i`` holding ray ``perm[i]``."""
    take = lambda t: type(t)(*(x[perm] for x in t))
    return state._replace(rays=take(state.rays)), take(statics)


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("include_t0", [False, True])
def test_k5_shuffled_population_comes_back_in_its_slots(include_t0, ordered,
                                                        monkeypatch):
    """K5 orders its tiles itself: a shuffled population's run, read back
    through the shuffle, is the unshuffled run, per slot, in the final
    state, every history frame with ``dens_prop`` and every ``observe``
    frame; the padded inactive slots stay inactive and unchanged in the
    slots the caller gave them; the frozen fields are the caller's.  With
    the tile order on every launch and on none."""
    _order_tiles(monkeypatch, ordered)
    cfg, bg, state, statics = _setup(n=900, pad_to=1024)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    perm = torch.randperm(1024, generator=torch.Generator().manual_seed(19))
    inv = torch.argsort(perm)
    ss, sst = _shuffled(s, st, perm)
    before = [x.clone() for x in ss.rays]      # the caller's, left untouched
    tcfg = _tcfg(cfg)

    def observe(state_, statics_, aux):
        return (state_.rays.r, state_.rays.m, state_.mean.u, aux.dens_prop)

    want, _, whist = mtt.simulate_resident(s, st, b, tcfg, TRUN,
                                           include_t0=include_t0)
    got, gst, ghist = mtt.simulate_resident(ss, sst, b, tcfg, TRUN,
                                            include_t0=include_t0)
    _, _, wobs = mtt.simulate_resident(s, st, b, tcfg, TRUN,
                                       include_t0=include_t0, observe=observe)
    _, _, gobs = mtt.simulate_resident(ss, sst, b, tcfg, TRUN,
                                       include_t0=include_t0, observe=observe)
    back = lambda x: x[..., inv]
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), back(getattr(got.rays, f))) < TOL, f
        assert _rel(getattr(whist[0].rays, f), back(getattr(ghist[0].rays, f))) < TOL, f
    assert _rel(want.mean.u, got.mean.u) < TOL
    assert _rel(whist[0].mean.u, ghist[0].mean.u) < TOL
    assert _rel(whist[2], back(ghist[2])) < TOL
    assert torch.equal(back(ghist[1]), whist[1])
    for w, g in zip(wobs[:2] + wobs[3:], gobs[:2] + gobs[3:]):
        assert w.shape == (4 if include_t0 else 3, 1024)
        assert _rel(w, back(g)) < TOL
    assert _rel(wobs[2], gobs[2]) < TOL
    # the padding: inactive, and unchanged in its own slots in every frame
    pads = ~sst.active
    assert int(pads.sum()) == 124 and not bool(pads[-124:].all())
    assert gst is sst and not bool(ghist[1][:, pads].any())
    for f in ("dens", "r", "m"):
        assert torch.equal(getattr(got.rays, f)[pads], getattr(ss.rays, f)[pads])
        frames = getattr(ghist[0].rays, f)
        assert all(torch.equal(x[pads], getattr(ss.rays, f)[pads]) for x in frames)
    assert all(got.rays[i] is ss.rays[i] for i, f in enumerate(got.rays._fields)
               if f not in ("dens", "r", "m"))
    assert all(torch.equal(x, y) for x, y in zip(ss.rays, before))


def test_k5_tile_order_is_a_function_of_the_state(monkeypatch):
    """The tiles of a launch depend on its state alone, not on the run's
    history: every launch orders the caller's slots from the state as the
    last frame left it, and two launches in one run are bitwise one
    launch, then one more from its final state (as a resumed run starts)."""
    _order_tiles(monkeypatch)
    cfg, bg, state, statics = _setup(n=900, pad_to=1024)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    s, st = _shuffled(s, st, torch.randperm(
        1024, generator=torch.Generator().manual_seed(5)))
    tcfg = _tcfg(cfg)
    seen, tile_order = [], step_cuda.tile_order

    def spy(ops, r, m, active, n_members):
        seen.append((r.clone(), m.clone(), active))
        return tile_order(ops, r, m, active, n_members)

    monkeypatch.setattr(step_cuda, "tile_order", spy)
    two = mtt.RunConfig(dt=120.0, n_steps=2 * 6, save_every=6)
    one = mtt.RunConfig(dt=120.0, n_steps=6, save_every=6)
    straight, _, hist = mtt.simulate_resident(s, st, b, tcfg, two,
                                              include_t0=True)
    assert len(seen) == 2
    for t, (r, m, active) in enumerate(seen):
        assert torch.equal(r, hist[0].rays.r[t]) and active is st.active
        assert torch.equal(m, hist[0].rays.m[t])
    half, _, _ = mtt.simulate_resident(s, st, b, tcfg, one)
    resumed, _, rhist = mtt.simulate_resident(half, st, b, tcfg, one)
    for x, y in ((straight.rays.dens, resumed.rays.dens),
                 (straight.rays.r, resumed.rays.r),
                 (straight.rays.m, resumed.rays.m),
                 (straight.mean.u, resumed.mean.u), (hist[2][-1], rhist[2][-1])):
        assert torch.equal(x, y)


def _cell_spans(ops, r, dr, active):
    """Each 256-ray tile's deposit span in cells, from its active rays."""
    dz, nzmax = ops.scalars[1], ops.n_tab - 2
    lo = torch.clamp(torch.trunc((r - 0.5 * dr) / dz), 0, nzmax)
    up = torch.clamp(torch.trunc((r + 0.5 * dr) / dz + 1.0), 0, nzmax)
    lo = torch.where(active, lo, torch.inf).view(-1, step_cuda.TILE)
    up = torch.where(active, up, -torch.inf).view(-1, step_cuda.TILE)
    return up.amax(1) - lo.amin(1)


def test_k5_tile_order():
    """``tile_order`` is Python's stable sort by (inactive or non-finite,
    cell, m); on a keyed population stepped four launches, the ordered
    tiles' widest deposit span is never wider than the caller's order
    gives, and narrower in some launch."""
    cfg, bg, state, statics = _setup(n=900, pad_to=1024)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    ops = step_cuda.operands(s, st, b, _tcfg(cfg), 120.0)
    g = torch.Generator().manual_seed(7)
    n = 1024
    r = (torch.rand(n, generator=g) * 110e3 - 5e3).to(torch.float32)
    m = torch.randn(n, generator=g).to(torch.float32) * 1e-3
    r[::7], m[::11] = r[3], m[5]                 # ties in cell and in m
    r[::97], m[::89] = torch.nan, torch.inf      # non-finite slots
    active = torch.rand(n, generator=g) < 0.8
    order = step_cuda.tile_order(ops, r, m, active)
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    ok = active & torch.isfinite(r) & torch.isfinite(m)
    cell = torch.clamp(torch.trunc(r / ops.scalars[1]), 0, ops.n_tab - 2)
    want = sorted(range(n), key=lambda i: (0, float(cell[i]), float(m[i]))
                  if ok[i] else (1, 0.0, 0.0))
    assert order.tolist() == want
    assert not bool(ok[order][int(ok.sum()):].any())

    tcfg = _tcfg(cfg)
    rays, tst = mtt.gaussian_spectrum_source(
        tcfg, b, 4096, z_launch=2000.0, dz_launch=500.0,
        key=torch.Generator().manual_seed(3), dtype=torch.float32)
    ts = mtt.State(rays, s.mean)
    run = mtt.RunConfig(dt=120.0, n_steps=4 * 18, save_every=18)
    _, _, hist = mtt.simulate_resident(ts, tst, b, tcfg, run, include_t0=True)
    ops = step_cuda.operands(ts, tst, b, tcfg, 120.0)
    narrower = []
    for t in range(4):                     # each launch's starting state
        r, m = hist[0].rays.r[t], hist[0].rays.m[t]
        caller = _cell_spans(ops, r, rays.dr, tst.active).max()
        o = step_cuda.tile_order(ops, r, m, tst.active)
        ordered = _cell_spans(ops, r[o], rays.dr[o], tst.active[o]).max()
        assert ordered <= caller, (t, ordered, caller)
        narrower.append(bool(ordered < caller))
    assert any(narrower), narrower


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


@pytest.mark.cuda
def test_k5_shuffled_kernel_matches_twin_on_gpu(cuda_device, monkeypatch):
    """A shuffled 20,123-ray population (padding scattered among the slots)
    in the three modes: K5, ordering its tiles, against its twin on the
    caller's order, and two runs bitwise equal."""
    _order_tiles(monkeypatch)
    perm = torch.randperm(20_123, generator=torch.Generator().manual_seed(23))
    for mode in MODES.values():
        cfg, bg, state, statics = _setup(n=20_000, pad_to=20_123, **mode)
        s, st, b = mtt.from_numpy((state, statics, bg), device=cuda_device)
        s, st = _shuffled(s, st, perm.to(cuda_device))
        tcfg = _tcfg(cfg)
        got, _, hist = mtt.simulate_resident(s, st, b, tcfg, TRUN)
        again, _, ahist = mtt.simulate_resident(s, st, b, tcfg, TRUN)
        ops = step_cuda.operands(s, st, b, tcfg, TRUN.dt)
        uv = torch.stack([s.mean.u, s.mean.v])
        dens, r, m, uv, prop = step_cuda.step_resident_reference(
            ops, s.rays.dens, s.rays.r, s.rays.m, uv, TRUN.n_steps)
        for want, have in ((dens, got.rays.dens), (r, got.rays.r),
                           (m, got.rays.m), (uv[0], got.mean.u),
                           (prop, hist[2][-1])):
            assert _rel(want.cpu(), have.cpu()) < TOL
        for x, y in ((got.rays.dens, again.rays.dens), (got.rays.r, again.rays.r),
                     (got.rays.m, again.rays.m), (got.mean.u, again.mean.u),
                     (hist[2], ahist[2])):
            assert torch.equal(x, y)
