"""K6 (``simulate_streaming``, Path D) against msgwam_tpu on the cases of
tests/test_lifecycle_kernel.py: 2,000 rays, 6 steps, ``m_max = pi/1500``
so that culls fire.  On the CPU each launch runs K6's plain twin.  The
oracles are JAX's ``simulate_streaming`` (the Pallas kernel in interpret
mode, ``tile_rows=8`` so that it pads to 3,072 rays) and JAX's scan path,
at the JAX tests' bar of 1e-5 relative to the maximum with identical
masks.  Then the launch sort with slot identity, ``internal_ray_layout``,
``observe``/``include_t0``, the guard rails and ``simulate_resident``'s
route."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.diagnostics import internal_ray_layout as jax_layout
from msgwam_tpu.models.backgrounds import tidal_shear
from msgwam_tpu.ops.step_pallas_stream import simulate_streaming as jax_streaming
from msgwam_tpu_torch.diagnostics import internal_ray_layout
from msgwam_tpu_torch.ops import step_cuda_stream
from msgwam_tpu_torch.ops.step_cuda_stream import simulate_streaming

torch.set_num_threads(1)

N_RAY = 2000
M_MAX = np.pi / 1500.0
TOL = 1e-5
RUN = mt.RunConfig(dt=120.0, n_steps=6, save_every=3)
TRUN = mtt.RunConfig(dt=120.0, n_steps=6, save_every=3)


def _tcfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


@pytest.fixture(scope="module")
def setup():
    base = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32", projection_backend="mxu",
        interp_backend="mxu", prognostic_mean=False, m_max=M_MAX)
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(centers, jnp.float32), base)).astype(np.float32)
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, base, uu, vv, dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(
        base, bg, N_RAY, z_launch=2000.0, dz_launch=500.0,
        amplitude_alpha=0.003, dtype=jnp.float32)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    cj = jnp.asarray(centers, jnp.float32)
    ct = torch.tensor(centers, dtype=torch.float32)
    winds = (lambda t: (tidal_shear(cj, t, base), jnp.zeros_like(cj)),
             lambda t: (mtt.tidal_shear(ct, t, _tcfg(base)), torch.zeros_like(ct)))
    return base, bg, state, statics, winds


def _shuffled(state, statics, seed=0):
    """One fixed permutation of every ray, heights jittered by up to
    ±200 m: a launch sort is then far from the identity."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N_RAY)
    rays = jax.tree.map(lambda x: np.asarray(x)[perm], state.rays)
    rays = rays._replace(r=rays.r + rng.uniform(-200, 200, N_RAY).astype(np.float32))
    statics = jax.tree.map(lambda x: np.asarray(x)[perm], statics)
    return (state._replace(rays=jax.tree.map(jnp.asarray, rays)),
            jax.tree.map(jnp.asarray, statics))


CASES = {
    "cull_only": (dict(cull=True), dict()),
    "relaunch_tidal": (dict(cull=True, relaunch=True), dict(wind=True, source=True)),
    "prescribed_prognostic": (dict(cull=True, prognostic_mean=True), dict(wind=True)),
    "scalar_wind": (dict(), dict(wind="scalar")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k6_twin_matches_jax(setup, case):
    """Final state, mask and the history's last frame against JAX's
    streaming kernel and its scan path; culls fire."""
    base, bg, state, statics, (jwind, twind) = setup
    over, opts = CASES[case]
    cfg = base.replace(**over)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    jkw, tkw = {}, {}
    if opts.get("wind") == "scalar":
        jkw["wind_fn"] = lambda t: (0.5 + 0.0 * t, jnp.float32(0.0))
        tkw["wind_fn"] = lambda t: (0.5 + 0.0 * t, 0.0)
    elif opts.get("wind"):
        jkw["wind_fn"], tkw["wind_fn"] = jwind, twind
    if opts.get("source"):
        jkw["source"], tkw["source"] = (state.rays, statics), (s.rays, st)
    tcfg = _tcfg(cfg)
    before = dict(step_cuda_stream.LAUNCHES)
    got, gst, ghist = simulate_streaming(s, st, b, tcfg, TRUN, **tkw)
    assert step_cuda_stream.LAUNCHES == before      # the twin ran, on the CPU
    if cfg.cull:
        _, cull_st, _ = simulate_streaming(s, st, b, tcfg.replace(relaunch=False),
                                           TRUN, **{k: v for k, v in tkw.items()
                                                    if k != "source"})
        assert int(cull_st.active.sum()) < N_RAY, "culls must fire"
    streamed = jax_streaming(state, statics, bg, cfg, RUN, tile_rows=8, **jkw)
    scanned = mt.simulate(state, statics, bg, cfg, RUN, **jkw)
    utol = 2 * TOL if opts.get("wind") == "scalar" else TOL   # as the JAX test
    for want, wst, whist in (streamed, scanned):
        np.testing.assert_array_equal(gst.active.numpy(), np.asarray(wst.active))
        for f in ("dens", "r", "m"):
            assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < TOL, f
        assert _rel(want.mean.u, got.mean.u) < utol
        np.testing.assert_array_equal(ghist[1][-1].numpy(), np.asarray(whist[1][-1]))
        assert _rel(whist[2][-1], ghist[2][-1]) < TOL
        assert _rel(whist[0].rays.r[-1], ghist[0].rays.r[-1]) < TOL


def test_k6_keyed_source_matches_jax_scan(setup):
    """Keyed templates drawn once per launch: at ``save_every=1`` JAX's
    per-step key splits, replayed on the host and handed over in order,
    give the scan path's trajectory, with and without the launch sort."""
    base, bg, state, statics, _ = setup
    cfg = base.replace(cull=True, relaunch=True)
    run1 = mt.RunConfig(dt=120.0, n_steps=6, save_every=1)
    rays0, statics0 = state.rays, statics

    def src_fn(key):
        f = jax.random.uniform(key, (), jnp.float32, 0.5, 1.5)
        return rays0._replace(dens=rays0.dens * f), statics0

    key, draws = jax.random.PRNGKey(7), []
    for _ in range(run1.n_steps):
        key, sub = jax.random.split(key)
        draws.append(mtt.from_numpy(src_fn(sub), device="cpu"))
    want, wst, _ = mt.simulate(state, statics, bg, cfg, run1, source=src_fn,
                               source_key=jax.random.PRNGKey(7))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    gen = torch.Generator()
    outs = []
    for sort in (False, True):
        handed = iter(draws)
        outs.append(simulate_streaming(
            s, st, b, _tcfg(cfg), mtt.RunConfig(dt=120.0, n_steps=6, save_every=1),
            source=lambda g: next(handed), source_key=gen, launch_sort=sort))
    for got, gst, _ in outs:
        assert int(gst.active.sum()) == N_RAY, "relaunch refills culled slots"
        np.testing.assert_array_equal(gst.active.numpy(), np.asarray(wst.active))
        for f in ("dens", "r", "m"):
            assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < TOL, f


def test_k6_launch_sort_keeps_slot_identity(setup):
    """The launch sort with the lifecycle on a shuffled population: the
    same trajectory and masks as unsorted, every history frame in slot
    order, the frozen fields untouched, and ``return_final_perm`` the
    permutation the last launch ran over."""
    base, bg, state, statics, (_, twind) = setup
    state, statics = _shuffled(state, statics)
    cfg = _tcfg(base.replace(cull=True, relaunch=True))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    run = mtt.RunConfig(dt=120.0, n_steps=6, save_every=2)
    kw = dict(source=(s.rays, st), wind_fn=twind, return_final_perm=True)
    a, sa, ha, pa = simulate_streaming(s, st, b, cfg, run, launch_sort=False, **kw)
    c, sc, hc, pc = simulate_streaming(s, st, b, cfg, run, launch_sort=True, **kw)
    nl, _, _ = mtt.simulate(s, st, b, cfg.replace(cull=False, relaunch=False),
                            run, wind_fn=twind)
    assert _rel(nl.rays.r, a.rays.r) > 1e-3, "cull and relaunch must fire"
    assert torch.equal(pa, torch.arange(N_RAY))
    assert torch.equal(torch.sort(pc).values, torch.arange(N_RAY))
    assert not torch.equal(pc, pa)
    assert torch.equal(sa.active, sc.active)
    ist, _ = internal_ray_layout(c, sc, pc)
    assert torch.equal(ist.rays.dens, c.rays.dens[pc])
    for f in ("dens", "r", "m"):
        assert _rel(getattr(a.rays, f), getattr(c.rays, f)) < TOL
    assert c.rays.k is s.rays.k
    for t in range(3):
        assert torch.equal(ha[1][t], hc[1][t])
        assert _rel(ha[0].rays.r[t], hc[0].rays.r[t]) < TOL
        assert _rel(ha[2][t], hc[2][t]) < TOL


def test_internal_ray_layout_matches_jax(setup):
    """One sorted launch from a shuffled population: the port's
    permutation is JAX's with its pad rows left out, and the layouts
    built from it agree."""
    base, bg, state, statics, _ = setup
    state, statics = _shuffled(state, statics, seed=1)
    run = mt.RunConfig(dt=120.0, n_steps=2, save_every=2)
    fin, stf, _, perm = jax_streaming(state, statics, bg, base, run, tile_rows=8,
                                      launch_sort=True, return_final_perm=True)
    perm = np.asarray(perm)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    _, _, _, tperm = simulate_streaming(s, st, b, _tcfg(base), _trun(run),
                                        launch_sort=True, return_final_perm=True)
    np.testing.assert_array_equal(tperm.numpy(), perm[perm < N_RAY])
    jst, jstat = jax_layout(fin, stf, jnp.asarray(perm))
    tfin, tstf = mtt.from_numpy((fin, stf), device="cpu")
    ist, istat = internal_ray_layout(tfin, tstf, tperm)
    keep = perm < N_RAY
    for x, y in zip((*jst.rays, *jstat), (*ist.rays, *istat)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x)[keep])
    # a longer permutation (JAX's padded one) pads as JAX does
    pst, pstat = internal_ray_layout(tfin, tstf, torch.from_numpy(perm.copy()))
    for x, y in zip((*jst.rays, *jstat), (*pst.rays, *pstat)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def _trun(run):
    return mtt.RunConfig(dt=run.dt, n_steps=run.n_steps, save_every=run.save_every)


def test_k6_observe_and_include_t0(setup):
    """``observe`` reduces each frame as the same function of the default
    history, in both sort modes; ``include_t0`` prepends the caller's
    state and mask."""
    base, bg, state, statics, _ = setup
    cfg = _tcfg(base.replace(cull=True))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    obs = lambda s_, st_, aux: (s_.mean.u, (aux.dens_prop * st_.active).sum(),
                                (s_.rays.r * st_.active).max())
    for sort in (False, True):
        _, _, full = simulate_streaming(s, st, b, cfg, TRUN, launch_sort=sort,
                                        include_t0=True)
        _, _, (hu, hp, hr) = simulate_streaming(s, st, b, cfg, TRUN,
                                                launch_sort=sort, observe=obs,
                                                include_t0=True)
        h_state, h_act, h_prop = full
        assert h_state.rays.r.shape == (3, N_RAY) and hu.shape == (3, 100)
        assert torch.equal(h_state.rays.r[0], s.rays.r)
        assert torch.equal(h_act[0], st.active) and torch.equal(h_prop[0], s.rays.dens)
        assert not bool(h_act[-1].all())
        assert torch.equal(hu, h_state.mean.u)
        for t in range(3):
            assert torch.allclose(hp[t], (h_prop[t] * h_act[t]).sum(), rtol=1e-6)
            assert torch.equal(hr[t], (h_state.rays.r[t] * h_act[t]).max())


def test_k6_guard_rails(setup):
    base, bg, state, statics, _ = setup
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    cfg = _tcfg(base.replace(cull=True, relaunch=True))
    bad = (s.rays._replace(k=s.rays.k * 1.5), st)
    with pytest.raises(ValueError, match="frozen fields.*'k'"):
        mtt.simulate_resident(s, st, b, cfg, TRUN, source=bad)
    with pytest.raises(ValueError, match="online"):
        mtt.simulate_resident(s, st, b, cfg.replace(saturate_online=False), TRUN,
                              source=(s.rays, st))
    with pytest.raises(ValueError, match="source template"):
        simulate_streaming(s, st, b, cfg, TRUN)
    with pytest.raises(ValueError, match="source_key"):
        simulate_streaming(s, st, b, cfg, TRUN, source=lambda g: (s.rays, st))
    with pytest.raises(ValueError, match="hprop"):
        simulate_streaming(s, st, b, cfg.replace(hprop=True), TRUN,
                           source=(s.rays, st))
    s64, st64, b64 = mtt.from_numpy((state, statics, bg), dtype="float64", device="cpu")
    with pytest.raises(TypeError, match="float32"):
        simulate_streaming(s64, st64, b64, cfg.replace(dtype="float64"), TRUN,
                           source=(s64.rays, st64))


def test_simulate_resident_routes_to_k6(setup, monkeypatch):
    """The lifecycle, a ``wind_fn`` and an explicit launch sort go to K6
    with their arguments; the rest stays on K5."""
    base, bg, state, statics, (_, twind) = setup
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    calls = []
    orig = step_cuda_stream.simulate_streaming

    def spy(*args, **kw):
        calls.append(kw)
        return orig(*args, **kw)

    monkeypatch.setattr(step_cuda_stream, "simulate_streaming", spy)
    cfg = _tcfg(base)
    run = mtt.RunConfig(dt=120.0, n_steps=2, save_every=1)
    for over, kw in ((dict(cull=True), {}),
                     (dict(relaunch=True), dict(source=(s.rays, st))),
                     ({}, dict(wind_fn=twind, t0=600.0)),
                     ({}, dict(launch_sort=True))):
        calls.clear()
        mtt.simulate_resident(s, st, b, cfg.replace(**over), run, **kw)
        assert len(calls) == 1
        for k, v in kw.items():
            assert calls[0][k] is v
    calls.clear()
    mtt.simulate_resident(s, st, b, cfg, run)
    mtt.simulate_resident(s, st, b, cfg, run, launch_sort=None)
    assert not calls


@pytest.fixture
def cuda_device():
    """The card, for the tests that run a CUDA kernel; they skip without
    one (decided here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k6_kernel_matches_twin_on_gpu(setup, cuda_device):
    """K6 with cull, relaunch and the tidal wind against its twin on the
    CPU: 3e-5 relative to the maximum, masks equal, one launch per
    ``save_every`` steps."""
    base, bg, state, statics, (_, twind) = setup
    cfg = _tcfg(base.replace(cull=True, relaunch=True))
    s, st, b = mtt.from_numpy((state, statics, bg), device=cuda_device)
    before = step_cuda_stream.LAUNCHES["K6"]
    got, gst, ghist = simulate_streaming(s, st, b, cfg, TRUN, source=(s.rays, st),
                                         wind_fn=twind)
    assert step_cuda_stream.LAUNCHES["K6"] == before + 2
    cs, cst, cb = mtt.from_numpy((state, statics, bg), device="cpu")
    want, wst, whist = simulate_streaming(cs, cst, cb, cfg, TRUN,
                                          source=(cs.rays, cst), wind_fn=twind)
    assert torch.equal(gst.active.cpu(), wst.active)
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), getattr(got.rays, f).cpu()) < 3e-5, f
    assert _rel(whist[2][-1], ghist[2][-1].cpu()) < 3e-5
