"""The lifecycle on the scan path (Path C) against msgwam_tpu: ``cull`` and
``relaunch`` on the same NumPy inputs, the keyed launch spectrum by its
distribution, and ``simulate`` with culling, relaunch, prescribed and
scalar winds, the height sort and keyed sources.  The setup is
tests/test_lifecycle_kernel.py's: 2,000 rays launched at 2 km, 6 steps,
``m_max = pi/1500`` so that culls fire within the run.  Tolerances,
relative to the maximum: 1e-9 in float64, 1e-5 in float32 (the JAX
package's bar for its lifecycle kernel); masks identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.models.backgrounds import tidal_shear

torch.set_num_threads(1)

N_RAY = 2000
N_STEPS = 6
M_MAX = np.pi / 1500.0
TOL = {"float64": 1e-9, "float32": 1e-5}


def _tcfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def _trun(run):
    return mtt.RunConfig(dt=run.dt, n_steps=run.n_steps, save_every=run.save_every)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


def setup(dtype="float32", **cfg_kw):
    """The tests/test_lifecycle_kernel.py setup in ``dtype``: the JAX
    trees, the port's copies, and the tidal winds of both packages."""
    jdt = getattr(jnp, dtype)
    cfg = mt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": dtype, "projection_backend": "mxu",
        "interp_backend": "mxu", "prognostic_mean": False, "m_max": M_MAX,
        **cfg_kw})
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(centers, jdt), cfg))
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, cfg, uu, vv, dtype=jdt)
    rays, statics = mt.gaussian_spectrum_source(
        cfg, bg, N_RAY, z_launch=2000.0, dz_launch=500.0,
        amplitude_alpha=0.003, dtype=jdt)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    cj = jnp.asarray(centers, jdt)
    ct = torch.tensor(centers, dtype=getattr(torch, dtype))
    tcfg = _tcfg(cfg)
    jwind = lambda t: (tidal_shear(cj, t, cfg), jnp.zeros_like(cj))
    twind = lambda t: (mtt.tidal_shear(ct, t, tcfg), torch.zeros_like(ct))
    return cfg, bg, state, statics, jwind, twind


def _shuffled(state, statics, seed=0):
    """One fixed permutation of every ray, heights jittered by up to
    ±200 m, so that a height sort is far from the identity."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N_RAY)
    rays = jax.tree.map(lambda x: np.asarray(x)[perm], state.rays)
    r = rays.r + rng.uniform(-200.0, 200.0, N_RAY).astype(rays.r.dtype)
    rays = jax.tree.map(jnp.asarray, rays._replace(r=r))
    statics = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[perm]), statics)
    return state._replace(rays=rays), statics


def _culls_fire(s, st, b, tcfg, run):
    """Culls really happen in this configuration: a cull-only run of the
    port loses rays."""
    _, cst, _ = mtt.simulate(s, st, b, tcfg.replace(cull=True, relaunch=False),
                             run)
    return int(cst.active.sum()) < N_RAY


def test_cull_and_relaunch_match_jax():
    """``cull`` and ``relaunch`` on the same random inputs, with rays out
    of the domain at both ends, past ``m_max`` and non-finite: identical
    masks, bitwise fields."""
    cfg, bg, state, statics, _, _ = setup("float64")
    rng = np.random.default_rng(3)
    n = 500
    r = rng.uniform(-5e3, 105e3, n)
    m = rng.uniform(-2.0, 2.0, n) * M_MAX
    dens = rng.lognormal(0.0, 1.0, n)
    dens[:7] = np.nan
    m[7:12] = np.inf
    rays = mt.RayState(dens=dens, lam=np.zeros(n), phi=rng.uniform(0, 1, n),
                       r=r, dr=rng.uniform(300.0, 900.0, n),
                       k=rng.uniform(1e-5, 2e-4, n), l=rng.uniform(0, 1e-4, n),
                       m=m, dm=rng.uniform(1e-5, 1e-4, n))
    statics = mt.RayStatics(dkk=rng.uniform(0, 1, n), dll=rng.uniform(0, 1, n),
                            rr_mm_area=rng.uniform(0, 1, n),
                            active=rng.uniform(size=n) < 0.8)
    jstate = mt.State(rays, state.mean)
    tstate, tstatics, tbg = mtt.from_numpy((jstate, statics, bg), device="cpu")
    with jax.debug_nans(False):
        _, jst = mt.cull(jstate, statics, bg, cfg)
    _, tst = mtt.cull(tstate, tstatics, tbg, _tcfg(cfg))
    np.testing.assert_array_equal(tst.active.numpy(), np.asarray(jst.active))
    assert 0 < int(tst.active.sum()) < int(tstatics.active.sum())

    src = jax.tree.map(lambda x: x[::-1].copy(), (rays, statics))
    with jax.debug_nans(False):
        jrel = mt.relaunch(jstate, jst, src)
    trel = mtt.relaunch(tstate, tst, mtt.from_numpy(src, device="cpu"))
    for x, y in zip((*jrel[0].rays, *jrel[1]), (*trel[0].rays, *trel[1])):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_keyed_spectrum_distribution():
    """The keyed source at 1e5 draws: ``m`` within its cut exactly, the
    moments of the standardised ``m``, of ``log(jitter)`` and of the
    launch offsets within 1% of the distributions' (0.03 for the
    means), the frozen fields those of the deterministic spectrum; the
    same seed draws the same, another seed another."""
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(saturate_online=True)
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(torch.tensor(gc.centers()), cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu), device="cpu")
    n, kw = 100_000, dict(z_launch=40e3, dz_launch=500.0, m_halfwidth=2.0,
                          m_center=-2.0 * np.pi / 3e3)
    m_sigma = 2.0 * np.pi / 20e3
    draw = lambda seed: mtt.gaussian_spectrum_source(
        cfg, bg, n, key=torch.Generator().manual_seed(seed), **kw)
    rays, statics = draw(11)
    ref_rays, ref_statics = mtt.gaussian_spectrum_source(cfg, bg, n, **kw)
    x = ((rays.m - kw["m_center"]) / m_sigma).numpy()
    assert x.min() >= -2.0 - 1e-12 and x.max() <= 2.0 + 1e-12
    assert rays.m.max() <= -2.0 * np.pi / 50e3
    # a normal cut at ±2 sigma has standard deviation 0.8796
    assert abs(x.mean()) < 0.03 and abs(x.std() / 0.87963 - 1.0) < 0.01
    z_off = (rays.r - kw["z_launch"]).numpy()
    assert np.abs(z_off).max() <= 250.0
    assert abs(z_off.mean()) < 0.03 * 500.0
    assert abs(z_off.std() / (500.0 / np.sqrt(12.0)) - 1.0) < 0.01
    # the jitter is what divides the keyed density from the deterministic
    # formula at the drawn m and r
    jitter = rays.dens / _unjittered_dens(cfg, bg, rays, statics, **kw)
    lj = torch.log(jitter).numpy()
    assert abs(lj.mean()) < 0.03 * 0.3 and abs(lj.std() / 0.3 - 1.0) < 0.01
    for f in ("k", "l", "dr", "dm", "phi", "lam"):
        assert torch.equal(getattr(rays, f), getattr(ref_rays, f)), f
    for a, b in zip(statics, ref_statics):
        assert torch.equal(a, b)
    again = draw(11)[0]
    other = draw(12)[0]
    assert all(torch.equal(a, b) for a, b in zip(rays, again))
    assert not torch.equal(rays.m, other.m) and not torch.equal(rays.r, other.r)


def _unjittered_dens(cfg, bg, rays, statics, m_center, **_):
    """The keyed source's density without its jitter: the deterministic
    formula at the drawn ``m`` and ``r``."""
    from msgwam_tpu_torch.ops.dispersion import omega
    from msgwam_tpu_torch.ops.interp import grid_interp

    m_sigma = 2.0 * np.pi / 20e3
    f0 = mtt.coriolis(torch.tensor(cfg.phi0, dtype=torch.float64))
    rho = grid_interp(rays.r, bg.centers, bg.rhobar)
    omh = omega(rays.k, rays.l, rays.m, cfg.phi0, cfg.bvf)
    spectrum = torch.exp(-((rays.m - m_center) ** 2) / 2.0 / m_sigma**2)
    amp = 0.01**2 * rho / 2.0 * omh / rays.m**2 / (omh**2 - f0**2) * cfg.bvf**2
    return amp * spectrum / statics.dkk / statics.dll / rays.dm


CASES = {
    # name: (cfg overrides, simulate keywords: wind, source, sort)
    "cull": (dict(cull=True), dict()),
    "relaunch_tidal": (dict(cull=True, relaunch=True),
                       dict(wind=True, source=True)),
    "prescribed_prognostic": (dict(cull=True, prognostic_mean=True),
                              dict(wind=True)),
    "scalar_wind": (dict(cull=True), dict(wind="scalar")),
    "sort_every": (dict(cull=True, relaunch=True),
                   dict(source=True, sort=2, shuffle=True)),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_path_c_matches_jax(case, dtype):
    """``simulate`` with the lifecycle against the JAX scan path: the
    final state and mask, and the history's last frame (mask,
    ``dens_prop``, heights)."""
    over, opts = CASES[case]
    cfg, bg, state, statics, jwind, twind = setup(dtype, **over)
    if opts.get("shuffle"):
        state, statics = _shuffled(state, statics)
    run = mt.RunConfig(dt=120.0, n_steps=N_STEPS, save_every=3)
    jkw, tkw = {}, {}
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    if opts.get("wind") == "scalar":
        jkw["wind_fn"] = lambda t: (0.5 + 0.0 * t, 0.0)
        tkw["wind_fn"] = lambda t: (0.5 + 0.0 * t, 0.0)
    elif opts.get("wind"):
        jkw["wind_fn"], tkw["wind_fn"] = jwind, twind
    if opts.get("source"):
        jkw["source"], tkw["source"] = (state.rays, statics), (s.rays, st)
    if opts.get("sort"):
        jkw["sort_every"] = tkw["sort_every"] = opts["sort"]
    tcfg = _tcfg(cfg)
    assert _culls_fire(s, st, b, tcfg, _trun(run)), "culls must fire"

    want, wst, whist = mt.simulate(state, statics, bg, cfg, run, **jkw)
    got, gst, ghist = mtt.simulate(s, st, b, tcfg, _trun(run), **tkw)
    tol = TOL[dtype]
    np.testing.assert_array_equal(gst.active.numpy(), np.asarray(wst.active))
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < tol, f
    assert _rel(want.mean.u, got.mean.u) < tol
    np.testing.assert_array_equal(ghist[1][-1].numpy(), np.asarray(whist[1][-1]))
    assert _rel(whist[2][-1], ghist[2][-1]) < tol
    assert _rel(whist[0].rays.r[-1], ghist[0].rays.r[-1]) < tol


def test_keyed_source_matches_jax():
    """A callable source on the scan path: JAX's key splits are replayed
    on the host (``key, sub = split(key)`` per step) and its keyed draws
    handed to the port in order, so both runs relaunch from the same
    templates; a draw per step even at ``relaunch_every=2``."""
    cfg, bg, state, statics, _, _ = setup("float32", cull=True, relaunch=True)
    run = mt.RunConfig(dt=120.0, n_steps=N_STEPS, save_every=N_STEPS)
    kw = dict(z_launch=2000.0, dz_launch=500.0, amplitude_alpha=0.003,
              dtype=jnp.float32)
    src_fn = lambda key: mt.gaussian_spectrum_source(cfg, bg, N_RAY, key=key, **kw)
    key, draws = jax.random.PRNGKey(7), []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        draws.append(mtt.from_numpy(src_fn(sub), device="cpu"))
    handed = iter(draws)
    gen = torch.Generator().manual_seed(0)

    def port_src(g):
        assert g is gen
        return next(handed)

    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    assert _culls_fire(s, st, b, _tcfg(cfg), _trun(run)), "culls must fire"
    for every in (1, 2):
        handed = iter(draws)
        want, wst, _ = mt.simulate(state, statics, bg, cfg, run, source=src_fn,
                                   source_key=jax.random.PRNGKey(7),
                                   relaunch_every=every)
        got, gst, _ = mtt.simulate(s, st, b, _tcfg(cfg), _trun(run),
                                   source=port_src, source_key=gen,
                                   relaunch_every=every)
        np.testing.assert_array_equal(gst.active.numpy(), np.asarray(wst.active))
        for f in ("dens", "r", "m"):
            assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < 1e-5, f
    with pytest.raises(ValueError, match="source_key"):
        mtt.simulate(s, st, b, _tcfg(cfg), _trun(run), source=port_src)
