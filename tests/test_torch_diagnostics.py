"""The port's conservation diagnostics, projection variants and
interpolation helpers against msgwam_tpu on the same seeded histories:
float64 at rtol 1e-12, and the K1 route (its twin here) in float32
against msgwam_tpu's Pallas deposit in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu.diagnostics as jd
import msgwam_tpu_torch as mtt
import msgwam_tpu_torch.diagnostics as td
from msgwam_tpu.ops import projection as jp
from msgwam_tpu.ops.interp import interp as j_interp, uniform_interp as j_uniform
from msgwam_tpu_torch.ops import projection as tp
from msgwam_tpu_torch.ops.interp import interp as t_interp, uniform_interp as t_uniform

torch.set_num_threads(1)


def _history(seed, n_frames, n=160, dtype=np.float64):
    """A seeded history of ``n_frames`` frames of ``n`` rays (heights
    across the domain and past its edges, a tenth inactive), with its
    statics and the reference grid."""
    rng = np.random.default_rng(seed)
    shape = (n_frames, n)
    rays = dict(
        dens=np.abs(rng.normal(size=shape)) * 1e9,
        lam=np.zeros(shape),
        phi=rng.uniform(-0.5, 0.5, shape),
        r=rng.uniform(-5e3, 105e3, shape),
        dr=rng.uniform(100.0, 2500.0, shape),
        k=rng.uniform(1e-5, 1e-3, shape),
        l=rng.uniform(-1e-3, 1e-3, shape),
        m=rng.uniform(-1e-2, -1e-4, shape),
        dm=np.abs(rng.normal(size=shape)) * 1e-4,
    )
    rays = {k: v.astype(dtype) for k, v in rays.items()}
    active = rng.random(shape) > 0.1
    statics = dict(dkk=np.full(n, 1e-4, dtype), dll=np.full(n, 1e-4, dtype),
                   rr_mm_area=np.full(n, 5e-5, dtype),
                   active=np.ones(n, bool))
    return rays, active, statics


def _jax_tree(rays, active, statics, cfg):
    gc = mt.GridConfig()
    dtype = jnp.dtype(cfg.dtype)
    uu = np.zeros(gc.n_cell)
    bg = mt.make_background(gc, cfg, uu, uu, dtype=dtype)
    return (mt.RayState(**{k: jnp.asarray(v) for k, v in rays.items()}),
            jnp.asarray(active),
            mt.RayStatics(**{k: jnp.asarray(v) for k, v in statics.items()}),
            bg)


def _torch_tree(rays, active, statics, cfg):
    gc = mtt.GridConfig()
    uu = np.zeros(gc.n_cell)
    bg = mtt.make_background(gc, cfg, uu, uu, dtype=cfg.dtype, device="cpu")
    t = lambda x: torch.from_numpy(np.array(x))
    return (mtt.RayState(**{k: t(v) for k, v in rays.items()}), t(active),
            mtt.RayStatics(**{k: t(v) for k, v in statics.items()}), bg)


def _cfgs(**kw):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(**kw)
    return cfg, mtt.ModelConfig(**dataclasses.asdict(cfg))


def _close(got, want, rtol=1e-12):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("backend", ["xla", "mxu"])
def test_wave_action_history_matches_jax(backend):
    jcfg, tcfg = _cfgs(projection_backend=backend, max_span=4)
    rays, active, statics = _history(1, 6)
    want = jd.wave_action_history(*_jax_tree(rays, active, statics, jcfg), jcfg)
    got = td.wave_action_history(*_torch_tree(rays, active, statics, tcfg),
                                 tcfg)
    for name in ("wave_action", "flux", "tendency"):
        _close(getattr(got, name), getattr(want, name))
    assert got.wave_action.shape == (6, 100)
    assert got.flux.shape == (6, 99) and got.tendency.shape == (6, 100)


def test_wave_action_history_k1_route_matches_jax_pallas():
    """``projection_backend="pallas"``: two K1 calls a frame (the twin on
    the CPU) against msgwam_tpu's Pallas deposit (interpret mode), float32,
    within 1e-5 of the maximum."""
    jcfg, tcfg = _cfgs(projection_backend="pallas", dtype="float32")
    rays, active, statics = _history(2, 3, n=256, dtype=np.float32)
    want = jd.wave_action_history(*_jax_tree(rays, active, statics, jcfg), jcfg)
    got = td.wave_action_history(*_torch_tree(rays, active, statics, tcfg),
                                 tcfg)
    for name in ("wave_action", "flux", "tendency"):
        assert getattr(got, name).dtype == torch.float32
        _close(getattr(got, name), getattr(want, name), rtol=1e-5)


@pytest.mark.parametrize("faithful", [True, False])
def test_reference_window_diagnostics_matches_jax(faithful):
    """The driver's window: the zero row, quirk 3 (``faithful_diag_index``)
    and the shortened flux, frame for frame."""
    jcfg, tcfg = _cfgs(faithful_diag_index=faithful, max_span=4)
    rays, active, statics = _history(3, 9)
    want = jd.reference_window_diagnostics(
        *_jax_tree(rays, active, statics, jcfg), jcfg)
    got = td.reference_window_diagnostics(
        *_torch_tree(rays, active, statics, tcfg), tcfg)
    for name in ("wave_action", "flux", "tendency"):
        _close(getattr(got, name), getattr(want, name))
    assert got.wave_action.shape == (5, 100) and got.flux.shape == (4, 99)
    assert not got.wave_action[3].any() and not got.flux[-1].any()


def test_reference_window_diagnostics_needs_seven_frames():
    _, tcfg = _cfgs()
    rays, active, statics = _history(4, 6)
    with pytest.raises(ValueError, match="n_frames >= 7, got 6"):
        td.reference_window_diagnostics(
            *_torch_tree(rays, active, statics, tcfg), tcfg)


@pytest.mark.parametrize("backend", ["xla", "mxu"])
def test_pseudo_momentum_flux_matches_jax(backend):
    jcfg, tcfg = _cfgs(projection_backend=backend, max_span=4)
    rays, active, statics = _history(5, 1)
    statics["active"] = active[0]
    one = lambda tree: type(tree)(*(x[0] for x in tree))
    jr, _, js, jbg = _jax_tree(rays, active, statics, jcfg)
    tr, _, ts, tbg = _torch_tree(rays, active, statics, tcfg)
    want = jd.pseudo_momentum_flux(one(jr), js, jbg, jcfg)
    got = td.pseudo_momentum_flux(one(tr), ts, tbg, tcfg)
    assert got.shape == (2, 99)
    _close(got, want)


@pytest.mark.parametrize("var", ["interfaces", 0, 1, 2, 3, 4])
def test_projection_variants_match_jax(var):
    """``project_reference_variant`` var 0-4 and ``project_interfaces``."""
    rays, active, statics = _history(6, 1, n=200)
    r = {k: v[0] for k, v in rays.items()}
    grid = mt.GridConfig().centers()
    valid = active[0]
    if var == "interfaces":
        vals = np.stack([r["dens"], r["k"] * r["dens"]])
        args = (vals, r["r"] - r["dr"] / 2, r["r"] + r["dr"] / 2,
                np.abs(r["dm"]), valid, grid)
        want = jp.project_interfaces(*(jnp.asarray(x) for x in args))
        got = tp.project_interfaces(*(torch.from_numpy(np.array(x))
                                      for x in args))
        assert got.shape == (2, 100)
    else:
        args = (r["dens"], r["lam"], r["phi"], r["r"] - r["dr"] / 2,
                r["r"] + r["dr"] / 2, r["k"], r["l"], r["m"] - r["dm"] / 2,
                r["m"] + r["dm"] / 2, statics["dkk"], statics["dll"], r["dm"],
                grid)
        kw = dict(var=var, max_span=4)
        want = jp.project_reference_variant(*(jnp.asarray(x) for x in args),
                                            0.01, valid=jnp.asarray(valid),
                                            **kw)
        got = tp.project_reference_variant(
            *(torch.from_numpy(np.array(x)) for x in args), 0.01,
            valid=torch.from_numpy(valid), **kw)
    _close(got, want)


@pytest.mark.parametrize("fn", ["interp", "uniform_interp"])
def test_interp_helpers_match_jax(fn):
    """``np.interp`` semantics inside, on the nodes and clamped outside."""
    rng = np.random.default_rng(7)
    xp = mt.GridConfig().centers()
    fp = rng.normal(size=xp.shape)
    x = np.concatenate([rng.uniform(-5e3, 105e3, 300), xp[::7],
                        [xp[0], xp[-1]]])
    if fn == "interp":
        want = j_interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
        got = t_interp(*(torch.from_numpy(a) for a in (x, xp, fp)))
    else:
        args = (xp[0], xp[1] - xp[0])
        want = j_uniform(jnp.asarray(x), *args, jnp.asarray(fp))
        got = t_uniform(torch.from_numpy(x), *args,
                                torch.from_numpy(fp))
    _close(got, want)
    _close(got, np.interp(x, xp, fp))
