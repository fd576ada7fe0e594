"""K3 (the height-windowed fused RHS) and its window rule against
msgwam_tpu: the Pallas kernel in interpret mode on one 8192-ray block at
the float32 bar of tests/test_windowed.py (2e-5 relative to the maximum),
``resolve_window_cells``, and the window mirror of
``msgwam_tpu_torch.diagnostics``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.diagnostics import block_window_bounds as jax_block_window_bounds
from msgwam_tpu.models.rhs import rhs as jax_rhs
from msgwam_tpu.ops.rhs_pallas import resolve_window_cells as jax_resolve
from msgwam_tpu_torch.diagnostics import block_window_bounds, window_fallback_stats
from msgwam_tpu_torch.models.rhs import rhs as torch_rhs
from msgwam_tpu_torch.ops import ray_physics, rhs_cuda, rhs_cuda_windowed

torch.set_num_threads(1)

TOL = 2e-5


def _setup(n=8192, pad_to=8192, spread=None, sort=False, narrow=0,
           tile_spans=None, **cfg_kw):
    """tests/test_windowed.py's population: a gaussian source whose heights
    are ``spread`` over a band (shuffled unless ``sort``); ``narrow`` puts
    the first rays in a 3-6 km band; ``tile_spans`` gives each 256-ray
    tile a band of its own width in km, cycling."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32",
        "projection_backend": "mxu", "interp_backend": "mxu", **cfg_kw,
    })
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(cfg, bg, n, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    r = None
    if spread is not None:
        r = np.linspace(spread[0], spread[1], n).astype(np.float32)
        rng.shuffle(r)
        r[:narrow] = np.linspace(3e3, 6e3, narrow)
    if tile_spans is not None:
        tiles = -(-n // ray_physics.TILE)
        width = np.resize(np.asarray(tile_spans, np.float64) * 1e3, tiles)
        lo = rng.uniform(2e3, 95e3 - width)
        r = (np.repeat(lo, ray_physics.TILE)[:n] + rng.uniform(0, 1, n)
             * np.repeat(width, ray_physics.TILE)[:n]).astype(np.float32)
    if r is not None:
        rays = rays._replace(r=jnp.asarray(r))
    rays, statics = mt.pad_rays(rays, statics, pad_to)
    if sort:
        order = np.argsort(np.where(np.asarray(statics.active),
                                    np.asarray(rays.r), np.inf))
        rays = type(rays)(*(x[order] for x in rays))
        statics = type(statics)(*(x[order] for x in statics))
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.asarray(0.1 * np.roll(uu, 7))))
    return cfg, bg, state, statics


def _tcfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


POPULATIONS = {
    "engaged": dict(n=6000, spread=(2e3, 20e3), sort=True),
    "fallback": dict(spread=(2e3, 95e3)),
    "mixed": dict(spread=(2e3, 95e3), narrow=4096),
}
TIERS = {"engaged": {1}, "fallback": {0}, "mixed": {0, 1}}
SAT_MODES = [
    dict(saturate_online=True, faithful_saturation=True),
    dict(saturate_online=True, faithful_saturation=False),
    dict(saturate_online=False),
]


def _tiers(state, statics, bg, cfg):
    params, scalars, tables = rhs_cuda.prepare_inputs(120.0, state, statics,
                                                      bg, cfg)
    c_pad = rhs_cuda.c_pad_for(bg.centers.shape[0])
    _, _, tiers = ray_physics.fused(
        params, scalars, tables, rhs_cuda.ray_fields(state, statics),
        statics.active, cfg.saturate_online, cfg.faithful_saturation,
        (c_pad, *rhs_cuda.resolve_window_cells(cfg, c_pad)))
    return set(tiers.tolist())


def _check_against_jax(cfg, bg, state, statics):
    want = jax_rhs(120.0, state, statics, bg, cfg)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    tcfg = _tcfg(cfg)
    got = torch_rhs(120.0, s, st, b, tcfg)
    for f in ("r", "m") + (("dens",) if cfg.saturate_online else ()):
        assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < TOL, f
    assert _rel(want.mean.u, got.mean.u) < TOL
    assert _rel(want.mean.v, got.mean.v) < TOL
    # the window is a cost choice, never a change in result: K3's twin
    # equals K2's, bit for bit
    tend, flux = rhs_cuda_windowed.rhs_fused_windowed_reference(120.0, s, st, b,
                                                                tcfg)
    tend2, flux2 = rhs_cuda.rhs_fused_reference(120.0, s, st, b, tcfg)
    for f in ("dens", "r", "m"):
        assert torch.equal(tend[f], tend2[f]), f
    assert torch.equal(flux, flux2)
    return s, st, b, tcfg


@pytest.mark.parametrize("mode", range(len(SAT_MODES)))
@pytest.mark.parametrize("population", sorted(POPULATIONS))
def test_k3_matches_msgwam_tpu(population, mode):
    """``rhs(..., rhs_backend="pallas", window_cells=32)``: the port (K3's
    twin on CPU tensors) against the windowed Pallas kernel on windowed,
    full-width and mixed tiles, in the three saturation modes."""
    cfg, bg, state, statics = _setup(**POPULATIONS[population],
                                     **SAT_MODES[mode])
    cfg = cfg.replace(rhs_backend="pallas", window_cells=32)
    s, st, b, tcfg = _check_against_jax(cfg, bg, state, statics)
    assert _tiers(s, st, b, tcfg) == TIERS[population]


def test_k3_second_tier_matches_msgwam_tpu():
    """``window_cells=16, window_cells2=48`` on tiles of 5, 30 and 90 km:
    first window, second tier and full width side by side, all exact."""
    cfg, bg, state, statics = _setup(tile_spans=(5.0, 30.0, 90.0))
    cfg = cfg.replace(rhs_backend="pallas", window_cells=16, window_cells2=48)
    s, st, b, tcfg = _check_against_jax(cfg, bg, state, statics)
    assert _tiers(s, st, b, tcfg) == {0, 1, 2}


@pytest.mark.parametrize("window_cells, window_cells2, c_pad", [
    (-1, -1, 128), (0, 0, 128), (16, 0, 128), (17, 24, 128), (24, 16, 128),
    (32, 96, 128), (200, 0, 128), (16, 130, 128), (16, 48, 256),
    (100, 120, 128), (40, 40, 128), (-1, 64, 1152),
])
def test_resolve_window_cells_matches_msgwam_tpu(window_cells, window_cells2,
                                                 c_pad):
    cfg = mt.ModelConfig(window_cells=window_cells, window_cells2=window_cells2)
    assert rhs_cuda.resolve_window_cells(_tcfg(cfg), c_pad) == \
        jax_resolve(cfg, c_pad)


def test_auto_window_resolves_to_the_floor():
    """The port resolves the -1 settings to the 16-cell floor with the
    second tier off, at every size (no TPU-measured ladder)."""
    for n in (1_000, 100_000, 1_000_000):
        cfg = rhs_cuda.apply_champion(mtt.ModelConfig(), n)
        assert (cfg.window_cells, cfg.window_cells2) == (16, 0)
    cfg = mtt.ModelConfig(window_cells=24, window_cells2=48)
    assert rhs_cuda.apply_champion(cfg, 100_000) is cfg
    assert rhs_cuda.resolve_window_cells(mtt.ModelConfig(), 128) == (16, 0)


@pytest.mark.parametrize("population", ["engaged", "fallback"])
def test_block_window_bounds_match_msgwam_tpu(population):
    """At the JAX mirror's block of 1024 rays (``block_rows=8``) the port's
    per-tile bounds are the JAX package's."""
    kw = dict(POPULATIONS[population], n=16384, pad_to=16384)
    cfg, bg, state, statics = _setup(**kw)
    cfg = cfg.replace(rhs_backend="pallas", window_cells=32)
    lo, hi, c_pad = jax_block_window_bounds(120.0, state, statics, bg, cfg,
                                            block_rows=8)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    plo, phi, pc = block_window_bounds(120.0, s, st, b, _tcfg(cfg),
                                       tile_rays=1024)
    assert pc == c_pad == 128
    np.testing.assert_array_equal(plo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(hi))


def test_window_fallback_stats_on_the_port_tile():
    """With the port's 256-ray tile: no fallback on a coherent layout,
    every tile on a shuffled one, and the mirror counts what the twin of
    the kernel runs."""
    cfg, bg, state, statics = _setup(spread=(2e3, 20e3), sort=True)
    tcfg = _tcfg(cfg.replace(rhs_backend="pallas", window_cells=32))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    stats = window_fallback_stats(120.0, s, st, b, tcfg)
    assert int(stats.n_blocks) == 8192 // 256
    assert int(stats.n_fallback) == 0 and float(stats.fallback_rate) == 0.0

    cfg, bg, state, statics = _setup(spread=(2e3, 95e3))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    stats = window_fallback_stats(120.0, s, st, b, tcfg)
    assert int(stats.n_fallback) == int(stats.n_blocks) == 32
    assert float(stats.fallback_rate) == float(stats.full_rate) == 1.0

    cfg, bg, state, statics = _setup(tile_spans=(5.0, 30.0, 90.0))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    tcfg2 = tcfg.replace(window_cells=16, window_cells2=48)
    stats = window_fallback_stats(120.0, s, st, b, tcfg2)
    assert 0.0 < float(stats.full_rate) < float(stats.fallback_rate) < 1.0
    assert _tiers(s, st, b, tcfg2) == {0, 1, 2}


@pytest.mark.parametrize("sms", [1, 132])
def test_k3_twin_equals_k2_twin_on_any_plan(sms):
    """With the same block plan the window never changes a result: K3's
    twin equals K2's bitwise on mixed tiles, on a one-SM plan and the
    H100's."""
    cfg, bg, state, statics = _setup(tile_spans=(5.0, 30.0, 90.0))
    cfg = cfg.replace(rhs_backend="pallas", window_cells=16, window_cells2=48)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    tcfg = _tcfg(cfg)
    params, scalars, tables = rhs_cuda.prepare_inputs(120.0, s, st, b, tcfg)
    fields = rhs_cuda.ray_fields(s, st)
    plan = ray_physics.stage_plan(8192, 99, sms)
    window = rhs_cuda_windowed.window_for(tcfg, 100)
    t3, f3, tiers = ray_physics.fused(params, scalars, tables, fields, st.active,
                                      True, True, window, plan)
    t2, f2, _ = ray_physics.fused(params, scalars, tables, fields, st.active,
                                  True, True, None, plan)
    assert set(tiers.tolist()) == {0, 1, 2}
    for f in ("dens", "r", "m"):
        assert torch.equal(t3[f], t2[f])
    assert torch.equal(f3, f2)
