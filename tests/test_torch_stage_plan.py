"""The block plan and flux sum of the per-stage kernels K2-K4, the twin of
K4's in-kernel wind update, and the port's device default, checked on the
CPU: the plan mirror against the rule of ``csrc/rhs_windowed.cu``, the
twin's sum order against a direct float64 sum, the wind update bitwise
against the torch glue it replaced, the diagnostics' view of the plan,
and the builders, which put their tensors on the card unless asked for
another device."""

import re

import numpy as np
import pytest
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch import _build
from msgwam_tpu_torch.diagnostics import stage_partials
from msgwam_tpu_torch.ops import ray_physics, rhs_cuda, rhs_cuda_windowed
from msgwam_tpu_torch.state import coriolis

torch.set_num_threads(1)


def _population(n, dtype=torch.float32, spread=None, seed=5):
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(saturate_online=True, dtype="float32",
                                           rhs_backend="pallas")
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(torch.tensor(gc.centers(), dtype=dtype),
                                         cfg)
    vv = 0.1 * torch.roll(uu, 7)
    bg = mtt.make_background(gc, cfg, uu, vv, dtype=dtype, device="cpu")
    rays, statics = mtt.gaussian_spectrum_source(cfg, bg, n, dtype=dtype,
                                                 z_launch=2000.0, dz_launch=500.0)
    if spread is not None:
        rng = np.random.default_rng(seed)
        r = torch.tensor(rng.uniform(*spread, n), dtype=dtype)
        rays = rays._replace(r=r)
    return cfg, bg, mtt.State(rays, mtt.MeanState(uu, vv)), statics


def _source_constant(name):
    text = (_build.SRC_DIR / "rhs_windowed.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plan_constants_are_the_kernels():
    assert ray_physics.STAGE_BLOCKS_PER_SM == _source_constant("kStageBlocksPerSm")
    assert ray_physics.MAX_REDUCERS == _source_constant("kMaxReducers")
    assert ray_physics.TILE == 256


@pytest.mark.parametrize("n, n_flux, sms, want", [
    (1, 99, 132, (1, 1)),
    (256, 99, 132, (1, 1)),
    (257, 99, 132, (2, 2)),
    (100_000, 99, 132, (391, 100)),
    (135_168, 99, 132, (528, 100)),
    (1_000_000, 99, 132, (528, 100)),
    (1_000_000, 99, 114, (456, 100)),
    (1_000_000, 1024, 132, (528, 256)),
    (10_000, 24, 2, (8, 8)),
    (100_000, 24, 132, (391, 25)),
])
def test_stage_plan(n, n_flux, sms, want):
    """One block per 256-ray tile up to 4 per SM; one reducer per wind
    cell, at most 256 and at most the blocks."""
    assert tuple(ray_physics.stage_plan(n, n_flux, sms)) == want


def test_tile_blocks_round_robin():
    plan = ray_physics.stage_plan(10 * 256 + 3, 99, sms=1)   # 4 blocks, 11 tiles
    assert plan.blocks == 4
    assert ray_physics.tile_blocks(10 * 256 + 3, plan).tolist() == \
        [0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2]


def _kernel_order(parts):
    """A reducer's order for one entry, written out: thread t of a group of
    64 adds blocks t, t + 64, ... in order; each of the group's two warps
    combines by xor 16, 8, 4, 2, 1; then warp 0's sum plus warp 1's."""
    nb, ne = parts.shape
    out = []
    for e in range(ne):
        threads = [0.0] * 64
        for b in range(nb):
            threads[b % 64] += float(parts[b, e])
        warps = []
        for w in range(2):
            lanes = threads[32 * w:32 * w + 32]
            for off in (16, 8, 4, 2, 1):
                lanes = [lanes[l] + lanes[l ^ off] for l in range(32)]
            warps.append(lanes[0])
        out.append(warps[0] + warps[1])
    return torch.tensor(out, dtype=torch.float64)


@pytest.mark.parametrize("nb", [1, 7, 32, 33, 64, 65, 391, 528])
def test_sum_blocks_is_the_kernel_order(nb):
    rng = np.random.default_rng(nb)
    parts = torch.tensor(rng.lognormal(0.0, 3.0, (nb, 6))
                         * rng.choice([-1.0, 1.0], (nb, 6)))
    assert torch.equal(ray_physics.sum_blocks(parts), _kernel_order(parts))


@pytest.mark.parametrize("n, sms", [(3000, 132), (70_000, 132), (70_000, 8)])
def test_twin_flux_against_a_direct_float64_sum(n, sms):
    """In float64 the twin's flux, summed block by block in the kernel's
    order, is a direct float64 sum of the same overlap weights to 1e-12
    relative to its maximum, with one tile per block and with nine."""
    cfg, bg, state, statics = _population(n, torch.float64, spread=(0.0, 101e3))
    params, (dt, bvf, _, _), tables = rhs_cuda.prepare_inputs(
        120.0, state, statics, bg, cfg)
    g = ray_physics.geometry(params, tables[2].shape[0])
    rt = ray_physics.ray_terms(rhs_cuda.ray_fields(state, statics),
                               statics.active, g, dt, bvf)
    plan = ray_physics.stage_plan(n, g.n_flux, sms)
    got = ray_physics.deposit(rt, g, plan)
    c = torch.arange(g.n_flux, dtype=torch.float64)
    lo_face = g.g0c + c * g.dz
    w = torch.abs(torch.minimum(lo_face + g.dz, rt.r_up[:, None])
                  - torch.maximum(lo_face, rt.r_lo[:, None]))
    span = (c >= rt.nlow[:, None]) & (c < rt.nup[:, None])
    w = torch.where(span, w, 0.0)
    want = torch.stack([(w * rt.fvk[:, None]).sum(0), (w * rt.fvl[:, None]).sum(0)])
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    assert int(rt.live.sum()) > n // 2


def _glue(flux, u, v, qu, qv, pg, rhobar, dzf, ff0, dt, stage):
    """The wind's stage update as the torch glue computed it after each K4
    launch before the kernel took it over (``rhs_pallas_windowed.py:
    492-508``)."""
    cc, bc, first = stage
    pm_flux = torch.cat([flux[:, :1], flux, flux[:, -1:]], dim=1)
    grad = (pm_flux[:, 1:] - pm_flux[:, :-1]) / dzf
    du_st = ff0 * v - (pg[0] + grad[0]) / rhobar
    dv_st = -ff0 * u - (pg[1] + grad[1]) / rhobar
    u, qu = ray_physics.rk3_stage(du_st, u, qu, dt, cc, bc, first)
    v, qv = ray_physics.rk3_stage(dv_st, v, qv, dt, cc, bc, first)
    return u, v, qu, qv


def test_twin_wind_update_is_the_glue_bitwise():
    """Three stages of the twin's wind update (the order of operations of
    K4's last block) against the glue, bitwise in float32: u, v, qu, qv."""
    cfg, bg, state, _ = _population(10)
    rng = np.random.default_rng(3)
    u, v = state.mean
    dzf = bg.faces[1] - bg.faces[0]
    ff0 = coriolis(cfg.phi0)
    a = b = (u, v, None, None)
    for stage in ray_physics.RK3_STAGES:
        flux = torch.tensor(rng.normal(0.0, 1e-3, (2, 99)), dtype=torch.float32)
        a = ray_physics.wind_stage(flux, *a, bg.pressure_gradient, bg.rhobar,
                                   dzf, ff0, 120.0, *stage)
        b = _glue(flux, *b, bg.pressure_gradient, bg.rhobar, dzf, ff0, 120.0,
                  stage)
        for x, y in zip(a, b):
            assert x.dtype == torch.float32 and torch.equal(x, y)
    assert not torch.equal(a[0], u)


def test_k4_twin_step_wind_is_the_glue_bitwise():
    """A whole K4 twin step against the same step with the glue's wind
    update after each stage's ray update: bitwise in every field."""
    cfg, bg, state, statics = _population(3000, spread=(1e3, 30e3))
    cfg = cfg.replace(window_cells=-1)
    got = rhs_cuda_windowed.rk3_step_fused_windowed_reference(120.0, state,
                                                              statics, bg, cfg)
    inp = rhs_cuda.inputs(120.0, state, statics, bg, cfg)
    fields = list(inp.fields)
    u, v = state.mean
    q = qu = qv = None
    for stage in ray_physics.RK3_STAGES:
        ys, q, flux, _ = rhs_cuda_windowed.stage_reference(
            inp._replace(prognostic=False), fields, q, u, v, None, stage)
        u, v, qu, qv = _glue(flux, u, v, qu, qv, bg.pressure_gradient, bg.rhobar,
                             bg.faces[1] - bg.faces[0], coriolis(cfg.phi0), 120.0,
                             stage)
        fields[0], fields[1], fields[5] = ys
    for x, y in zip((got.rays.dens, got.rays.r, got.rays.m, *got.mean),
                    (fields[0], fields[1], fields[5], u, v)):
        assert torch.equal(x, y)


def test_stage_partials_mirror_the_plan():
    """The diagnostics' per-block cell ranges: the union of each block's
    tiles' live deposit spans under the plan, as a direct loop finds them."""
    cfg, bg, state, statics = _population(5000, spread=(1e3, 60e3))
    sp = stage_partials(120.0, state, statics, bg, cfg, sms=2)
    assert tuple(sp.plan) == (8, 8)
    params, (dt, bvf, _, _), tables = rhs_cuda.prepare_inputs(
        120.0, state, statics, bg, cfg)
    rt = ray_physics.ray_terms(rhs_cuda.ray_fields(state, statics), statics.active,
                               ray_physics.geometry(params, 100), dt, bvf)
    for b in range(8):
        rays = [i for i in range(5000) if (i // 256) % 8 == b and bool(rt.live[i])]
        assert int(sp.lo[b]) == min(int(rt.nlow[i]) for i in rays)
        assert int(sp.hi[b]) == max(int(rt.nup[i]) for i in rays)
    assert int(sp.entries) == 2 * int((sp.hi - sp.lo).sum())


def _builders():
    cfg = mtt.REFERENCE_RUN_CONFIG
    gc = mtt.GridConfig()
    uu = np.zeros(gc.n_cell)
    bg = mtt.make_background(gc, cfg, uu, uu, device="cpu")
    return {
        "make_background": lambda **kw: mtt.make_background(gc, cfg, uu, uu, **kw),
        "wave_packet_ic": lambda **kw: mtt.wave_packet_ic(gc, cfg, bg, **kw)[0],
        "from_numpy": lambda **kw: mtt.from_numpy(
            mtt.MeanState(uu, uu), **kw),
    }


@pytest.mark.parametrize("name", ["make_background", "wave_packet_ic",
                                  "from_numpy"])
def test_builders_default_to_the_card(name):
    """Without ``device=`` a builder puts its tensors on the card, and on a
    machine without one it raises, naming the card; with ``device="cpu"``
    it runs on the CPU."""
    build = _builders()[name]
    if torch.cuda.is_available():
        assert build()[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert build(device="cpu")[0].device.type == "cpu"


def test_gaussian_source_follows_the_background():
    cfg = mtt.REFERENCE_RUN_CONFIG
    gc = mtt.GridConfig()
    bg = mtt.make_background(gc, cfg, np.zeros(gc.n_cell), np.zeros(gc.n_cell),
                             device="cpu")
    rays, statics = mtt.gaussian_spectrum_source(cfg, bg, 10)
    assert rays.r.device.type == statics.active.device.type == "cpu"
