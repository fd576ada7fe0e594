"""The K2 fused-RHS kernel's twin and the port's RHS against msgwam_tpu:
the Pallas kernel (interpret mode, at most 2048 rays) and the composable
path on the mxu backends, at the float32 bar of tests/test_rhs_fused.py
(2e-5 relative to the maximum)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.models.rhs import rhs as jax_rhs
from msgwam_tpu_torch.models.rhs import rhs as torch_rhs
from msgwam_tpu_torch.ops import rhs_cuda

torch.set_num_threads(1)

TOL = 2e-5


@pytest.fixture
def cuda_device():
    """The card, for the tests that run a CUDA kernel; they skip without
    one (decided here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _setup(n=1500, pad_to=2048, spread=False, **cfg_kw):
    """The JAX test's population (gaussian source, padded with inactive
    slots); ``spread`` moves the rays to seeded random heights across (and
    beyond) the domain, so the interpolation and the deposit see every
    cell and both table ends."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32",
        "projection_backend": "mxu", "interp_backend": "mxu", **cfg_kw,
    })
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(cfg, bg, n, dtype=jnp.float32)
    if spread:
        rng = np.random.default_rng(21)
        rays = rays._replace(
            r=jnp.asarray(rng.uniform(-3e3, 103e3, n), jnp.float32),
            dr=jnp.asarray(rng.uniform(200.0, 2500.0, n), jnp.float32),
            l=jnp.asarray(rng.uniform(-2e-4, 2e-4, n), jnp.float32),
        )
    rays, statics = mt.pad_rays(rays, statics, pad_to)
    vv = 0.1 * np.roll(uu, 7)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    tcfg = mtt.ModelConfig(**dataclasses.asdict(cfg))
    return cfg, tcfg, bg, state, statics


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


def _port(state, statics, bg):
    return mtt.from_numpy((state, statics, bg), device="cpu")


SAT_MODES = [
    dict(saturate_online=True, faithful_saturation=True),
    dict(saturate_online=True, faithful_saturation=False),
    dict(saturate_online=False),
]


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("mode", range(len(SAT_MODES)))
def test_port_pallas_rhs_matches_msgwam_tpu(mode, spread):
    """``rhs(..., rhs_backend="pallas", window_cells=0)``: the port (K2's
    twin on CPU tensors) against the Pallas kernel in interpret mode and
    against the composable path on the mxu backends."""
    cfg, tcfg, bg, state, statics = _setup(spread=spread, **SAT_MODES[mode])
    pcfg = cfg.replace(rhs_backend="pallas", window_cells=0)
    want_pallas = jax_rhs(120.0, state, statics, bg, pcfg)
    want_xla = jax_rhs(120.0, state, statics, bg, cfg)
    s, st, b = _port(state, statics, bg)
    got = torch_rhs(120.0, s, st, b, tcfg.replace(rhs_backend="pallas",
                                                  window_cells=0))
    for want in (want_pallas, want_xla):
        for f in ("r", "m") + (("dens",) if cfg.saturate_online else ()):
            assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < TOL, f
        assert _rel(want.mean.u, got.mean.u) < TOL
        assert _rel(want.mean.v, got.mean.v) < TOL
    # structural zeros: frozen fields are never materialised
    frozen = ("lam", "phi", "dr", "k", "l", "dm") + \
        (() if cfg.saturate_online else ("dens",))
    for f in frozen:
        assert getattr(got.rays, f) == 0.0 and isinstance(getattr(got.rays, f), float)
    # inactive (padded) slots get exactly zero tendencies
    n_live = int(np.asarray(statics.active).sum())
    for f in ("r", "m", "dens"):
        t = getattr(got.rays, f)
        if not isinstance(t, float):
            assert torch.all(t[n_live:] == 0)


@pytest.mark.parametrize("mode", range(len(SAT_MODES)))
def test_k2_twin_matches_msgwam_tpu_xla(mode):
    """The twin's raw outputs (tendencies, interior flux) against the
    composable JAX RHS on the mxu backends, and the port's own composable
    RHS against it."""
    cfg, tcfg, bg, state, statics = _setup(spread=True, **SAT_MODES[mode])
    want = jax_rhs(120.0, state, statics, bg, cfg)
    s, st, b = _port(state, statics, bg)
    tend, flux = rhs_cuda.rhs_fused_reference(120.0, s, st, b, tcfg)
    assert flux.shape == (2, 99) and flux.dtype == torch.float32
    assert _rel(want.rays.r, tend["r"]) < TOL
    assert _rel(want.rays.m, tend["m"]) < TOL
    if cfg.saturate_online:
        assert _rel(want.rays.dens, tend["dens"]) < TOL
    else:
        assert torch.all(tend["dens"] == 0)
    got_xla = torch_rhs(120.0, s, st, b, tcfg)
    for f in ("r", "m") + (("dens",) if cfg.saturate_online else ()):
        assert _rel(getattr(want.rays, f), getattr(got_xla.rays, f)) < TOL
    assert _rel(want.mean.u, got_xla.mean.u) < TOL
    # the float64 twin is the same function at another precision
    s64, st64, b64 = mtt.from_numpy((state, statics, bg), dtype="float64", device="cpu")
    tend64, flux64 = rhs_cuda.rhs_fused_reference(120.0, s64, st64, b64, tcfg)
    assert flux64.dtype == torch.float64
    assert _rel(flux64, flux) < TOL


def test_pallas_rhs_windowed_raises():
    """The fused kernels take float32 only: a float64 state raises on the
    full-width (K2) and the windowed (K3, the default ``window_cells=-1``)
    route alike, never a silent cast."""
    cfg, tcfg, bg, state, statics = _setup(n=16, pad_to=16)
    s64, st64, b64 = mtt.from_numpy((state, statics, bg), dtype="float64", device="cpu")
    for window_cells in (-1, 0):
        with pytest.raises(TypeError, match="float32"):
            torch_rhs(120.0, s64, st64, b64,
                      tcfg.replace(rhs_backend="pallas",
                                   window_cells=window_cells))
    with pytest.raises(TypeError):
        rhs_cuda.rhs_fused(120.0, s64, st64, b64, tcfg)


@pytest.mark.cuda
def test_k2_kernel_matches_twin_on_gpu(cuda_device):
    for mode in SAT_MODES:
        cfg, tcfg, bg, state, statics = _setup(n=100_000, pad_to=100_123,
                                               spread=True, **mode)
        s, st, b = mtt.from_numpy((state, statics, bg), device=cuda_device)
        before = rhs_cuda.LAUNCHES
        tend, flux = rhs_cuda.rhs_fused(120.0, s, st, b, tcfg)
        tend2, flux2 = rhs_cuda.rhs_fused(120.0, s, st, b, tcfg)
        torch.cuda.synchronize()
        assert rhs_cuda.LAUNCHES == before + 2
        twin, twin_flux = rhs_cuda.rhs_fused_reference(120.0, s, st, b, tcfg)
        for f in ("dens", "r", "m"):
            assert _rel(twin[f].cpu(), tend[f].cpu()) < TOL, f
            assert torch.equal(tend[f], tend2[f])
        assert _rel(twin_flux.cpu(), flux.cpu()) < TOL
        assert torch.equal(flux, flux2)


@pytest.mark.parametrize("mode", range(len(SAT_MODES)))
def test_k2_twin_flux_against_its_float64_twin(mode):
    """On the launch population the float32 twin's flux, each product
    rounded to float32 and summed in float64 by the kernel's block plan,
    is within 1e-6 of the float64 twin's maximum (the deposit bar of
    tests/test_projection.py)."""
    cfg, tcfg, bg, state, statics = _setup(n=20_000, pad_to=20_480,
                                           **SAT_MODES[mode])
    s, st, b = _port(state, statics, bg)
    _, flux = rhs_cuda.rhs_fused_reference(120.0, s, st, b, tcfg)
    s64, st64, b64 = mtt.from_numpy((state, statics, bg), dtype="float64",
                                    device="cpu")
    _, flux64 = rhs_cuda.rhs_fused_reference(120.0, s64, st64, b64, tcfg)
    assert _rel(flux64, flux) < 1e-6
