"""The port's configuration, state containers, backgrounds and sources
against msgwam_tpu on the same inputs."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.models import backgrounds as jbg
from msgwam_tpu_torch.models import backgrounds as tbg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["ModelConfig", "GridConfig", "RunConfig"])
def test_config_fields_and_defaults_match(name):
    a, b = getattr(mt, name), getattr(mtt, name)
    fa = [(f.name, f.default) for f in dataclasses.fields(a)]
    fb = [(f.name, f.default) for f in dataclasses.fields(b)]
    assert fa == fb


def test_reference_run_config_matches():
    assert dataclasses.asdict(mt.REFERENCE_RUN_CONFIG) == \
        dataclasses.asdict(mtt.REFERENCE_RUN_CONFIG)
    g = mtt.GridConfig()
    assert (g.n_cell, g.dz) == (mt.GridConfig().n_cell, mt.GridConfig().dz)


def _winds(cfg, gc):
    uu = np.asarray(jbg.velocities_sine_homogeneous(
        jnp.asarray(gc.centers()), cfg))
    return uu, np.zeros_like(uu)


@pytest.mark.parametrize("boussinesq", [False, True])
def test_make_background_bitwise(boussinesq):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(boussinesq=boussinesq, phi0=0.4)
    gc = mt.GridConfig()
    uu, vv = _winds(cfg, gc)
    vv = 0.3 * uu
    a = mt.make_background(gc, cfg, uu, vv)
    b = mtt.make_background(mtt.GridConfig(), mtt.ModelConfig(
        **dataclasses.asdict(cfg)), torch.tensor(uu), vv, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_wave_packet_ic_bitwise():
    cfg = mt.REFERENCE_RUN_CONFIG
    gc = mt.GridConfig()
    uu, vv = _winds(cfg, gc)
    bga = mt.make_background(gc, cfg, uu, vv)
    bgb = mtt.make_background(mtt.GridConfig(), mtt.REFERENCE_RUN_CONFIG, uu, vv,
                              device="cpu")
    ra, sa = mt.wave_packet_ic(gc, cfg, bga, n_ray=60)
    rb, sb = mtt.wave_packet_ic(mtt.GridConfig(), mtt.REFERENCE_RUN_CONFIG,
                                bgb, n_ray=60, device="cpu")
    for x, y in zip((*ra, *sa), (*rb, *sb)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gaussian_spectrum_source_matches(dtype):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(saturate_online=True, phi0=0.3)
    gc = mt.GridConfig()
    uu, vv = _winds(cfg, gc)
    bga = mt.make_background(gc, cfg, uu, vv, dtype=getattr(jnp, dtype))
    bgb = mtt.from_numpy(bga, device="cpu")
    kw = dict(z_launch=2000.0, dz_launch=500.0, amplitude_alpha=0.003)
    ra, sa = mt.gaussian_spectrum_source(cfg, bga, 777, dtype=getattr(jnp, dtype),
                                         **kw)
    rb, sb = mtt.gaussian_spectrum_source(
        mtt.ModelConfig(**dataclasses.asdict(cfg)), bgb, 777,
        dtype=getattr(torch, dtype), **kw)
    # float32: linspace endpoints may differ by an ulp between jnp and
    # torch, and dens ~ 1/m^2 amplifies that a few times
    rtol = 1e-14 if dtype == "float64" else 1e-5
    for x, y in zip((*ra, *sa), (*rb, *sb)):
        x = np.asarray(x)
        assert y.dtype == (torch.bool if x.dtype == bool else getattr(torch, dtype))
        np.testing.assert_allclose(y.numpy(), x, rtol=rtol, atol=0)
    # a keyed draw changes only m, r and dens: its other fields are JAX's
    kr, ks = mtt.gaussian_spectrum_source(
        mtt.ModelConfig(**dataclasses.asdict(cfg)), bgb, 777,
        dtype=getattr(torch, dtype), key=torch.Generator().manual_seed(1), **kw)
    jr, js = mt.gaussian_spectrum_source(cfg, bga, 777, dtype=getattr(jnp, dtype),
                                         key=jax.random.PRNGKey(1), **kw)
    for f in ("lam", "phi", "dr", "k", "l", "dm"):
        np.testing.assert_array_equal(getattr(kr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    for x, y in zip(js, ks):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert kr.m.dtype == getattr(torch, dtype) and not torch.equal(kr.m, rb.m)


@pytest.mark.parametrize("profile", [
    "velocities_tanh_homogeneous", "velocities_gauss_homogeneous",
    "velocities_sine_homogeneous",
])
def test_wind_profiles_match(profile):
    cfg = mt.ModelConfig()
    z = np.linspace(0.0, 100e3, 257)
    a = np.asarray(getattr(jbg, profile)(jnp.asarray(z), cfg))
    b = getattr(tbg, profile)(torch.from_numpy(z), mtt.ModelConfig()).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)


def test_tanh_jet_and_tide_match():
    cfg = mt.ModelConfig()
    rng = np.random.default_rng(7)
    lam, phi, rr = (rng.uniform(-1, 1, 50), rng.uniform(-1.2, -0.9, 50),
                    rng.uniform(0, 1e5, 50))
    a = np.asarray(jbg.velocities_tanh(jnp.asarray(lam), jnp.asarray(phi),
                                       jnp.asarray(rr), cfg))
    t = torch.from_numpy
    b = tbg.velocities_tanh(t(lam), t(phi), t(rr), mtt.ModelConfig()).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-14)
    a = np.asarray(jbg.tidal_shear(jnp.asarray(rr), 3600.0, cfg))
    b = tbg.tidal_shear(t(rr), 3600.0, mtt.ModelConfig()).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)


def test_from_numpy_round_trip():
    cfg = mt.REFERENCE_RUN_CONFIG
    gc = mt.GridConfig()
    uu, vv = _winds(cfg, gc)
    bg = mt.make_background(gc, cfg, uu, vv)
    rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=60)
    rays, statics = mt.pad_rays(rays, statics, 64)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    assert isinstance(s, mtt.State) and isinstance(st, mtt.RayStatics)
    assert isinstance(b, mtt.Background) and st.active.dtype == torch.bool
    back = mtt.to_numpy((s, st, b))
    for x, y in zip(jax_leaves((state, statics, bg)), jax_leaves(back)):
        np.testing.assert_array_equal(np.asarray(x), y)
    s32 = mtt.from_numpy(state, dtype="float32", device="cpu")
    assert s32.rays.r.dtype == torch.float32
    # pad_rays of the port pads exactly as msgwam_tpu's
    r0, s0 = mt.wave_packet_ic(gc, cfg, bg, n_ray=60)
    pr, ps = mtt.pad_rays(*mtt.from_numpy((r0, s0), device="cpu"), 64)
    for x, y in zip(jax_leaves((rays, statics)), jax_leaves((pr, ps))):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def jax_leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for child in tree for leaf in jax_leaves(child)]
    return [tree]


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import msgwam_tpu_torch, msgwam_tpu_torch.ops.rhs_cuda, "
            "msgwam_tpu_torch.ops.projection_cuda, msgwam_tpu_torch.cli, "
            "msgwam_tpu_torch.api, msgwam_tpu_torch.diagnostics, "
            "msgwam_tpu_torch.plotting, msgwam_tpu_torch.utils.checkpoint, "
            "msgwam_tpu_torch.utils.metrics, "
            "msgwam_tpu_torch.utils.profiling, "
            "msgwam_tpu_torch.utils.history_io, "
            "msgwam_tpu_torch.parallel.sharding, "
            "msgwam_tpu_torch.parallel.distributed, "
            "msgwam_tpu_torch.ops.collective; "
            "assert 'msgwam_tpu' not in sys.modules; "
            "assert 'matplotlib' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
