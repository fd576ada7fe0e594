"""K7 (``simulate_streaming_ensemble``, Path E) and ``parallel.
ensemble_simulate``: each member of a one-launch ensemble against its own
single-member K6 run (tests/test_megakernel.py:331-488, 697-746), with two
256-ray tiles per member; with the lifecycle and per-member templates,
with a shared and a per-member wind; one case against JAX's
``simulate_streaming_ensemble`` (interpret mode); the ``scan`` and
``mega`` backends against each other; the rejections.  On the CPU each
launch runs the kernel's plain twin.  Tolerance 1e-5 relative to the
maximum, masks identical."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.models.backgrounds import tidal_shear
from msgwam_tpu.ops.step_pallas_stream import simulate_streaming_ensemble as jax_ens
from msgwam_tpu.parallel import stack_ensemble as jax_stack
from msgwam_tpu_torch.ops import step_cuda
from msgwam_tpu_torch.ops.step_cuda_stream import (simulate_streaming,
                                                   simulate_streaming_ensemble)
from msgwam_tpu_torch.parallel import (ensemble_simulate, initialize_distributed,
                                       make_mesh, stack_ensemble)
from msgwam_tpu_torch.parallel.distributed import shutdown

torch.set_num_threads(1)

E = 2
N = 500                  # two 256-ray tiles per member
TOL = 1e-5
M_MAX = np.pi / 1500.0
RUN = mtt.RunConfig(dt=120.0, n_steps=6, save_every=3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


def _jax_members(n=N, **cfg_kw):
    """tests/test_megakernel.py's members: gaussian spectra launched at 2 km
    with amplitudes 0.003 (1 + 0.2 e)."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32", "projection_backend": "mxu",
        "interp_backend": "mxu", "m_max": M_MAX, **cfg_kw})
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    members = []
    for e in range(E):
        rays, statics = mt.gaussian_spectrum_source(
            cfg, bg, n, z_launch=2000.0, dz_launch=500.0,
            amplitude_alpha=0.003 * (1 + 0.2 * e), dtype=jnp.float32)
        members.append((mt.State(rays, mt.MeanState(
            jnp.asarray(uu), jnp.zeros_like(jnp.asarray(uu)))), statics))
    return cfg, bg, members


def _members(**cfg_kw):
    cfg, bg, members = _jax_members(**cfg_kw)
    tcfg = mtt.ModelConfig(**dataclasses.asdict(cfg))
    return (tcfg, mtt.from_numpy(bg, device="cpu"),
            [mtt.from_numpy(m, device="cpu") for m in members])


def _tides(cfg, scales, device="cpu"):
    c = torch.tensor(mtt.GridConfig().centers(), dtype=torch.float32,
                     device=device)
    return [lambda t, s=s: (s * mtt.tidal_shear(c, t, cfg, period=43200.0 / s),
                            torch.zeros_like(c)) for s in scales]


CASES = {
    "plain": (dict(), {}),
    "lifecycle": (dict(cull=True, relaunch=True), dict(sources=True)),
    "shared_wind": (dict(cull=True, relaunch=True, prognostic_mean=False),
                    dict(sources=True, wind="shared")),
    "member_wind": (dict(prognostic_mean=False), dict(wind="member")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k7_members_match_their_own_runs(case):
    over, opts = CASES[case]
    cfg, bg, members = _members(**over)
    states, statics = stack_ensemble(members)
    kw = {}
    if opts.get("sources"):
        kw["sources"] = (states.rays, statics)
    winds = _tides(cfg, (1.0, 1.5))
    if opts.get("wind") == "shared":
        kw["wind_fn"] = winds[0]
    elif opts.get("wind") == "member":
        kw["wind_fn"] = winds
    fin, stf, mh = simulate_streaming_ensemble(states, statics, bg, cfg, RUN, **kw)
    assert mh.u.shape == (2, E, 100)
    for e, (s1, st1) in enumerate(members):
        one = {}
        if "sources" in kw:
            one["source"] = (s1.rays, st1)
        if "wind_fn" in kw:
            one["wind_fn"] = winds[e] if opts["wind"] == "member" else winds[0]
        f1, st1f, h1 = simulate_streaming(s1, st1, bg, cfg, RUN, **one)
        assert torch.equal(stf.active[e], st1f.active)
        for f in ("dens", "r", "m"):
            assert _rel(getattr(f1.rays, f), getattr(fin.rays, f)[e]) < TOL, f
        assert _rel(f1.mean.u, fin.mean.u[e]) < TOL
        assert _rel(h1[0].mean.u, mh.u[:, e]) < TOL
    if cfg.cull:
        _, cst, _ = simulate_streaming(*members[0], bg, cfg.replace(relaunch=False),
                                       RUN)
        assert int(cst.active.sum()) < N, "culls must fire"
    if opts.get("wind") == "member":
        assert _rel(fin.mean.u[0], fin.mean.u[1]) > 1e-3   # the winds differ


def test_k7_matches_jax_ensemble():
    """Cull, relaunch and a shared tidal wind against JAX's one-launch
    ensemble (interpret mode)."""
    jcfg, jbg, jmembers = _jax_members(cull=True, relaunch=True,
                                       prognostic_mean=False)
    jstates, jstatics = jax_stack(jmembers)
    cj = jnp.asarray(mt.GridConfig().centers(), jnp.float32)
    run = mt.RunConfig(dt=120.0, n_steps=4, save_every=2)
    want, wst, wmh = jax_ens(jstates, jstatics, jbg, jcfg, run, tile_rows=8,
                             sources=(jstates.rays, jstatics),
                             wind_fn=lambda t: (tidal_shear(cj, t, jcfg),
                                                jnp.zeros_like(cj)))
    cfg = mtt.ModelConfig(**dataclasses.asdict(jcfg))
    states, statics, bg = mtt.from_numpy((jstates, jstatics, jbg), device="cpu")
    wind = _tides(cfg, (1.0,))[0]
    got, gst, gmh = simulate_streaming_ensemble(
        states, statics, bg, cfg, mtt.RunConfig(dt=120.0, n_steps=4, save_every=2),
        sources=(states.rays, statics), wind_fn=wind)
    np.testing.assert_array_equal(gst.active.numpy(), np.asarray(wst.active))
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), getattr(got.rays, f)) < TOL, f
    assert _rel(want.mean.u, got.mean.u) < TOL
    assert _rel(wmh.u, gmh.u) < TOL


def test_ensemble_backends_agree():
    """``ensemble_simulate``: the ``mega`` backend (K7) against ``scan``
    (members through ``simulate`` one after another), with the lifecycle
    and a shared tidal wind; both histories member-leading."""
    cfg, bg, members = _members(cull=True, relaunch=True, prognostic_mean=False)
    cfg = cfg.replace(rhs_backend="pallas")
    states, statics = stack_ensemble(members)
    wind = _tides(cfg, (1.0,))[0]
    kw = dict(sources=(states.rays, statics), wind_fn=wind, t0=3600.0)
    mega = ensemble_simulate(states, statics, bg, cfg, RUN, backend="mega", **kw)
    scan = ensemble_simulate(states, statics, bg, cfg, RUN, backend="scan", **kw)
    assert torch.equal(mega[1].active, scan[1].active)
    for f in ("dens", "r", "m"):
        assert _rel(getattr(scan[0].rays, f), getattr(mega[0].rays, f)) < TOL, f
    assert mega[2].u.shape == scan[2].u.shape == (E, 2, 100)
    assert _rel(scan[2].u, mega[2].u) < TOL
    seq = ensemble_simulate(states, statics, bg, cfg, RUN, sequential=True, **kw)
    assert torch.equal(seq[0].rays.r, scan[0].rays.r)


def test_ensemble_rejections():
    cfg, bg, members = _members()
    states, statics = stack_ensemble(members)
    with pytest.raises(ValueError, match="source templates"):
        simulate_streaming_ensemble(states, statics, bg,
                                    cfg.replace(cull=True, relaunch=True), RUN)
    with pytest.raises(ValueError, match="online"):
        simulate_streaming_ensemble(states, statics, bg,
                                    cfg.replace(saturate_online=False), RUN)
    with pytest.raises(ValueError, match="callable"):
        simulate_streaming_ensemble(states, statics, bg, cfg.replace(relaunch=True),
                                    RUN, sources=lambda g: None)
    with pytest.raises(ValueError, match="per-member wind_fn"):
        simulate_streaming_ensemble(states, statics, bg, cfg, RUN,
                                    wind_fn=_tides(cfg, (1.0, 1.5, 2.0)))
    with pytest.raises(ValueError, match="observe"):
        ensemble_simulate(states, statics, bg, cfg, RUN, backend="mega",
                          observe=lambda s, st, aux: s.mean)
    with pytest.raises(ValueError, match="sequential"):
        ensemble_simulate(states, statics, bg, cfg, RUN, backend="mega",
                          sequential=True)
    with pytest.raises(ValueError, match="backend"):
        ensemble_simulate(states, statics, bg, cfg, RUN, backend="vmap")
    # the mesh route (a world of 1 here) keeps the mega backend's refusals
    assert not torch.distributed.is_initialized()
    initialize_distributed(device="cpu")
    try:
        with pytest.raises(ValueError, match="observe"):
            ensemble_simulate(states, statics, bg, cfg, RUN, backend="mega",
                              mesh=make_mesh(axis="ensemble"),
                              observe=lambda s, st, aux: s.mean)
    finally:
        shutdown()


@pytest.fixture
def cuda_device():
    """The card, for the tests that run a CUDA kernel; they skip without
    one (decided here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [False, True])
def test_k7_kernel_matches_twin_on_gpu(cuda_device, ordered, monkeypatch):
    """K7 with the lifecycle and per-member winds against its twin on the
    CPU: 3e-5 relative to the maximum, masks equal; with each member's
    tiles ordered before every launch (``step_cuda.tile_order`` with
    ``n_members``) and without."""
    monkeypatch.setattr(step_cuda, "ORDER_MIN_STEPS", 0)
    monkeypatch.setattr(step_cuda, "ORDER_MIN_RAYS", 0 if ordered else 1 << 40)
    cfg, bg, members = _members(cull=True, relaunch=True, prognostic_mean=False)
    states, statics = stack_ensemble(members)
    winds = _tides(cfg, (1.0, 1.5))
    want, wst, wmh = simulate_streaming_ensemble(
        states, statics, bg, cfg, RUN, sources=(states.rays, statics),
        wind_fn=winds)
    g = lambda tree: mtt.from_numpy(mtt.to_numpy(tree), device=cuda_device)
    gs, gst_in, gbg = g(states), g(statics), g(bg)
    got, gst, gmh = simulate_streaming_ensemble(
        gs, gst_in, gbg, cfg, RUN, sources=(gs.rays, gst_in),
        wind_fn=_tides(cfg, (1.0, 1.5), cuda_device))
    assert torch.equal(gst.active.cpu(), wst.active)
    for f in ("dens", "r", "m"):
        assert _rel(getattr(want.rays, f), getattr(got.rays, f).cpu()) < 3e-5, f
    assert _rel(wmh.u, gmh.u.cpu()) < 3e-5
