"""Gradients through the port's ``simulate`` against ``jax.grad`` through
msgwam_tpu's, in float64 on the same inputs: the setups of
tests/test_autodiff.py with online and offline saturation, ``hprop`` off
and on; ``remat`` True and ``"full"`` as pure memory schedules (the same
forward bit for bit, the same gradient), also with a keyed source drawn
from a ``torch.Generator`` that a replay must rewind; and the 100-step
offline gradient against central finite differences."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt

torch.set_num_threads(1)


def _tcfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def _trun(run):
    return mtt.RunConfig(**dataclasses.asdict(run))


def _setup(online: bool, hprop: bool, n_ray: int):
    """tests/test_autodiff.py's setups: online saturation with kappa = 1e9
    (``_setup``), or the reference run's offline saturation
    (``test_full_run_gradient_matches_fd``)."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(hprop=hprop)
    if online:
        cfg = cfg.replace(saturate_online=True, kappa=1e9)
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(gc.centers()), cfg))
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu))
    rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=n_ray)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.zeros(100)))
    return cfg, bg, state, statics


def _torch_loss(s, st, b, cfg, run, **kw):
    """loss(scale, theta) = sum((u_final - u0)^2) with the density scaled
    by ``scale * (1 + theta)`` (theta per ray)."""
    def loss(scale, theta):
        dens = s.rays.dens * scale * (1.0 + theta)
        s1 = s._replace(rays=s.rays._replace(dens=dens))
        final, _, hist = mtt.simulate(s1, st, b, cfg, run, validate=False, **kw)
        return ((final.mean.u - s.mean.u) ** 2).sum(), final, hist
    return loss


def _torch_grad(loss, n_ray):
    scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    theta = torch.zeros(n_ray, dtype=torch.float64, requires_grad=True)
    value, final, hist = loss(scale, theta)
    value.backward()
    return value, scale.grad, theta.grad, final, hist


CASES = {
    f"{'online' if online else 'offline'}_hprop_{hprop}": (online, hprop)
    for online in (True, False) for hprop in (False, True)
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_gradient_matches_jax(case):
    """d loss / d scale and d loss / d theta (a per-ray density factor)
    through 20 steps, against ``jax.grad`` at 1e-10; ``hprop=True`` runs
    the composable path with horizontal propagation on."""
    online, hprop = CASES[case]
    n_ray = 20 if online else 60
    cfg, bg, state, statics = _setup(online, hprop, n_ray)
    run = mt.RunConfig(dt=120.0, n_steps=20, save_every=10)
    u0 = state.mean.u

    def jax_loss(scale, theta):
        s = state._replace(rays=state.rays._replace(
            dens=state.rays.dens * scale * (1.0 + theta)))
        final, _, _ = mt.simulate(s, statics, bg, cfg, run, validate=False)
        return jnp.sum((final.mean.u - u0) ** 2)

    want_s, want_t = jax.grad(jax_loss, argnums=(0, 1))(1.0, jnp.zeros(n_ray))
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    _, g_s, g_t, _, _ = _torch_grad(
        _torch_loss(s, st, b, _tcfg(cfg), _trun(run)), n_ray)
    assert float(g_s) != 0.0 and bool(torch.isfinite(g_t).all())
    np.testing.assert_allclose(float(g_s), float(want_s), rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(want_t), rtol=1e-10,
                               atol=1e-10 * float(np.max(np.abs(want_t))))


def _keyed_relaunch_setup():
    """The online setup with cull and relaunch from a keyed Gaussian
    source: ``m_max`` below the packet's |m| culls every ray after the
    first step, and the draws with |m| above it again after theirs, so
    every block relaunches from fresh templates."""
    cfg, bg, state, statics = _setup(True, False, 20)
    cfg = cfg.replace(cull=True, relaunch=True, m_max=1.2e-3)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    tcfg = _tcfg(cfg)

    def source(key):
        return mtt.gaussian_spectrum_source(tcfg, b, 20, dtype=torch.float64,
                                            key=key)
    return tcfg, s, st, b, source


@pytest.mark.parametrize("keyed", [False, True])
def test_remat_is_a_memory_schedule(keyed):
    """``remat=True`` and ``"full"`` give the forward of the plain loop bit
    for bit (final state and history) and its gradient within 1e-12,
    with a loss that reads a history frame too.  With a keyed source the
    checkpoint's replay must draw the same templates again: the
    Generator is rewound for it."""
    run = mtt.RunConfig(dt=120.0, n_steps=20, save_every=5)
    if keyed:
        cfg, s, st, b, source = _keyed_relaunch_setup()
    else:
        cfg, bg, state, statics = _setup(True, False, 20)
        s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
        cfg = _tcfg(cfg)
    results = {}
    for remat in (False, True, "full"):
        kw = {"remat": remat}
        if keyed:
            kw.update(source=source,
                      source_key=torch.Generator().manual_seed(5))
        loss = _torch_loss(s, st, b, cfg, run, **kw)

        def with_frame(scale, theta, loss=loss):
            value, final, hist = loss(scale, theta)
            return value + 1e-3 * (hist[0].rays.r[0] ** 2).sum(), final, hist
        results[remat] = _torch_grad(with_frame, 20)
    value, g_s, g_t, final, hist = results[False]
    assert float(g_s) != 0.0
    if keyed:
        # the draws reach the result: another seed gives another run
        with torch.no_grad():
            other, _, _ = mtt.simulate(s, st, b, cfg, run, source=source,
                                       source_key=torch.Generator().manual_seed(6))
        assert not torch.equal(other.rays.r, final.rays.r)
    for remat in (True, "full"):
        v, gs, gt, f, h = results[remat]
        assert torch.equal(v, value), remat
        for a, c in zip(mtt.to_numpy((final, hist)), mtt.to_numpy((f, h))):
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(c)):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(float(gs), float(g_s), rtol=1e-12)
        np.testing.assert_allclose(gt.numpy(), g_t.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(g_t.abs().max()))


def test_full_run_gradient_matches_finite_differences():
    """The 100-step offline reference run with ``remat="full"``: the
    gradient in the per-ray density factor theta, along three seeded
    directions, against central finite differences at rtol 5e-5 (as
    tests/test_autodiff.py::test_full_run_gradient_matches_fd)."""
    cfg, bg, state, statics = _setup(False, False, 60)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    run = mtt.RunConfig(dt=120.0, n_steps=100, save_every=10)
    loss = _torch_loss(s, st, b, _tcfg(cfg), run, remat="full")
    _, _, g, _, _ = _torch_grad(loss, 60)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
    one = torch.tensor(1.0, dtype=torch.float64)
    rng = np.random.default_rng(0)
    eps = 1e-5
    with torch.no_grad():
        for _ in range(3):
            d = rng.standard_normal(60)
            d = torch.tensor(d / np.linalg.norm(d))
            fd = (loss(one, eps * d)[0] - loss(one, -eps * d)[0]) / (2 * eps)
            np.testing.assert_allclose(float(g @ d), float(fd), rtol=5e-5,
                                       atol=1e-12)
