"""Gradients through the kernel routes K2, K3 and K4 in float32, their
twins running on CPU tensors, against the JAX package's gradients through
its Pallas kernels in interpret mode and against the port's plain route,
at the bar of tests/test_rhs_fused.py and tests/test_windowed.py (rtol
5e-4); and the entry points that stay forward only, as in the JAX
package: K1 and K6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.ops import projection_cuda, step_cuda_stream

torch.set_num_threads(1)

RTOL = 5e-4


def setup_f32(n, pad_to, **cfg_kw):
    """The f32 population of the JAX kernel tests: a Gaussian spectrum
    source padded with inactive slots, mxu backends, online saturation."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32",
        "projection_backend": "mxu", "interp_backend": "mxu", **cfg_kw})
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(cfg, bg, n, dtype=jnp.float32)
    rays, statics = mt.pad_rays(rays, statics, pad_to)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def tcfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def wind_change(final, state):
    return final.mean.u - state.mean.u


def jax_grads(run, state, theta_shape, observable=wind_change):
    """``jax.grad`` of sum(observable^2) in (scale, theta), the density
    scaled by ``scale * (1 + theta)``; ``run(state) -> final``, and the
    observable is the change of the wind unless given."""
    def loss(scale, theta):
        s = state._replace(rays=state.rays._replace(
            dens=state.rays.dens * scale * (1.0 + theta)))
        return jnp.sum(observable(run(s), state) ** 2)
    g_s, g_t = jax.grad(loss, argnums=(0, 1))(
        jnp.float32(1.0), jnp.zeros(theta_shape, jnp.float32))
    return float(g_s), np.asarray(g_t)


def torch_grads(run, state, theta_shape, observable=wind_change):
    """The same gradient through the port."""
    scale = torch.tensor(1.0, requires_grad=True)
    theta = torch.zeros(theta_shape, requires_grad=True)
    dens = state.rays.dens * scale * (1.0 + theta)
    final = run(state._replace(rays=state.rays._replace(dens=dens)))
    (observable(final, state) ** 2).sum().backward()
    return float(scale.grad), theta.grad.numpy()


def assert_grads_close(got, want):
    g_s, g_t = got
    w_s, w_t = want
    assert np.isfinite(g_s) and g_s != 0.0 and np.all(np.isfinite(g_t))
    np.testing.assert_allclose(g_s, w_s, rtol=RTOL)
    assert np.max(np.abs(g_t - w_t)) <= RTOL * np.max(np.abs(w_t))


def tendency(out, _):
    return out.mean.u


ROUTES = {
    # K2: full width, the generic RK3 over the fused RHS, 3 steps
    "K2": (dict(window_cells=0), 3),
    # K3: the windowed RHS, one call of ``rhs`` (the RK3 step takes K4)
    "K3": (dict(window_cells=16), 0),
    # K4: the windowed RHS with the RK3 stage fused in (Path A), 3 steps
    "K4": (dict(window_cells=16), 3),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kernel_route_gradient_matches_msgwam_tpu(route):
    """500 rays padded to 1024 through ``simulate`` (3 steps) or ``rhs``
    (one call) with ``rhs_backend="pallas"``: the kernel route's gradient
    against the JAX package's Pallas route (interpret mode) and the
    port's plain route."""
    cfg, bg, state, statics = setup_f32(500, 1024)
    kw, n_steps = ROUTES[route]
    cfgk = cfg.replace(rhs_backend="pallas", **kw)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    if n_steps:
        run = mt.RunConfig(dt=120.0, n_steps=n_steps, save_every=n_steps)
        trun = mtt.RunConfig(dt=120.0, n_steps=n_steps, save_every=n_steps)
        want = jax_grads(lambda s_: mt.simulate(s_, statics, bg, cfgk, run,
                                                validate=False)[0], state, 1024)
        call = lambda c: lambda s_: mtt.simulate(s_, st, b, tcfg(c), trun,
                                                 validate=False)[0]
        got, plain = (torch_grads(call(c), s, 1024) for c in (cfgk, cfg))
    else:
        want = jax_grads(lambda s_: mt.rhs(120.0, s_, statics, bg, cfgk),
                         state, 1024, tendency)
        call = lambda c: lambda s_: mtt.rhs(120.0, s_, st, b, tcfg(c))
        got, plain = (torch_grads(call(c), s, 1024, tendency)
                      for c in (cfgk, cfg))
    assert_grads_close(got, want)
    assert_grads_close(got, plain)


def test_kernel_entry_points_record_a_backward():
    """K2, K3 and K4 called directly: each float output carries a backward
    and the input's gradient matches the plain path's; with no input that
    needs one, the result is the kernel's own, with no graph."""
    from msgwam_tpu_torch.ops import rhs_cuda, rhs_cuda_windowed

    cfg, bg, state, statics = setup_f32(300, 512)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    cfg = tcfg(cfg)
    calls = {
        "K2": lambda s_: rhs_cuda.rhs_fused(120.0, s_, st, b,
                                            cfg.replace(window_cells=0))[1],
        "K3": lambda s_: rhs_cuda_windowed.rhs_fused_windowed(
            120.0, s_, st, b, cfg)[1],
        "K4": lambda s_: rhs_cuda_windowed.rk3_step_fused_windowed(
            120.0, s_, st, b, cfg).mean.u,
        "plain": lambda s_: mtt.rk3_step(120.0, s_, st, b, cfg).mean.u,
    }
    grads = {}
    for name, call in calls.items():
        m = s.rays.m.clone().requires_grad_(True)
        out = call(s._replace(rays=s.rays._replace(m=m)))
        assert out.grad_fn is not None, name
        (out ** 2).sum().backward()
        grads[name] = m.grad
        assert call(s).grad_fn is None, name
    for name in ("K2", "K3"):
        assert torch.equal(grads[name], grads["K2"]), name
    assert float(grads["K4"].abs().max()) > 0.0
    assert float((grads["K4"] - grads["plain"]).abs().max()) \
        <= RTOL * float(grads["plain"].abs().max())


FORWARD_ONLY = {
    "project_pallas": lambda s, st, b, cfg: projection_cuda.project_pallas(
        torch.stack([s.rays.dens, s.rays.dens]), s.rays.r - 0.5 * s.rays.dr,
        s.rays.r + 0.5 * s.rays.dr, torch.abs(st.dkk * st.dll * s.rays.dm),
        st.active, b.centers),
    "simulate_streaming": lambda s, st, b, cfg: step_cuda_stream.simulate_streaming(
        s, st, b, cfg.replace(cull=True, relaunch=True),
        mtt.RunConfig(dt=120.0, n_steps=1, save_every=1), source=(s.rays, st)),
    "simulate_resident_lifecycle": lambda s, st, b, cfg: mtt.simulate_resident(
        s, st, b, cfg.replace(cull=True),
        mtt.RunConfig(dt=120.0, n_steps=1, save_every=1)),
}


@pytest.mark.parametrize("entry", sorted(FORWARD_ONLY))
def test_k1_and_k6_stay_forward_only(entry):
    """K1 and K6 (also reached through ``simulate_resident`` with the
    lifecycle) raise when an input needs a gradient, naming the
    differentiable route, as ``jax.grad`` through the JAX package's
    ``project_pallas`` and streaming path fails."""
    cfg, bg, state, statics = setup_f32(300, 512)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    dens = s.rays.dens.clone().requires_grad_(True)
    s_grad = s._replace(rays=s.rays._replace(dens=dens))
    with pytest.raises(NotImplementedError,
                       match="forward only, as in the JAX package"):
        FORWARD_ONLY[entry](s_grad, st, b, tcfg(cfg))
    with torch.no_grad():
        FORWARD_ONLY[entry](s_grad, st, b, tcfg(cfg))
