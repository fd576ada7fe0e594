"""Time integration: the counterpart of :mod:`msgwam_tpu.models.integrate`.

Williamson low-storage RK3 with the reference's stage arithmetic
(including the full ``dt`` passed to every stage's RHS), the per-step
driver with *offline* saturation, and :func:`simulate`, a Python loop over
steps with history decimation.  PyTorch runs eagerly, so the loop is the
JAX package's ``lax.scan`` written out.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import torch

from ..config import ModelConfig, RunConfig
from ..ops.projection import required_span
from ..ops.saturation import saturate_direct
from ..state import Background, RayStatics, State, torch_dtype, tree_axpy, tree_map
from .rhs import rhs as rhs_default


def validate_inputs(state: State, statics: RayStatics, bg: Background,
                    cfg: ModelConfig) -> None:
    """Host-side checks run once per :func:`simulate`: the state and
    background dtype must match ``cfg.dtype``, and the ``xla`` scatter's
    ``max_span`` must cover the widest active ray (the scatter would
    otherwise drop part of its deposit).  The span check reads one value
    from the device."""
    n = state.rays.dens.shape[0]
    if (cfg.dtype == "float32" and cfg.projection_backend == "mxu"
            and cfg.rhs_backend != "pallas" and cfg.flux_accum == "native"
            and n >= 65536):
        warnings.warn(
            f"flux_accum='native' at {n} f32 rays exceeds the 1e-6 "
            f"deposit-error target; use flux_accum='compensated' or the "
            f"pallas backend for accurate fast runs",
            stacklevel=3,
        )

    want = torch_dtype(cfg.dtype)
    for name, arr in (("state.rays.dens", state.rays.dens),
                      ("state.mean.u", state.mean.u),
                      ("background.rhobar", bg.rhobar)):
        if arr.dtype != want:
            got = str(arr.dtype).removeprefix("torch.")
            raise TypeError(
                f"{name} has dtype {got} but cfg.dtype={cfg.dtype!r}; "
                f"build the state/background with the configured dtype or "
                f"set cfg.replace(dtype={got!r})"
            )

    if cfg.projection_backend == "xla" and bool(statics.active.any()):
        dz = float(bg.faces[1] - bg.faces[0])
        dr_max = float(state.rays.dr[statics.active].max())
        need = required_span(dr_max, dz)
        if need > cfg.max_span:
            raise ValueError(
                f"cfg.max_span={cfg.max_span} but the widest active ray "
                f"volume (dr={dr_max:g} m, dz={dz:g} m) spans {need} "
                f"cells; the xla projection backend would silently drop "
                f"part of its flux deposit.  Raise cfg.max_span to "
                f">= {need} (or use the dense 'mxu' backend, which has "
                f"no span bound)."
            )


def _scale(s):
    """Leaf-wise ``s * t``; a structural zero stays a float."""
    return lambda t: s * t


def williamson_rk3(f: Callable, y, dt):
    """3-stage Williamson low-storage RK3 over a state tree:

        q = dt f(y);             y += q/3
        q = dt f(y) − 5/9 q;     y += 15/16 q
        q = dt f(y) − 153/128 q; y += 8/15 q
    """
    q = tree_map(_scale(dt), f(y))
    # stage 1 adds q/3 by *division*, exactly like the reference
    y = tree_map(lambda qq, v: v if isinstance(qq, float) and qq == 0.0
                 else v + qq / 3.0, q, y)
    q = tree_map(lambda t, qq: dt * t - 5.0 / 9.0 * qq, f(y), q)
    y = tree_axpy(15.0 / 16.0, q, y)
    q = tree_map(lambda t, qq: dt * t - 153.0 / 128.0 * qq, f(y), q)
    return tree_axpy(8.0 / 15.0, q, y)


def forward_euler(f: Callable, y, dt):
    """First-order forward Euler (an alternative integrator)."""
    return tree_axpy(dt, f(y), y)


def rk4(f: Callable, y, dt):
    """Classic 4th-order Runge-Kutta (an alternative integrator)."""
    k1 = f(y)
    k2 = f(tree_axpy(0.5 * dt, k1, y))
    k3 = f(tree_axpy(0.5 * dt, k2, y))
    k4 = f(tree_axpy(dt, k3, y))
    incr = tree_map(lambda a, b, c, d: a + 2.0 * b + 2.0 * c + d, k1, k2, k3, k4)
    return tree_axpy(dt / 6.0, incr, y)


INTEGRATORS = {
    "rk3": williamson_rk3,
    "rk4": rk4,
    "euler": forward_euler,
}


def rk3_step(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    axis_name: Optional[str] = None,
    rhs: Callable = rhs_default,
) -> State:
    """One integrator step of the coupled system (``cfg.integrator``
    selects rk3/rk4/euler).  The full ``dt`` goes to every stage's RHS."""
    integ = INTEGRATORS[cfg.integrator]
    return integ(lambda s: rhs(dt, s, statics, bg, cfg, axis_name), state, dt)


class StepAux(NamedTuple):
    """Per-step side channel: the *propagated* (pre-offline-saturation)
    density."""

    dens_prop: torch.Tensor


def step(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    axis_name: Optional[str] = None,
    rhs: Callable = rhs_default,
):
    """One model step: RK3, then (with ``saturate_online`` off) the
    driver-side offline direct saturation with finite-difference rates.
    Returns ``(new_state, new_statics, aux)``."""
    if cfg.cull or cfg.relaunch:
        raise NotImplementedError(
            "cull/relaunch are not ported yet (ROADMAP queue 1, item 3)")
    prev = state
    state = rk3_step(dt, state, statics, bg, cfg, axis_name, rhs)
    aux = StepAux(dens_prop=state.rays.dens)

    if not cfg.saturate_online:
        rays, prev_rays = state.rays, prev.rays
        # Reference quirk 2: the height rate is divided by 1, not dt
        r_div = 1.0 if cfg.faithful_offline_rates else dt
        dens = saturate_direct(
            dt,
            rays.dens,
            prev_rays.r,
            (rays.r - prev_rays.r) / r_div,
            prev_rays.dr,
            (rays.dr - prev_rays.dr) / dt,
            rays.k,
            rays.l,
            prev_rays.m,
            (rays.m - prev_rays.m) / dt,
            statics.dkk,
            statics.dll,
            statics.rr_mm_area,
            bg.centers,
            bg.rhobar,
            cfg.bvf,
            cfg.kappa,
            cfg.phi0,
            faithful=cfg.faithful_saturation,
            active=statics.active,
            interp_backend=cfg.interp_backend,
        )
        state = state._replace(rays=rays._replace(dens=dens))
    return state, statics, aux


def _not_ported(name: str, item: str):
    raise NotImplementedError(f"simulate({name}=...) is not ported yet "
                              f"(ROADMAP {item})")


def simulate(
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    run: RunConfig,
    observe: Optional[Callable] = None,
    source=None,
    relaunch_every: int = 1,
    axis_name: Optional[str] = None,
    rhs: Callable = rhs_default,
    wind_fn: Optional[Callable] = None,
    t0: float = 0.0,
    include_t0: bool = False,
    source_key=None,
    validate: bool = True,
    sort_every: int = 0,
    remat=False,
):
    """Run ``run.n_steps`` steps, recording an observation every
    ``run.save_every`` steps.

    ``observe(state, statics, aux) -> tree`` selects what is stacked into
    the history (default: the full state, the activity mask and the
    propagated density).  ``include_t0`` prepends the initial state as
    frame 0.  Returns ``(final_state, final_statics, history)``; every
    history leaf has leading axis ``n_steps // save_every`` (+1 with
    ``include_t0``).

    Not in this slice, and raising ``NotImplementedError``: ``source`` and
    ``source_key`` (relaunch, keyed sources), ``wind_fn``, ``sort_every``,
    ``remat`` and ``axis_name``.
    """
    if source is not None or source_key is not None:
        _not_ported("source", "queue 1, item 3: relaunch and keyed sources")
    if wind_fn is not None:
        _not_ported("wind_fn", "queue 1, item 5: transient winds")
    if sort_every:
        _not_ported("sort_every", "queue 1, item 5: height sort with slot identity")
    if remat:
        _not_ported("remat", "queue 1, item 5: torch.utils.checkpoint")
    if axis_name is not None:
        _not_ported("axis_name", "queue 1, item 9: ray sharding")
    del relaunch_every, t0  # only meaningful with source / wind_fn

    if observe is None:
        observe = lambda s, st, aux: (s, st.active, aux.dens_prop)
    if run.n_steps % run.save_every != 0:
        raise ValueError("n_steps must be divisible by save_every")
    if validate:
        validate_inputs(state, statics, bg, cfg)

    frames = []
    if include_t0:
        frames.append(observe(state, statics, StepAux(dens_prop=state.rays.dens)))
    with torch.no_grad():
        for i in range(run.n_steps):
            state, statics, aux = step(run.dt, state, statics, bg, cfg, None, rhs)
            if (i + 1) % run.save_every == 0:
                frames.append(observe(state, statics, aux))
    if include_t0 and len(frames) > 1:
        # frame 0 takes the history's dtypes, as in the JAX package
        frames[0] = tree_map(lambda h0, h: h0.to(h.dtype), frames[0], frames[1])
    history = tree_map(lambda *xs: torch.stack(xs), *frames)
    return state, statics, history
