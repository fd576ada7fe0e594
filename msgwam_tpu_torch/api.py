"""Drop-in mirror of the reference ``lib/libprop.py`` API surface: the
counterpart of :mod:`msgwam_tpu.api`.

Experiment scripts written against the reference (including its own
driver, ``raytracer.py``) can ``import msgwam_tpu_torch.api as lprop`` in
place of ``import lib.libprop as lprop`` and run unchanged, with the
physics computed by the port in float64.  NumPy in, NumPy out.

This is the stateful compatibility layer over the functional core: the
reference's module globals (``lib/libprop.py:3-11``) and kwargs-merging
setters (``lib/libprop.py:14-44``), translated to a frozen
:class:`~msgwam_tpu_torch.config.ModelConfig` and tensor trees at each
call.  The ``model_config['rhs']`` injection point (``lib/libprop.py:691``)
is kept: :func:`RK3` integrates any callable ``rhs(dt, var) -> var_dot``
over the object-dtype state vector; with this module's :func:`rhs_default`
the step runs as the port's ``rk3_step``.

The computation runs on :data:`DEVICE`: ``None`` is the card
(:func:`msgwam_tpu_torch.state.default_device`), ``"cpu"`` the CPU.  The
JAX package turns on x64 at import; torch needs no switch, every tensor
here is built as float64.

New code should use the functional API (:mod:`msgwam_tpu_torch.models`).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .constants import RAD_EARTH, ROT_EARTH  # noqa: F401  (re-exported)
from .state import (Background, MeanState, RayState, RayStatics, State,
                    default_device)
from .models import backgrounds as _bg
from .models.integrate import rk3_step as _rk3_step
from .models.rhs import rhs as _rhs
from .ops import dispersion as _disp
from .ops.interp import grid_interp as _grid_interp
from .ops import projection as _proj
from .ops import saturation as _sat

# ---------------------------------------------------------------------------
# module-global state, mirroring lib/libprop.py:3-11
# ---------------------------------------------------------------------------

HPROP_GLOBAL = True          # lib/libprop.py:5
pressure_gradient = 0        # lib/libprop.py:6
grid = None                  # lib/libprop.py:7
grids = None                 # lib/libprop.py:8
rhobar = 1                   # lib/libprop.py:9
model_config = {}            # lib/libprop.py:10
statics = {}                 # lib/libprop.py:11

#: device of the computation: None is the card, "cpu" the CPU
DEVICE = None


def set_statics(**kwargs):
    """Merge per-ray constants into ``statics`` (``lib/libprop.py:14-27``).
    Defaults: ``int_dll=1, int_dkk=1, rr_mm_area=0``."""
    statics.update(kwargs)


def set_model_setup(**kwargs):
    """Merge options into ``model_config`` (``lib/libprop.py:30-44``)."""
    model_config.update(kwargs)


def get_model_setup():
    """Return the configuration dict (``lib/libprop.py:85-89``)."""
    return model_config


def set_hydrostatics():
    """ρ̄(z) on the staggered grid (``lib/libprop.py:47-62``)."""
    global rhobar
    rhobar0 = model_config['rhobar0']
    hh = model_config['hh']
    if model_config['boussinesq']:
        rhobar = rhobar0 * np.ones(np.shape(grids))
    else:
        rhobar = rhobar0 * np.exp(-np.asarray(grids) / hh)


def set_pressure_gradient(uu, vv):
    """Geostrophic pressure gradient from the initial winds
    (``lib/libprop.py:65-82``)."""
    global pressure_gradient
    ff = 2 * ROT_EARTH * np.sin(model_config['phi0'])
    pressure_gradient = np.empty((2, len(grids)))
    pressure_gradient[0] = rhobar * ff * vv
    pressure_gradient[1] = -rhobar * ff * uu


# ---------------------------------------------------------------------------
# config / state translation
# ---------------------------------------------------------------------------

_CFG_KEYS = (
    'u0', 'phi0', 'sig_phi', 'rr0', 'rr1', 'sig_rr', 'drr', 'bvf',
    'geostrophy', 'boussinesq', 'hh', 'rhobar0', 'kappa', 'saturate_online',
)


def _t(x) -> torch.Tensor:
    """A float64 tensor on :data:`DEVICE` from an array-like."""
    return torch.as_tensor(np.array(x, dtype=np.float64),
                           device=default_device(DEVICE))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _current_config() -> ModelConfig:
    kw = {k: model_config[k] for k in _CFG_KEYS if k in model_config}
    for key in ('phi0', 'sig_phi'):
        if key in kw:
            kw[key] = float(kw[key])
    return ModelConfig(hprop=bool(HPROP_GLOBAL), **kw)


def _current_background() -> Background:
    pg = pressure_gradient
    if np.ndim(pg) == 0:
        pg = np.zeros((2, len(grids)))
    rb = rhobar
    if np.ndim(rb) == 0:
        rb = float(rb) * np.ones(len(grids))
    return Background(faces=_t(grid), centers=_t(grids), rhobar=_t(rb),
                      pressure_gradient=_t(pg))


def _current_statics(nray: int) -> RayStatics:
    def arr(v):
        return _t(np.broadcast_to(np.asarray(v, dtype=np.float64), (nray,)))

    return RayStatics(
        dkk=arr(statics.get('dkk', statics.get('int_dkk', 1.0))),
        dll=arr(statics.get('dll', statics.get('int_dll', 1.0))),
        rr_mm_area=arr(statics.get('rr_mm_area', 0.0)),
        active=torch.ones((nray,), dtype=torch.bool,
                          device=default_device(DEVICE)),
    )


# ---------------------------------------------------------------------------
# physics functions with the reference signatures
# ---------------------------------------------------------------------------

def omega(kk, ll, mm, phi):
    """Intrinsic frequency (``lib/libprop.py:369-383``)."""
    return _np(_disp.omega(_t(kk), _t(ll), _t(mm), _t(phi),
                           model_config['bvf']))


def cg_lambda(kk, ll, mm, lam, phi, rr, uu, vv):
    """Zonal group velocity (``lib/libprop.py:386-407``)."""
    if not HPROP_GLOBAL:
        return np.zeros(np.shape(kk))
    uu_ray = _grid_interp(_t(rr), _t(grids), _t(uu))
    cgl, _, _ = _disp.group_velocities(
        _t(kk), _t(ll), _t(mm), _t(phi), uu_ray, torch.zeros_like(uu_ray),
        model_config['bvf'], True)
    return _np(cgl)


def cg_phi(kk, ll, mm, lam, phi, rr, uu, vv):
    """Meridional group velocity (``lib/libprop.py:410-431``)."""
    if not HPROP_GLOBAL:
        return np.zeros(np.shape(kk))
    vv_ray = _grid_interp(_t(rr), _t(grids), _t(vv))
    _, cgp, _ = _disp.group_velocities(
        _t(kk), _t(ll), _t(mm), _t(phi), torch.zeros_like(vv_ray), vv_ray,
        model_config['bvf'], True)
    return _np(cgp)


def cg_rr(kk, ll, mm, lam, phi, rr):
    """Vertical group velocity (``lib/libprop.py:434-448``)."""
    return _np(_disp.cg_r(_t(kk), _t(ll), _t(mm), _t(phi),
                          model_config['bvf']))


def gradients(lam_ray, phi_ray, rr_ray, uu, vv):
    """Winds + gradients at ray positions, ``(4, 3, n)`` layout
    (``lib/libprop.py:328-366``)."""
    rr_ray, uu, vv, gridt = _t(rr_ray), _t(uu), _t(vv), _t(grid)
    dz = gridt[1] - gridt[0]
    du_dz = (uu[1:] - uu[:-1]) / dz
    dv_dz = (vv[1:] - vv[:-1]) / dz
    out = np.zeros((4, 3) + np.shape(lam_ray))
    out[0, 0] = _np(_grid_interp(rr_ray, _t(grids), uu))
    out[0, 1] = _np(_grid_interp(rr_ray, _t(grids), vv))
    out[1, 2] = _np(_grid_interp(rr_ray, gridt[1:-1], du_dz))
    out[2, 2] = _np(_grid_interp(rr_ray, gridt[1:-1], dv_dz))
    return out


def _wavenumber_tendency(which, kk, ll, mm, lam, phi, rr, uu, vv):
    g = gradients(lam, phi, rr, uu, vv)
    dk, dl, dm = _disp.wavenumber_tendencies(
        _t(kk), _t(ll), _t(mm), _t(phi), _t(rr),
        _t(g[0, 0]), _t(g[0, 1]), _t(g[1, 2]), _t(g[2, 2]),
        model_config['bvf'], bool(HPROP_GLOBAL),
    )
    out = {'k': dk, 'l': dl, 'm': dm}[which]
    return _np(out) if isinstance(out, torch.Tensor) else np.asarray(out)


def dk_dt(kk, ll, mm, lam, phi, rr, uu, vv):
    """(``lib/libprop.py:451-471``)"""
    return _wavenumber_tendency('k', kk, ll, mm, lam, phi, rr, uu, vv)


def dl_dt(kk, ll, mm, lam, phi, rr, uu, vv):
    """(``lib/libprop.py:474-499``)"""
    return _wavenumber_tendency('l', kk, ll, mm, lam, phi, rr, uu, vv)


def dm_dt(kk, ll, mm, lam, phi, rr, uu, vv):
    """(``lib/libprop.py:502-520``)"""
    return _wavenumber_tendency('m', kk, ll, mm, lam, phi, rr, uu, vv)


def du_dt(vv, pm_flux_gradient):
    """Zonal mean-flow tendency (``lib/libprop.py:523-539``)."""
    ff = 2 * ROT_EARTH * np.sin(model_config['phi0'])
    return ff * np.asarray(vv) - np.asarray(rhobar) ** -1 * (
        np.asarray(pressure_gradient)[0] + np.asarray(pm_flux_gradient)
    )


def dv_dt(uu, pm_flux_gradient):
    """Meridional mean-flow tendency (``lib/libprop.py:542-558``)."""
    ff = 2 * ROT_EARTH * np.sin(model_config['phi0'])
    return -ff * np.asarray(uu) - np.asarray(rhobar) ** -1 * (
        np.asarray(pressure_gradient)[1] + np.asarray(pm_flux_gradient)
    )


def wave_projection(dens, lam, phi, rr_low, rr_up, kk, ll, mm_low, mm_up,
                    dkk, dll, dmm, grid, var=0):
    """All five projection variants (``lib/libprop.py:92-221``)."""
    dz = float(np.asarray(grid)[1] - np.asarray(grid)[0])
    dr_max = float(np.max(np.asarray(rr_up) - np.asarray(rr_low)))
    span = max(4, _proj.required_span(max(dr_max, 0.0), dz))
    return _np(_proj.project_reference_variant(
        _t(dens), _t(lam), _t(phi), _t(rr_low), _t(rr_up), _t(kk), _t(ll),
        _t(mm_low), _t(mm_up), _t(dkk), _t(dll), _t(dmm), _t(grid),
        model_config['bvf'], var=var, max_span=span))


def saturation(dt, dens, rr_center, rr_center_st, drr, drr_st, kk, ll,
               mm_center, mm_center_st, direct=False):
    """Saturation clamp / tendency (``lib/libprop.py:561-615``)."""
    st = _current_statics(len(np.asarray(dens)))
    fn = _sat.saturate_direct if direct else _sat.saturation_tendency
    return _np(fn(
        dt, _t(dens), _t(rr_center), _t(rr_center_st), _t(drr), _t(drr_st),
        _t(kk), _t(ll), _t(mm_center), _t(mm_center_st),
        st.dkk, st.dll, st.rr_mm_area, _t(grids), _t(rhobar),
        model_config['bvf'], model_config['kappa'],
        float(model_config['phi0']),
    ))


# ---------------------------------------------------------------------------
# background wind profiles (lib/libprop.py:224-325)
# ---------------------------------------------------------------------------

def velocities_tanh(lam, phi, rr):
    return _np(_bg.velocities_tanh(_t(lam), _t(phi), _t(rr),
                                   _current_config()))


def velocities_tanh_homogeneous(rr):
    return _np(_bg.velocities_tanh_homogeneous(_t(rr), _current_config()))


def velocities_gauss_homogeneous(rr):
    return _np(_bg.velocities_gauss_homogeneous(_t(rr), _current_config()))


def velocities_sine_homogeneous(rr):
    return _np(_bg.velocities_sine_homogeneous(_t(rr), _current_config()))


# ---------------------------------------------------------------------------
# RHS + integrator over the reference's object-dtype state vector
# ---------------------------------------------------------------------------

def _pack(var):
    dens, lam, phi, rr, drr, kk, ll, mm, dmm, uu, vv = (_t(v) for v in var)
    return State(
        RayState(dens=dens, lam=lam, phi=phi, r=rr, dr=drr,
                 k=kk, l=ll, m=mm, dm=dmm),
        MeanState(u=uu, v=vv),
    )


def _unpack(s: State):
    r = s.rays
    # r.r (= cg_r) is a tensor in every configuration; dens & co. may be
    # structural zeros (the float 0.0)
    nray = r.r.shape[0]
    ncell = s.mean.u.shape[0] if isinstance(s.mean.u, torch.Tensor) \
        else len(grids)

    def arr(f, n):
        # the functional core returns structurally-zero tendencies as
        # scalars; the reference API contract is full-length arrays
        a = _np(f) if isinstance(f, torch.Tensor) else np.asarray(float(f))
        return np.broadcast_to(a, (n,)).copy() if a.ndim == 0 else a

    fields = [arr(f, nray) for f in
              (r.dens, r.lam, r.phi, r.r, r.dr, r.k, r.l, r.m, r.dm)]
    fields += [arr(s.mean.u, ncell), arr(s.mean.v, ncell)]
    return np.array(fields, dtype=object)


def rhs_default(dt, var_in):
    """The coupled RHS over the reference state-vector layout
    (``lib/libprop.py:618-676``)."""
    state = _pack(var_in)
    with torch.no_grad():
        out = _rhs(float(dt), state, _current_statics(state.rays.dens.shape[0]),
                   _current_background(), _current_config())
    return _unpack(out)


def RK3(dt, var):
    """Williamson RK3 over the object-dtype state vector
    (``lib/libprop.py:680-700``).  Uses ``model_config['rhs']``, the
    preserved extension point: with the default RHS the step is the port's
    ``rk3_step``; a user-supplied RHS runs the reference's generic
    object-array stage arithmetic."""
    rhs_ = model_config['rhs']
    if rhs_ is rhs_default:
        state = _pack(var)
        with torch.no_grad():
            out = _rk3_step(float(dt), state,
                            _current_statics(state.rays.dens.shape[0]),
                            _current_background(), _current_config())
        return _unpack(out)

    qq = dt * rhs_(dt, var)
    var = var + qq / 3
    qq = dt * rhs_(dt, var) - 5 / 9 * qq
    var = var + 15 / 16 * qq
    qq = dt * rhs_(dt, var) - 153 / 128 * qq
    var = var + 8 / 15 * qq
    return var


# install the reference defaults (lib/libprop.py:703-726)
set_model_setup(
    u0=80,
    phi0=np.deg2rad(-60),
    sig_phi=np.deg2rad(3),
    rr0=30000,
    rr1=40000,
    sig_rr=10000,
    drr=1,
    bvf=0.01,
    rhs=rhs_default,
    geostrophy=True,
    boussinesq=False,
    hh=8500,
    rhobar0=1.2,
    kappa=0.95,
    saturate_online=True,
)

set_statics(
    int_dll=1,
    int_dkk=1,
    rr_mm_area=0,
)
