"""The plain reference of the msgwam deployments the benchmark runs.

Plain PyTorch, one dtype throughout (float64 for the reference, bfloat16
for the control), on any device.  It imports nothing of the program: the
physics is written out here from the deployment's own equations
(``python-msgwam`` ``raytracer.py`` and ``lib/libprop.py``, as the
configuration files name them), and takes from the program neither
weights, tables nor plans.

What it computes, for ``hprop=False`` (vertical propagation only), the
one setting the configurations use:

* the column: faces and centers of the uniform grid, the density
  ``rhobar = rhobar0 exp(-z / H)`` and the pressure gradient that balances
  the initial wind at ``phi0``;
* the right-hand side: the wind and its shear interpolated to each ray
  (``np.interp``'s clamped linear rule), the vertical group velocity, the
  refraction ``dm/dt = -(k du/dz + l dv/dz)``, online saturation (the
  relaxation toward the static-instability cap of the extrapolated ray,
  applied to the density as the reference applies it), the deposit of the
  pseudo-momentum flux onto the grid (cell indices by the reference's
  origin-0 rule, overlaps as absolute values), the flux divergence with
  copied boundaries and the wind tendencies;
* Williamson's low-storage RK3 with the full ``dt`` in every stage;
* the lifecycle: the cull (domain exit, ``|m| > m_max``, non-finite) and
  the relaunch of inactive slots from a fixed template;
* an imposed tidal wind, set at the start of each step.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

ROT_EARTH = 7.2921e-5      # Earth's rotation rate [1/s]
SAT_EPS = 1e-14            # the guard of the saturation cap's divisions


class Column(NamedTuple):
    faces: torch.Tensor        # (n_face,)
    centers: torch.Tensor      # (n_face - 1,)
    rhobar: torch.Tensor       # on centers
    pg: torch.Tensor           # (2, n_cell) pressure gradient


class Rays(NamedTuple):
    """The evolving ray fields and the active mask."""

    dens: torch.Tensor
    r: torch.Tensor
    m: torch.Tensor
    active: torch.Tensor


class Frozen(NamedTuple):
    """Ray fields that ``hprop=False`` never changes."""

    k: torch.Tensor
    l: torch.Tensor
    dr: torch.Tensor
    dm: torch.Tensor
    phi: torch.Tensor
    dkk: torch.Tensor
    dll: torch.Tensor
    area: torch.Tensor


class Physics(NamedTuple):
    bvf: float
    kappa: float
    phi0: float
    faithful: bool
    prognostic: bool
    cull: bool
    relaunch: bool
    m_max: float


def physics(model: dict) -> Physics:
    """The constants a configuration file's ``model`` block states."""
    if model.get("hprop", False):
        raise NotImplementedError("the reference covers hprop=False")
    if not model["saturate_online"]:
        raise NotImplementedError("the reference covers online saturation")
    if model.get("integrator", "rk3") != "rk3":
        raise NotImplementedError("the reference covers RK3")
    return Physics(
        bvf=float(model["bvf"]), kappa=float(model["kappa"]),
        phi0=float(model["phi0"]),
        faithful=bool(model["faithful_saturation"]),
        prognostic=bool(model["prognostic_mean"]),
        cull=bool(model["cull"] or model["relaunch"]),
        relaunch=bool(model["relaunch"]), m_max=float(model["m_max"]))


def column(model: dict, grid: dict, u0, v0, dtype, device) -> Column:
    """The column of a configuration, with the pressure gradient that
    balances the initial wind ``(u0, v0)``."""
    f64 = dict(dtype=torch.float64, device=device)
    faces = torch.linspace(0.0, float(grid["z_max"]), int(grid["n_face"]), **f64)
    centers = 0.5 * (faces[:-1] + faces[1:])
    if model["boussinesq"]:
        rhobar = float(model["rhobar0"]) * torch.ones_like(centers)
    else:
        rhobar = float(model["rhobar0"]) * torch.exp(-centers / float(model["hh"]))
    ff = 2.0 * ROT_EARTH * math.sin(float(model["phi0"]))
    u0 = torch.as_tensor(u0, **f64)
    v0 = torch.as_tensor(v0, **f64)
    pg = torch.stack([rhobar * ff * v0, -rhobar * ff * u0])
    return Column(*(x.to(dtype) for x in (faces, centers, rhobar, pg)))


def interp(x, xp, fp):
    """``np.interp`` on the uniform grid ``xp``: linear inside, clamped
    outside."""
    n = xp.shape[0]
    dx = xp[1] - xp[0]
    i = torch.clamp(torch.floor((x - xp[0]) / dx).to(torch.int64), 0, n - 2)
    x0 = xp[i]
    inner = fp[i] + (fp[i + 1] - fp[i]) * (x - x0) / (xp[i + 1] - x0)
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], inner))


def omega(k, l, m, phi, bvf):
    """Intrinsic frequency ``sqrt((N^2 k_h^2 + f^2 m^2) / |k|^2)``."""
    ff = 2.0 * ROT_EARTH * (torch.sin(phi) if torch.is_tensor(phi) else math.sin(phi))
    kh2 = k * k + l * l
    return torch.sqrt((bvf * bvf * kh2 + ff * ff * m * m) / (kh2 + m * m))


def cg_r(k, l, m, phi, bvf):
    """Vertical group velocity ``-m (w^2 - f^2) / (w |k|^2)``."""
    ff = 2.0 * ROT_EARTH * torch.sin(phi)
    om = omega(k, l, m, phi, bvf)
    return -m * (om * om - ff * ff) / om / (k * k + l * l + m * m)


def deposit(values, r_low, r_up, phase_vol, valid, grid, index_dtype=None):
    """``(nvar, len(grid) - 1)``: ``values`` ``(nvar, n)`` times each
    ray's overlap with the cells of ``grid`` (in cell widths) times its
    phase-space volume, summed per cell.  The reference's index rule:
    ``r / dz`` truncated toward zero from origin 0, both ends clamped to
    ``len(grid) - 2`` (so the top cell receives nothing), rays wholly
    below or above the clamp dropped; every covered cell is counted.
    ``index_dtype`` evaluates the rule's ratios in that precision (default:
    the edges' own)."""
    n_points = grid.shape[0]
    nzmax = n_points - 2
    dz = grid[1] - grid[0]
    t = (lambda x: x) if index_dtype is None else (lambda x: x.to(index_dtype))
    nlow = torch.trunc(t(r_low) / t(dz)).to(torch.int64)
    nup = torch.trunc(t(r_up) / t(dz) + 1.0).to(torch.int64)
    outside = ((nlow >= nzmax) & (nup >= nzmax)) | ((nlow <= 0) & (nup <= 0))
    nlow = torch.clamp(nlow, 0, nzmax)
    nup = torch.clamp(nup, 0, nzmax)
    ok = valid & ~outside
    span = int((nup - nlow).max()) if nup.numel() else 0
    out = torch.zeros((values.shape[0], n_points), dtype=values.dtype,
                      device=values.device)
    for j in range(span):
        cell = nlow + j
        live = ok & (cell < nup)
        c = torch.clamp(cell, 0, nzmax)
        w = (torch.minimum(grid[c + 1], r_up) - torch.maximum(grid[c], r_low)).abs() / dz
        w = torch.where(live, w * phase_vol, torch.zeros_like(w))
        out.index_add_(1, torch.where(live, c, n_points - 1), values * w)
    return out[:, : n_points - 1]


def flux(rays: Rays, fz: Frozen, col: Column, bvf: float, cgr=None):
    """The ``(2, n_cell - 1)`` pseudo-momentum flux of the active rays on
    the interior faces."""
    if cgr is None:
        cgr = cg_r(fz.k, fz.l, rays.m, fz.phi, bvf)
    values = torch.stack([cgr * fz.k * rays.dens, cgr * fz.l * rays.dens])
    phase_vol = (fz.dkk * fz.dll * fz.dm).abs()
    half = 0.5 * fz.dr
    return deposit(values, rays.r - half, rays.r + half, phase_vol,
                   rays.active, col.centers)


def rhs(rays: Rays, fz: Frozen, u, v, col: Column, p: Physics, dt: float):
    """``(d dens, d r, d m, d u, d v)`` per unit time."""
    dz = col.centers[1] - col.centers[0]
    u_ray_shear = interp(rays.r, col.faces[1:-1], (u[1:] - u[:-1]) / dz)
    v_ray_shear = interp(rays.r, col.faces[1:-1], (v[1:] - v[:-1]) / dz)
    cgr = cg_r(fz.k, fz.l, rays.m, fz.phi, p.bvf)
    dm_dt = -(fz.k * u_ray_shear + fz.l * v_ray_shear)

    # online saturation: the ray extrapolated over dt against the cap
    r_f = rays.r + cgr * dt
    m_f = rays.m + dm_dt * dt
    rho_f = interp(r_f, col.centers, col.rhobar)
    ff = 2.0 * ROT_EARTH * math.sin(p.phi0)
    omh = omega(fz.k, fz.l, rays.m, p.phi0, p.bvf)
    phase_f = fz.dkk * fz.dll * (fz.area / fz.dr)
    m2 = m_f * m_f
    d2 = omh * omh - ff * ff
    bad = (m2 <= SAT_EPS) | (d2 <= SAT_EPS)
    cap = (p.kappa * p.kappa * 0.5 * rho_f * omh * p.bvf * p.bvf
           / torch.where(m2 <= SAT_EPS, torch.ones_like(m2), m2)
           / torch.where(d2 <= SAT_EPS, torch.ones_like(d2), d2))
    cap = torch.where(bad, torch.full_like(cap, math.inf), cap)
    exceed = (cap < rays.dens * phase_f) & rays.active
    target = cap if p.faithful else cap / phase_f
    dens_dt = torch.where(exceed, (target - rays.dens) / dt,
                          torch.zeros_like(cap))

    zero = torch.zeros_like(cgr)
    on = rays.active
    tend = (torch.where(on, dens_dt, zero), torch.where(on, cgr, zero),
            torch.where(on, dm_dt, zero))
    if not p.prognostic:
        return (*tend, torch.zeros_like(u), torch.zeros_like(v))
    pm = flux(rays, fz, col, p.bvf, cgr)
    pm = torch.cat([pm[:, :1], pm, pm[:, -1:]], dim=1)
    div = (pm[:, 1:] - pm[:, :-1]) / (col.faces[1] - col.faces[0])
    du = ff * v - (col.pg[0] + div[0]) / col.rhobar
    dv = -ff * u - (col.pg[1] + div[1]) / col.rhobar
    return (*tend, du, dv)


# Williamson's low-storage RK3: q = dt f(y) - a q; y += b q
RK3 = ((0.0, 1.0 / 3.0), (5.0 / 9.0, 15.0 / 16.0), (153.0 / 128.0, 8.0 / 15.0))


def rk3(rays: Rays, fz: Frozen, u, v, col: Column, p: Physics, dt: float):
    """One step; the first stage adds ``q / 3`` by division, as the
    reference driver does."""
    y = [rays.dens, rays.r, rays.m, u, v]
    q = [0.0] * 5
    for stage, (a, b) in enumerate(RK3):
        f = rhs(Rays(*y[:3], rays.active), fz, y[3], y[4], col, p, dt)
        q = [dt * fi - a * qi for fi, qi in zip(f, q)]
        y = [yi + (qi / 3.0 if stage == 0 else b * qi) for yi, qi in zip(y, q)]
    return Rays(*y[:3], rays.active), y[3], y[4]


def lifecycle(rays: Rays, col: Column, p: Physics, fz: Frozen,
              template: Optional[Rays]) -> Rays:
    """The cull after a step and the relaunch of inactive slots from
    ``template``."""
    if not p.cull:
        return rays
    half = 0.5 * fz.dr
    out = (rays.r - half >= col.faces[-1]) | (rays.r + half <= col.faces[0])
    critical = rays.m.abs() > p.m_max
    finite = (torch.isfinite(rays.dens) & torch.isfinite(rays.r)
              & torch.isfinite(rays.m))
    active = rays.active & ~out & ~critical & finite
    rays = rays._replace(active=active)
    if not p.relaunch or template is None:
        return rays
    pick = lambda live, fresh: torch.where(active, live, fresh)
    return Rays(pick(rays.dens, template.dens), pick(rays.r, template.r),
                pick(rays.m, template.m), active | template.active)


def advance(rays: Rays, fz: Frozen, u, v, col: Column, p: Physics, dt: float,
            n_steps: int, step0: int = 0, wind=None, template=None):
    """``n_steps`` steps from ``(rays, u, v)``; step ``i`` (counted from
    ``step0``) first takes the imposed wind ``wind(t)`` at ``t = i dt``
    where one is given.  Returns ``(rays, u, v)``."""
    for i in range(step0, step0 + n_steps):
        if wind is not None:
            u, v = wind(i * dt)
        rays, u, v = rk3(rays, fz, u, v, col, p, dt)
        rays = lifecycle(rays, col, p, fz, template)
    return rays, u, v
