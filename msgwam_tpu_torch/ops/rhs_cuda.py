"""K2: the fused ``hprop=False`` right-hand side as a hand-written Hopper
kernel.

Replaces ``msgwam_tpu/ops/rhs_pallas.py`` (``_kernel``, entry points
``_rhs_fused_call``, ``prepare_inputs`` and ``rhs_fused``), reached through
``rhs_backend="pallas", window_cells=0``.  The CUDA source is
``csrc/rhs_fused.cu``; the flux deposit is shared with K1 in
``csrc/deposit.cuh``.

Per ray, in one pass: cg_r (with the ray's own ``phi``), the shears at
``r`` and ρ̄ at ``r + cg_r·dt`` by two-point interpolation from tables in
shared memory (the Pallas kernel's hat-basis matrices existed to feed the
TPU's matrix unit), dm/dt, online saturation (``f0`` from ``cfg.phi0``,
volume ``area/dr``, ``exceed`` on the uncorrected cap), the masked
dens/r/m tendencies, and the deposit of the pseudo-momentum flux.

What bounds it on the H100: 57 B per ray per RHS (11 f32 fields and a
mask byte in, 3 f32 tendencies out), 57 MB at 1e6 rays, ~17 µs at
3.35 TB/s; ~100 flops per ray is far below the compute roofline, so it
should be bound by memory.  One ray per thread, coalesced reads,
intermediates in registers, tables in shared memory, float64 deposit
partials combined in a fixed order (the TPU kernel's cross-tile Kahan sum).

:func:`rhs_fused` launches the kernel for CUDA tensors and runs the plain
twin :func:`rhs_fused_reference` for CPU tensors; ``LAUNCHES`` counts
kernel launches.  ``resolve_champion``, ``apply_champion`` and
``resolve_window_cells`` of the JAX module hold TPU-tuned constants of the
windowed kernels and are not ported.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import ROT_EARTH
from ..state import RayStatics, State
from .projection import _reduce_partials, block_partials
from .projection_cuda import n_blocks_for

LAUNCHES = 0

MAX_TABLE = 1025     # csrc/rhs_fused.cu kMaxTable: cell centers


def prepare_inputs(dt, state, statics, bg, cfg):
    """Input prep shared by the kernel and its twin: ``(params, scalars,
    tables)``.

    * ``params``  — tensor ``(3,)`` on the state's device: ``g0c`` (first
      center), ``dz`` and ``g0f`` (first interior face), in the state's
      dtype; read by the kernel from device memory, so no host sync;
    * ``scalars`` — host floats ``(dt, bvf, kappa, f0)``, with
      ``f0 = 2Ω sin(phi0)`` evaluated in the state's dtype;
    * ``tables``  — ``(du_dz, dv_dz, rhobar)``: the shears on the
      ``n_tab - 1`` interior faces and ρ̄ on the ``n_tab`` centers.
    """
    if cfg.hprop:
        raise ValueError("rhs_fused supports hprop=False only")
    mean = state.mean
    dtype = state.rays.r.dtype
    centers = bg.centers.to(dtype)
    dz = centers[1] - centers[0]
    du_dz = ((mean.u[1:] - mean.u[:-1]) / dz).to(dtype)
    dv_dz = ((mean.v[1:] - mean.v[:-1]) / dz).to(dtype)
    params = torch.stack([centers[0], dz, bg.faces[1].to(dtype)])
    f0 = float(2.0 * ROT_EARTH * torch.sin(torch.tensor(cfg.phi0, dtype=dtype)))
    scalars = (float(dt), float(cfg.bvf), float(cfg.kappa), f0)
    return params, scalars, (du_dz, dv_dz, bg.rhobar.to(dtype))


def ray_fields(state, statics):
    r = state.rays
    return (r.dens, r.r, r.dr, r.k, r.l, r.m, r.dm, r.phi,
            statics.dkk, statics.dll, statics.rr_mm_area)


def _check(state, statics, bg):
    fields = ray_fields(state, statics)
    n = fields[0].shape[0]
    device = fields[0].device
    tensors = (("state", f) for f in fields)
    for name, x in (*tensors, ("mean.u", state.mean.u), ("mean.v", state.mean.v),
                    ("bg.centers", bg.centers), ("bg.faces", bg.faces),
                    ("bg.rhobar", bg.rhobar)):
        if x.dtype != torch.float32:
            raise TypeError(f"rhs_fused: {name} must be float32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"rhs_fused: {name} is on {x.device}, "
                             f"rays on {device}")
    for x in fields:
        if x.shape != (n,) or not x.is_contiguous():
            raise ValueError(f"rhs_fused: every ray field must be a "
                             f"contiguous ({n},) tensor")
    act = statics.active
    if act.dtype != torch.bool or act.shape != (n,) or act.device != device \
            or not act.is_contiguous():
        raise ValueError(f"rhs_fused: active must be a contiguous bool "
                         f"({n},) tensor on {device}")
    if not 3 <= bg.centers.shape[0] <= MAX_TABLE:
        raise ValueError(f"rhs_fused: 3 to {MAX_TABLE} cells supported")


def rhs_fused(dt, state, statics, bg, cfg):
    """Fused-RHS entry point: ``(tendencies, pm_interior)`` where
    ``tendencies`` is ``{"dens", "r", "m"}`` per ray and ``pm_interior``
    the ``(2, n_cell - 1)`` interior flux profile.  Float32, hprop=False."""
    _check(state, statics, bg)
    device = state.rays.r.device
    if device.type == "cpu":
        return rhs_fused_reference(dt, state, statics, bg, cfg)
    if device.type != "cuda":
        raise ValueError(f"rhs_fused: unsupported device {device}")

    return launch(*prepare_inputs(dt, state, statics, bg, cfg),
                  ray_fields(state, statics), statics.active,
                  cfg.saturate_online, cfg.faithful_saturation)


def launch(params, scalars, tables, fields, active, saturate_online: bool,
           faithful: bool):
    """One launch of the kernel on inputs that :func:`rhs_fused` has
    checked and :func:`prepare_inputs` has built (no checks here): returns
    the tendencies and the flux as :func:`rhs_fused` does."""
    global LAUNCHES
    dt, bvf, kappa, f0 = scalars
    du_dz, dv_dz, rhobar = tables
    device = fields[0].device
    n = fields[0].shape[0]
    n_tab = rhobar.shape[0]
    nb = n_blocks_for(n)
    dens_st, drr_st, dmm_st = (torch.empty_like(fields[0]) for _ in range(3))
    flux = torch.empty((2, n_tab - 1), dtype=torch.float32, device=device)
    partials = torch.empty((nb, 2, n_tab - 1), dtype=torch.float64,
                           device=device)
    err = _build.library().msgwam_rhs_fused(
        params.data_ptr(), dt, bvf, kappa, f0,
        du_dz.data_ptr(), dv_dz.data_ptr(), rhobar.data_ptr(), n_tab,
        *(f.data_ptr() for f in fields), active.data_ptr(), n,
        dens_st.data_ptr(), drr_st.data_ptr(), dmm_st.data_ptr(),
        flux.data_ptr(), partials.data_ptr(), nb,
        int(bool(saturate_online)), int(bool(faithful)),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "msgwam_rhs_fused")
    LAUNCHES += 1
    return {"dens": dens_st, "r": drr_st, "m": dmm_st}, flux


def _interp2(table, q):
    """Clamped two-point interpolation at hat coordinates ``q >= 0``."""
    i = torch.clamp(q.to(torch.int64), max=table.shape[0] - 2)
    t = q - i.to(q.dtype)
    return table[i] * (1.0 - t) + table[i + 1] * t


def rhs_fused_reference(dt, state: State, statics: RayStatics, bg, cfg):
    """Plain PyTorch twin of the K2 kernel, in the state's own dtype
    (float32 for the kernel's arithmetic, float64 for an oracle): the same
    per-ray expressions, a dense ``(n, n_cells)`` deposit weight matrix,
    block partials and a float64 combination."""
    params, (dt, bvf, kappa, f0), (du_dz, dv_dz, rhobar) = prepare_inputs(
        dt, state, statics, bg, cfg)
    dens, r, dr, k, l, m, dm, phi, dkk, dll, area = ray_fields(state, statics)
    act = statics.active
    g0c, dz, g0f = params[0], params[1], params[2]
    idz = 1.0 / dz
    n_tab = rhobar.shape[0]
    n_flux = n_tab - 1
    zero = torch.zeros_like(r)

    ff = 2.0 * ROT_EARTH * torch.sin(phi)
    kh2 = k * k + l * l
    k2 = kh2 + m * m
    om2 = (bvf * bvf * kh2 + ff * ff * m * m) * (1.0 / k2)
    cgr = -m * (om2 - ff * ff) * torch.rsqrt(om2) * (1.0 / k2)

    # deposit inputs: indices from r * (1/dz), 1/dz folded into the values
    r_lo = r - 0.5 * dr
    r_up = r + 0.5 * dr
    nzmax = n_flux - 1
    nlow = (r_lo * idz).to(torch.int64)
    nup = (r_up * idz + 1.0).to(torch.int64)
    ood = ((nlow >= nzmax) & (nup >= nzmax)) | ((nlow <= 0) & (nup <= 0))
    live = act & ~ood
    pv = torch.abs(dkk * dll * dm)
    fv = cgr * dens * idz
    fvk = torch.where(live, fv * k * pv, zero)
    fvl = torch.where(live, fv * l * pv, zero)
    nlow = torch.clamp(nlow, 0, nzmax)
    nup = torch.clamp(nup, 0, nzmax)

    qf = (torch.clamp(r, g0f, g0f + (n_tab - 2.0) * dz) - g0f) * idz
    dmm_st = -(k * _interp2(du_dz, qf) + l * _interp2(dv_dz, qf))

    if cfg.saturate_online:
        r_fin = r + cgr * dt
        qr = (torch.clamp(r_fin, g0c, g0c + (n_tab - 1.0) * dz) - g0c) * idz
        rho = _interp2(rhobar, qr)
        m_fin = m + dmm_st * dt
        dmm_fin = area / dr
        omh2 = (bvf * bvf * kh2 + f0 * f0 * m * m) * (1.0 / k2)
        cap = (kappa * kappa * 0.5 * rho * omh2 * torch.rsqrt(omh2) * bvf * bvf
               / (m_fin * m_fin * (omh2 - f0 * f0)))
        pvol = dkk * dll * dmm_fin
        cap_applied = cap if cfg.faithful_saturation else cap / pvol
        dens_st = torch.where(cap < dens * pvol,
                              (cap_applied - dens) * (1.0 / dt), zero)
    else:
        dens_st = zero

    c = torch.arange(n_flux, device=r.device)
    cf = c.to(r.dtype)
    face_lo = g0c + cf * dz
    face_hi = g0c + (cf + 1.0) * dz
    in_span = (c >= nlow[:, None]) & (c < nup[:, None])
    w = torch.abs(torch.minimum(face_hi, r_up[:, None])
                  - torch.maximum(face_lo, r_lo[:, None]))
    w = torch.where(in_span, w, torch.zeros_like(w))
    flux = _reduce_partials(block_partials(torch.stack([fvk, fvl]), w),
                            "f64", r.dtype)

    tend = {
        "dens": torch.where(act, dens_st, zero),
        "r": torch.where(act, cgr, zero),
        "m": torch.where(act, dmm_st, zero),
    }
    return tend, flux
