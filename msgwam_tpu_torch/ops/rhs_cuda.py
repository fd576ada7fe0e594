"""K2: the fused ``hprop=False`` right-hand side as a hand-written Hopper
kernel, and the launch plumbing K2-K4 share.

Replaces ``msgwam_tpu/ops/rhs_pallas.py`` (``_kernel``, entry points
``_rhs_fused_call``, ``prepare_inputs`` and ``rhs_fused``), reached through
``rhs_backend="pallas", window_cells=0``.  The CUDA source is
``csrc/rhs_windowed.cu``: K2 is the per-stage template of K3/K4 with the
window compiled out.  The per-ray physics is ``csrc/ray_physics.cuh``
(shared with K3-K7; its twin is :mod:`.ray_physics`), the flux deposit
``csrc/deposit.cuh`` (shared with K1 and K5-K7).

Per ray, in one pass: cg_r (with the ray's own ``phi``), the shears at
``r`` and ρ̄ at ``r + cg_r·dt`` by two-point interpolation from tables in
shared memory (the Pallas kernel's hat-basis matrices existed to feed the
TPU's matrix unit), dm/dt, online saturation (``f0`` from ``cfg.phi0``,
volume ``area/dr``, ``exceed`` on the uncorrected cap), the masked
dens/r/m tendencies, and the deposit of the pseudo-momentum flux.

What bounds it on the H100: 57 B per ray per RHS (11 f32 fields and a
mask byte in, 3 f32 tendencies out), 57 MB at 1e6 rays, ~17 µs at
3.35 TB/s; ~100 flops per ray is far below the compute roofline, so it
should be bound by memory.  One ray per thread, a persistent grid of at
most 4 blocks a SM whose other blocks compute while one waits on its plain
loads (a ``cp.async`` ring of tiles was measured slower and removed,
PERF.md §6), tables in shared memory built from the wind on the card,
float64 deposit partials summed in a fixed order by fixed reducer blocks
in the kernel's tail (the TPU kernel's cross-tile Kahan sum): one launch.

:func:`rhs_fused` launches the kernel for CUDA tensors and runs the plain
twin :func:`rhs_fused_reference` for CPU tensors; ``LAUNCHES`` counts
kernel launches.  :func:`inputs` builds what a call launches with (host
scalars, window, background, fields) once per call, :func:`scratch` the
flux, the partials and the block ranges for the card's plan
(:func:`device_plan`, mirrored by :func:`.ray_physics.stage_plan`), and
:func:`counters` the two arrival counters of a stream, which K1
(:mod:`.projection_cuda`) shares.  Like the JAX
module, this one also holds the window widths of the windowed kernels
K3-K5: :func:`resolve_window_cells`, :func:`resolve_champion` and
:func:`apply_champion`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..constants import ROT_EARTH
from ..state import RayStatics, State, coriolis
from . import adjoint, ray_physics

LAUNCHES = 0

MAX_TABLE = 1025     # csrc/deposit.cuh kMaxCells + 1: cell centers
WINDOW_FLOOR = 16    # the narrowest window of K3-K5, in cells


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def c_pad_for(n_tab: int) -> int:
    """Table length of the windowed kernels: the centers rounded up to a
    multiple of 128 (the window is clipped to ``c_pad - W``)."""
    return _ceil_to(max(n_tab, n_tab - 1), 128)


def resolve_window_cells(cfg, c_pad: int) -> tuple:
    """The two window widths ``(w1, w2)`` of the windowed kernels K3-K5
    and of the window mirror in :mod:`msgwam_tpu_torch.diagnostics`: the
    first has a floor of 16 cells, both round up to a multiple of 8 and
    are capped by ``c_pad``, and the second is off (0) unless it is wider
    than the first."""
    w1 = min(_ceil_to(max(cfg.window_cells, WINDOW_FLOOR), 8), c_pad)
    w2 = (min(_ceil_to(cfg.window_cells2, 8), c_pad - 8)
          if cfg.window_cells2 > 0 else 0)
    if w2 <= w1:
        w2 = 0
    return w1, w2


def resolve_champion(n_ray: int, lifecycle: bool = False,
                     sorted_multi_launch: bool = False) -> dict:
    """The window widths the ``-1`` (auto) settings resolve to:
    ``{"window_cells": 16, "window_cells2": 0}``, the floor with the second
    tier off, at every size.

    The JAX package resolves them from a ladder measured on a TPU.  None
    of it carries over: on the H100 a lookup reads two table entries
    whatever the window's width, so the window's cost is one reduction
    per tile, and the card's own choice waits for a measurement.  The
    arguments are those of the JAX function; the streamed tile height it
    also returns sized the TPU's fast-memory pipeline of the streaming
    kernel, which the port's K6 (``ops/step_cuda_stream.py``) has no use
    for."""
    del n_ray, lifecycle, sorted_multi_launch
    return {"window_cells": WINDOW_FLOOR, "window_cells2": 0}


def apply_champion(cfg, n_ray: int, sorted_multi_launch: bool = False):
    """Resolve the ``window_cells``/``window_cells2`` auto settings (-1)
    by :func:`resolve_champion`; explicit settings stay; returns ``cfg``
    itself when nothing is auto."""
    upd = {}
    if cfg.window_cells < 0 or cfg.window_cells2 < 0:
        ch = resolve_champion(n_ray, lifecycle=cfg.cull or cfg.relaunch,
                              sorted_multi_launch=sorted_multi_launch)
        if cfg.window_cells < 0:
            upd["window_cells"] = ch["window_cells"]
        if cfg.window_cells2 < 0:
            upd["window_cells2"] = ch["window_cells2"]
    return cfg.replace(**upd) if upd else cfg


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


def window_for(cfg, n_tab: int) -> tuple:
    """``(c_pad, w1, w2)`` of the windowed kernels for ``n_tab`` centers."""
    c_pad = c_pad_for(n_tab)
    return (c_pad, *resolve_window_cells(cfg, c_pad))


@functools.lru_cache(maxsize=16)
def _f0(phi0: float) -> float:
    """The rays' ``f0 = 2Ω sin(phi0)``, evaluated in float32 as
    :func:`prepare_inputs` does."""
    return float(2.0 * ROT_EARTH * torch.sin(torch.tensor(phi0,
                                                          dtype=torch.float32)))


class Inputs(NamedTuple):
    """What one call launches with, built once per call: the host scalars
    ``(dt, bvf, kappa, f0, ff0)`` (``ff0`` the wind's Coriolis parameter,
    ``coriolis(phi0)``), the window ``(c_pad, w1, w2)``, the background,
    the 11 ray fields, the mask and the flags."""

    scalars: tuple
    window: tuple
    bg: object
    fields: tuple
    active: torch.Tensor
    online: bool
    faithful: bool
    prognostic: bool


def inputs(dt, state, statics, bg, cfg) -> Inputs:
    """The :class:`Inputs` of a checked float32 state."""
    if cfg.hprop:
        raise ValueError("the fused kernels support hprop=False only")
    return Inputs((float(dt), float(cfg.bvf), float(cfg.kappa), _f0(cfg.phi0),
                   coriolis(cfg.phi0)),
                  window_for(cfg, bg.centers.shape[0]), bg,
                  ray_fields(state, statics), statics.active,
                  bool(cfg.saturate_online), bool(cfg.faithful_saturation),
                  bool(cfg.prognostic_mean))


def device_plan(n: int, n_flux: int, device) -> ray_physics.StagePlan:
    """The kernels' plan on ``device`` (the card's own SM count)."""
    return _device_plan(n, n_flux, torch.device(device).index
                        if torch.device(device).index is not None
                        else torch.cuda.current_device())


@functools.lru_cache(maxsize=64)
def _device_plan(n, n_flux, index) -> ray_physics.StagePlan:
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        _build.check(_build.library().msgwam_rhs_plan(
            n, n_flux, ctypes.addressof(out)), "msgwam_rhs_plan")
    return ray_physics.StagePlan(out[0], out[1])


class Counters:
    """The kernels' two arrival counters on one device and stream, each on a
    128-byte line, zeroed once here: launches alternate between them
    (``parity``, flipped after each launch), and each launch zeroes the one
    it does not use, which the next will."""

    def __init__(self, device):
        self.buf = torch.zeros(64, dtype=torch.int32, device=device)
        self.parity = 0

    def launched(self) -> None:
        self.parity ^= 1


_COUNTERS = {}


def counters(device) -> Counters:
    """The :class:`Counters` of ``device``'s current stream."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = Counters(device)
    return _COUNTERS[key]


class Scratch(NamedTuple):
    """A launch's scratch: the flux, the block partials (entry-major) and
    the blocks' cell ranges; and the plan they are sized for."""

    plan: ray_physics.StagePlan
    flux: torch.Tensor
    partials: torch.Tensor
    ranges: torch.Tensor


def scratch(n: int, n_tab: int, device) -> Scratch:
    """The scratch of one call of ``n`` rays on ``n_tab`` centers."""
    return scratch_for(device_plan(n, n_tab - 1, device), n_tab - 1, device)


def scratch_for(plan, n_flux: int, device) -> Scratch:
    """A launch's scratch for ``plan`` and ``n_flux`` deposit cells: new
    buffers from the allocator's cache, no kernel."""
    return Scratch(plan,
                   torch.empty((2, n_flux), dtype=torch.float32, device=device),
                   torch.empty((2 * n_flux, plan.blocks), dtype=torch.float64,
                               device=device),
                   torch.empty(plan.blocks, dtype=torch.int32, device=device))


def ray_fields(state, statics):
    r = state.rays
    return (r.dens, r.r, r.dr, r.k, r.l, r.m, r.dm, r.phi,
            statics.dkk, statics.dll, statics.rr_mm_area)


def check_inputs(state, statics, bg, name: str = "rhs_fused",
                 max_cells: int = MAX_TABLE):
    """The kernels' input contract: float32 (a float64 state raises
    ``TypeError``, never a silent cast), one device, contiguous ``(n,)``
    ray fields, a bool mask, 3 to ``max_cells`` cells."""
    fields = ray_fields(state, statics)
    n = fields[0].shape[0]
    device = fields[0].device
    tensors = (("state", f) for f in fields)
    for what, x in (*tensors, ("mean.u", state.mean.u), ("mean.v", state.mean.v),
                    ("bg.centers", bg.centers), ("bg.faces", bg.faces),
                    ("bg.rhobar", bg.rhobar),
                    ("bg.pressure_gradient", bg.pressure_gradient)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name}: {what} is on {x.device}, "
                             f"rays on {device}")
    for x in fields:
        if x.shape != (n,) or not x.is_contiguous():
            raise ValueError(f"{name}: every ray field must be a "
                             f"contiguous ({n},) tensor")
    act = statics.active
    if act.dtype != torch.bool or act.shape != (n,) or act.device != device \
            or not act.is_contiguous():
        raise ValueError(f"{name}: active must be a contiguous bool "
                         f"({n},) tensor on {device}")
    n_tab = bg.centers.shape[0]
    if not 3 <= n_tab <= max_cells:
        raise ValueError(f"{name}: 3 to {max_cells} cells supported")
    for what, x, shape in (("mean.u", state.mean.u, (n_tab,)),
                           ("mean.v", state.mean.v, (n_tab,)),
                           ("bg.faces", bg.faces, (n_tab + 1,)),
                           ("bg.rhobar", bg.rhobar, (n_tab,)),
                           ("bg.pressure_gradient", bg.pressure_gradient,
                            (2, n_tab))):
        if x.shape != shape or not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {shape} "
                             f"tensor")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


def rhs_fused(dt, state, statics, bg, cfg):
    """Fused-RHS entry point: ``(tendencies, pm_interior)`` where
    ``tendencies`` is ``{"dens", "r", "m"}`` per ray and ``pm_interior``
    the ``(2, n_cell - 1)`` interior flux profile.  Float32, hprop=False.
    Differentiable in ``dt``, the state, the statics and the background:
    the backward differentiates the composable path (:func:`fused_plain`)."""
    check_inputs(state, statics, bg)

    def kernel(dt, state, statics, bg):
        if state.rays.r.device.type == "cpu":
            return rhs_fused_reference(dt, state, statics, bg, cfg)
        return launch(inputs(dt, state, statics, bg, cfg), *state.mean)

    return adjoint.kernel_call(kernel, functools.partial(fused_plain, cfg=cfg),
                               dt, state, statics, bg)


def fused_plain(dt, state, statics, bg, cfg):
    """What the backward of K2 and K3 differentiates: the composable
    path's ray tendencies and interior flux (``models/rhs.py:
    ray_tendencies``) in :func:`.adjoint.plain_config`, as the JAX
    package's ``_rhs_fused_bwd`` differentiates ``_rhs_xla``."""
    from ..models.rhs import ray_tendencies

    tend, flux = ray_tendencies(dt, state, statics, bg, adjoint.plain_config(cfg))
    return {"dens": tend.dens, "r": tend.r, "m": tend.m}, flux


def launch(inp: Inputs, u, v, work: Scratch = None):
    """One launch of the kernel on inputs that :func:`rhs_fused` has
    checked (no checks here), with the wind ``u``, ``v``: returns the
    tendencies and the flux as :func:`rhs_fused` does."""
    global LAUNCHES
    dt, bvf, kappa, f0, _ = inp.scalars
    bg = inp.bg
    fields = inp.fields
    device = fields[0].device
    n = fields[0].shape[0]
    n_tab = bg.centers.shape[0]
    work = work or scratch(n, n_tab, device)
    dens_st, drr_st, dmm_st = (torch.empty_like(fields[0]) for _ in range(3))
    cnt = counters(device)
    err = _build.library().msgwam_rhs_fused(
        bg.centers.data_ptr(), bg.faces.data_ptr(), u.data_ptr(), v.data_ptr(),
        bg.rhobar.data_ptr(), n_tab, dt, bvf, kappa, f0,
        *(f.data_ptr() for f in fields), inp.active.data_ptr(), n,
        dens_st.data_ptr(), drr_st.data_ptr(), dmm_st.data_ptr(),
        work.flux.data_ptr(), work.partials.data_ptr(), work.ranges.data_ptr(),
        cnt.buf.data_ptr(), cnt.parity, work.plan.blocks, work.plan.reducers,
        int(inp.online), int(inp.faithful),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "msgwam_rhs_fused")
    cnt.launched()
    LAUNCHES += 1
    return {"dens": dens_st, "r": drr_st, "m": dmm_st}, work.flux


def rhs_fused_reference(dt, state: State, statics: RayStatics, bg, cfg):
    """Plain PyTorch twin of the K2 kernel, in the state's own dtype
    (float32 for the kernel's arithmetic, float64 for an oracle): the
    per-ray physics of :mod:`.ray_physics` at full width, a dense
    ``(n, n_cells)`` deposit weight matrix, and the flux summed by the
    kernel's block plan (the H100's)."""
    params, scalars, tables = prepare_inputs(dt, state, statics, bg, cfg)
    fields = ray_fields(state, statics)
    tend, flux, _ = ray_physics.fused(
        params, scalars, tables, fields, statics.active, cfg.saturate_online,
        cfg.faithful_saturation,
        plan=ray_physics.stage_plan(fields[0].shape[0], bg.centers.shape[0] - 1))
    return tend, flux
