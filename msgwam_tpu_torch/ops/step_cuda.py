"""K5: whole RK3 steps of the coupled model per launch, as a hand-written
persistent cooperative Hopper kernel that keeps the ray state on chip; and
the host launch loop of K5, K6 and K7.

Replaces ``msgwam_tpu/ops/step_pallas.py`` (``_kernel``, entry points
``_megakernel_call``, ``_simulate_resident_impl`` and
``simulate_resident``).  The CUDA source is ``csrc/step_resident.cu``, one
template behind one C entry point: ``kStream = false`` is K5, ``true`` K6
and K7 (:mod:`.step_cuda_stream`).  Each block owns the same 256-ray tiles
for the whole launch and keeps their dens, r, m and RK3 registers in
registers (its first tile) and shared memory (the next ones, as far as they
fit), and the frozen terms of each ray from the launch start; per stage the
windowed RHS of K3 with the RK3 update, the next stage's deposit, one
grid-wide wait for the flux (the block partials summed in a fixed order, by
blocks without tiles where the card has room) and the wind's stage update
in every block; in offline mode the direct saturation with
finite-difference rates (quirk 2 included) after the third stage.
:func:`resident_plan` mirrors the kernel's block plan and on-chip capacity.

The whole-run layer is one loop, :func:`whole_run`: ``n_steps //
save_every`` launches, each :func:`launch` on the card or the plain twin
for CPU tensors (:func:`run_launch`), plan and scratch built once per run.
From its checks to its return the loop never waits on the card (the grid's
scalars come from a host copy, :func:`host_list`), so on the card each
launch queues behind the one still running.  :func:`simulate_resident`
(K5) and the entry points of K6 and K7 hand it what their route adds, as
data, and a slot policy.  K5 and K7 order their own tiles: a tile's
deposit and windows cost what its rays span in cells
(``csrc/deposit.cuh``), and rays of different vertical wavenumbers part at
different group velocities, so before every launch of at least
``ORDER_MIN_STEPS`` steps and ``ORDER_MIN_RAYS`` rays the slots go in
:func:`tile_order` (height cell, then m), and back to the caller's after
it.  Shorter launches run on the caller's order: there the order's small
operations cost more than the narrower tiles save.

Not ported from the JAX module: ``build_operators``/``_host_linear_map``
(matrices that fed the TPU's matrix unit; the kernel takes the shear and
the flux divergence as differences) and the 131,072-ray cap of the TPU's
fast memory (tiles past the on-chip capacity stream through device memory,
so any count that fits the card runs).

Float32 only (a float64 state raises ``TypeError``), ``hprop=False``
(else ``ValueError``); K5 is differentiable through the plain path
(:mod:`.adjoint`).  ``LAUNCHES`` counts K5's kernel launches.  While a
profiler records, the whole run is a span ``msgwam.whole_run`` with its
phases (``.prepare``, ``.template``, ``.wind_table``, ``.sort``,
``.scratch``, ``.frame``, ``.history``), each launch (or twin) a span
``msgwam.launch.k5``, ``k6`` or ``k7``, and the launches add their tile
windows' tiers and their tiles' placement to their kernel's counts, K5's
and K7's their ordered launches (:mod:`..utils.profiling`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build
from ..constants import ROT_EARTH
from ..state import MeanState, State, tree_map
from ..utils import profiling
from . import adjoint, ray_physics, rhs_cuda

LAUNCHES = 0

MAX_PAD = 256        # csrc/step_resident.cu Fixed<256>: c_pad, at most
# The smallest launch whose tiles K5 and K7 order (:func:`tile_order`; K7 on
# all its members' rays), from Path B days timed on an H100 over launch
# lengths and populations (PERF.md section 6).  The order costs 0.2-0.5 ms
# of device time and ~0.5 ms of host time a launch: from 24 steps an input
# already in order loses at most ~5% to it, and from 1e5 rays the launch
# hides its host time.
ORDER_MIN_STEPS = 24
ORDER_MIN_RAYS = 100_000


class Operands(NamedTuple):
    """What a launch reads besides the evolving state: host scalars,
    run-constant ray fields and the background's columns."""

    scalars: tuple         # g0c dz g0f dzf dt bvf kappa f0 rdiv
    n_tab: int
    c_pad: int
    w1: int
    w2: int
    frozen: tuple          # dr k l dm phi dkk dll area (float32, (n,))
    active: torch.Tensor
    rhobar: torch.Tensor   # (n_tab,)
    pg: torch.Tensor       # (2, n_tab)
    inv_rho: torch.Tensor  # (n_tab,) 1 / rhobar, as the TPU kernel
    online: bool
    prognostic: bool
    faithful: bool


# tensor -> (its version, its values as a host list): the grid's host copy
_HOST_LISTS = WeakIdKeyDictionary()


def host_list(x) -> list:
    """``x.tolist()``, read from the device once per tensor and in-place
    edit: kept while ``x`` lives, keyed by its identity and checked against
    its version counter (inference tensors, which have none, are read
    every call).  The grid's scalars come from here, so a launch loop's
    later runs on one background wait on nothing."""
    if x.is_inference():
        return x.tolist()
    got = _HOST_LISTS.get(x)
    if got is None or got[0] != x._version:
        got = _HOST_LISTS[x] = (x._version, x.tolist())
    return got[1]


def operands(state, statics, bg, cfg, dt) -> Operands:
    """The launch operands for a checked float32 state (the grid's
    scalars from :func:`host_list`)."""
    n_tab = bg.centers.shape[0]
    c_pad = rhs_cuda.c_pad_for(n_tab)
    w1, w2 = rhs_cuda.resolve_window_cells(cfg, c_pad)
    centers, faces = host_list(bg.centers), host_list(bg.faces)
    rdiv = 1.0 if cfg.faithful_offline_rates else float(dt)
    scalars = (centers[0], centers[1] - centers[0], faces[1], faces[1] - faces[0],
               float(dt), float(cfg.bvf), float(cfg.kappa),
               2.0 * ROT_EARTH * math.sin(cfg.phi0), rdiv)
    rays = state.rays
    return Operands(
        scalars, n_tab, c_pad, w1, w2,
        (rays.dr, rays.k, rays.l, rays.dm, rays.phi, statics.dkk, statics.dll,
         statics.rr_mm_area),
        statics.active, bg.rhobar, bg.pressure_gradient.contiguous(),
        1.0 / torch.clamp(bg.rhobar, min=1e-30),
        bool(cfg.saturate_online), bool(cfg.prognostic_mean),
        bool(cfg.faithful_saturation))


def _ptr(x):
    return None if x is None else x.data_ptr()


# csrc/step_resident.cu's shared-memory layout
TILE = 256                  # rays per tile = threads per block
BLOCKS_PER_SM = 4           # kBlocksPerSm, the kernel's launch bound
INV_BYTES = 8 * 4 * TILE    # one tile's frozen ray terms (RayInv)
WIN_SHARED = 64             # kWinShared: tile windows kept in shared memory
H100 = {"sms": 132, "smem_per_sm": 233_472, "reserved": 1_024}
# an H100 SXM's SMs, shared memory per SM and reserved per block, in bytes


class Plan(NamedTuple):
    """A launch's block plan (``csrc/step_resident.cu:resident_plan``)."""

    blocks_per_member: int
    tile_blocks: int        # per member; the others only reduce the flux
    tiles_per_block: int    # at most
    smem_slots: int         # tiles per block in shared memory
    smem_bytes: int         # dynamic shared memory per block
    on_chip_tiles: int      # per member, in registers or shared memory
    tiles: int              # per member

    @property
    def on_chip_share(self) -> float:
        return self.on_chip_tiles / self.tiles

    @property
    def scratch_windows(self) -> int:
        """Tile windows per member and stage in the device-memory window
        scratch: a tile block's tiles past its first ``WIN_SHARED``."""
        q, rem = divmod(self.tiles, self.tile_blocks)
        return (rem * max(0, q + 1 - WIN_SHARED)
                + (self.tile_blocks - rem) * max(0, q - WIN_SHARED))


def count_placement(kernel: str, plan: Plan, n_steps: int,
                    n_members: int = 1) -> None:
    """Add a launch's tile-stages on chip and streamed, and its tile
    windows in the window scratch, to ``kernel``'s placement counts while
    a profiler records (:func:`..utils.profiling.add_placement`): the
    plan's per-member tiles times ``n_steps``, three stages and
    ``n_members``.  Host arithmetic only."""
    stages = 3 * n_steps * n_members
    profiling.add_placement(kernel, stages * plan.on_chip_tiles,
                            stages * (plan.tiles - plan.on_chip_tiles),
                            stages * plan.scratch_windows)


def fixed_smem(c_pad: int) -> int:
    """The kernel's static shared memory (``Fixed<kPad>``): flux sums,
    seven tables, the deposit tile, the window scratch, 64 tile windows,
    the per-warp deposit sums and the block's window-tier counts."""
    return 44 * (128 if c_pad <= 128 else 256) + 6672


def slot_bytes(online: bool) -> int:
    """Shared memory of one on-chip tile past the first: dens, r, m, qd,
    qr, qm (and r_prev, m_prev offline) as float32, and the mask byte, per
    ray."""
    return TILE * (4 * (6 if online else 8) + 1)


def resident_plan(n_per: int, n_members: int = 1, c_pad: int = 128,
                  n_flux: int = 99, online: bool = True,
                  prognostic: bool = True, sms: int = H100["sms"]) -> Plan:
    """The block plan of K5 (K6/K7 with ``n_members``) for ``n_per`` rays
    per member, as the kernel computes it on an H100 with ``sms`` SMs.
    Per member, of the ``R = 4 sms // n_members`` resident blocks
    ``min(tiles, R)`` own tiles and, with a prognostic wind, up to
    ``2 n_flux`` of the rest only reduce the flux.  A tile block holds its
    first tile in registers and up to ``B // slot_bytes`` more in shared
    memory, ``B = smem_per_sm / 4 - reserved - fixed_smem`` (45,040 bytes on
    an H100 at ``c_pad = 128``: 7 slots online, 5 offline)."""
    budget = (H100["smem_per_sm"] // BLOCKS_PER_SM - H100["reserved"]
              - fixed_smem(c_pad))
    if c_pad > MAX_PAD or budget < INV_BYTES:
        raise ValueError(f"c_pad {c_pad}: the kernel takes tables of at most "
                         f"{MAX_PAD} entries in its shared memory")
    tiles = -(-n_per // TILE)
    per_member = BLOCKS_PER_SM * sms // n_members
    n_tb = max(1, min(tiles, per_member))
    bpm = n_tb + (min(2 * n_flux, max(0, per_member - n_tb)) if prognostic else 0)
    tpb = -(-tiles // n_tb)
    slots = min(tpb - 1, budget // slot_bytes(online))
    on_chip = sum(min(-(-(tiles - r) // n_tb), slots + 1) for r in range(n_tb))
    smem = INV_BYTES if tpb == 1 else slots * slot_bytes(online)
    return Plan(bpm, n_tb, tpb, slots, smem, on_chip, tiles)


def mirror_plan(n_per: int, n_members: int, ops: "Operands") -> Plan:
    """:func:`resident_plan` for a launch's operands: the plan the CPU
    twins count by."""
    return resident_plan(n_per, n_members, ops.c_pad, ops.n_tab - 1,
                         bool(ops.online), bool(ops.prognostic))


def device_plan(n_per: int, n_members: int, ops: "Operands",
                stream: bool) -> Plan:
    """The kernel's own plan on the current device (``stream``: K6/K7)."""
    return _device_plan(n_per, n_members, ops.c_pad, ops.n_tab - 1,
                        bool(ops.online), bool(ops.prognostic), bool(stream),
                        torch.cuda.current_device())


@functools.lru_cache(maxsize=64)
def _device_plan(n_per, n_members, c_pad, n_flux, online, prognostic, stream,
                 device) -> Plan:
    del device                              # a key: plans differ by card
    out = (ctypes.c_int * 7)()
    _build.check(_build.library().msgwam_step_resident_plan(
        n_per, n_members, c_pad, n_flux, int(online), int(prognostic),
        int(stream), ctypes.addressof(out)), "msgwam_step_resident_plan")
    return Plan(*out)


def scratch(plan: Plan, n: int, n_members: int, n_flux: int, device) -> tuple:
    """The launch's scratch, in the kernel's argument order: the flux and
    the tile blocks' partials (two stages each), the zeroed counters, the
    ``(8, n)`` frozen ray terms (unused when every block owns one tile)
    and the windows of tiles past the 64th of a block."""
    nb = n_members * plan.blocks_per_member
    return (torch.empty((2, n_members, 2, n_flux), dtype=torch.float32,
                        device=device),
            torch.empty((2, n_members, 2 * n_flux, plan.tile_blocks),
                        dtype=torch.float64, device=device),
            torch.zeros((n_members, 2, 2, 32), dtype=torch.int32, device=device),
            torch.empty((8, n) if plan.tiles_per_block > 1 else (8,),
                        dtype=torch.float32, device=device),
            torch.empty((max(1, plan.tiles_per_block - WIN_SHARED), nb),
                        dtype=torch.int32, device=device))


class Work(NamedTuple):
    """A run's plan and scratch (:func:`prepare_launches`): the RK3 registers
    (and r, m a step back offline), :func:`scratch`'s; None for the twin."""

    plan: Plan
    regs: tuple = None      # qd qr qm r_prev m_prev
    scratch: tuple = None


def kernel_name(stream: bool, n_members: int) -> str:
    """K5, or with ``stream`` K6 (one member) or K7."""
    return ("K7" if n_members > 1 else "K6") if stream else "K5"


def prepare_launches(ops: Operands, n_per: int, n_members: int, stream: bool,
                     device) -> Work:
    """The plan and the scratch of a run's launches, built once: the
    kernel's plan (:func:`device_plan`) on the card, the one the twin
    counts by (:func:`mirror_plan`) for CPU tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        return Work(mirror_plan(n_per, n_members, ops))
    n = n_per * n_members
    with torch.cuda.device(device):
        plan = device_plan(n_per, n_members, ops, stream)
        regs = tuple(torch.empty(n, dtype=torch.float32, device=device)
                     if i < 3 or not ops.online else None for i in range(5))
        return Work(plan, regs, scratch(plan, n, n_members, ops.n_tab - 1, device))


def launch(ops: Operands, dens, r, m, uv, act, n_steps: int, n_members: int = 1,
           life: "Lifecycle" = None, wind=None, tiers=None, stream: bool = False,
           work: Work = None):
    """One launch of ``n_steps`` whole steps on the card of K5, or with
    ``stream`` of K6 (K7 with ``n_members > 1``, member-major rays):
    ``dens``, ``r``, ``m``, the ``(n_members, 2, n_tab)`` wind ``uv`` and
    the byte mask ``act`` are updated in place.  K6/K7 take the lifecycle
    ``life`` and the ``(n_steps, 2 or 2 n_members, n_tab)`` wind table
    ``wind``.  ``tiers`` (a :func:`..utils.profiling.tier_counter` buffer
    or ``None``) receives the tile windows by tier; ``work`` is the run's
    :func:`prepare_launches`, made here without it.  Returns ``(dens, r, m,
    uv, dens_prop, act)``, ``dens_prop`` the density before the last step's
    offline saturation or relaunch (else a copy of ``dens``)."""
    global LAUNCHES
    from . import step_cuda_stream

    kernel = kernel_name(stream, n_members)
    n = dens.shape[0]
    relaunch = life is not None and life.src is not None
    device = dens.device
    with torch.cuda.device(device):
        with profiling.span("msgwam.whole_run.scratch"):
            if work is None:
                work = prepare_launches(ops, n // n_members, n_members, stream,
                                        device)
            work.scratch[2].zero_()                 # the sync counters
            dens_prop = (torch.empty_like(dens) if not ops.online or relaunch
                         else None)
        src = life.src if relaunch else (None,) * 4
        with profiling.span(f"msgwam.launch.{kernel.lower()}"):
            err = _build.library().msgwam_step_resident(
                *ops.scalars, ops.n_tab, ops.c_pad, ops.w1, ops.w2,
                *(x.data_ptr() for x in ops.frozen), act.data_ptr(),
                n // n_members, n_members, dens.data_ptr(), r.data_ptr(),
                m.data_ptr(), *map(_ptr, work.regs), _ptr(dens_prop),
                uv.data_ptr(), ops.rhobar.data_ptr(), ops.pg.data_ptr(),
                ops.inv_rho.data_ptr(), *(x.data_ptr() for x in work.scratch),
                work.plan.blocks_per_member, n_steps, int(ops.online),
                int(ops.prognostic), int(ops.faithful), int(stream),
                int(life is not None),
                *((life.m_max, life.face_lo, life.face_hi) if life
                  else (0.0,) * 3),
                *map(_ptr, src), _ptr(wind),
                0 if wind is None else wind.shape[1], _ptr(tiers),
                torch.cuda.current_stream(device).cuda_stream,
            )
            _build.check(err, "msgwam_step_resident")
    count_placement(kernel, work.plan, n_steps, n_members)
    if stream:
        step_cuda_stream.LAUNCHES[kernel] += 1
    else:
        LAUNCHES += 1
    return dens, r, m, uv, dens.clone() if dens_prop is None else dens_prop, act


def run_launch(ops: Operands, dens, r, m, uv, act, n_steps: int, n_members: int,
               life, wind, tiers, stream: bool, work: Work):
    """:func:`launch` on the card, or for CPU tensors its plain twin
    (``step_cuda_stream.step_stream_reference``) in the launch's span,
    written back in place, with the same tier and placement counts."""
    if dens.is_cuda:
        return launch(ops, dens, r, m, uv, act, n_steps, n_members, life, wind,
                      tiers, stream, work)
    from .step_cuda_stream import step_stream_reference

    kernel = kernel_name(stream, n_members)
    with profiling.span(f"msgwam.launch.{kernel.lower()}"):
        *new, prop, new_act = step_stream_reference(
            ops, dens, r, m, uv, act, n_steps, life, wind, n_members, tiers)
    for buf, x in zip((dens, r, m, uv, act), (*new, new_act)):
        buf.copy_(x)
    count_placement(kernel, work.plan, n_steps, n_members)
    return dens, r, m, uv, prop, act


class Lifecycle(NamedTuple):
    """The cull and relaunch of K6/K7 after the third stage: the float32
    bounds, and the relaunch template ``(dens, r, m, active)`` or
    ``None``."""

    m_max: float
    face_lo: float
    face_hi: float
    src: tuple = None


def step_resident_reference(ops: Operands, dens, r, m, uv, n_steps: int,
                            act=None, life: Lifecycle = None, wind=None,
                            tiers=None):
    """Plain PyTorch twin of one launch of K5 (any device, the inputs'
    dtype): returns new ``(dens, r, m, uv, dens_prop)`` and modifies
    nothing; the tile windows of every stage go to ``tiers`` by tier.
    ``step_cuda_stream.step_stream_reference`` passes a member's mask
    ``act`` (default ``ops.active``), lifecycle ``life`` and ``(n_steps, 2,
    n_tab)`` ``wind`` rows, and reads the mask from a sixth entry."""
    g0c, dz, g0f, dzf, dt, bvf, kappa, f0, rdiv = ops.scalars
    params = torch.tensor([g0c, dz, g0f], dtype=dens.dtype, device=dens.device)
    g = ray_physics.geometry(params, ops.n_tab)
    window = (ops.c_pad, ops.w1, ops.w2)
    dr, k, l, dm, phi, dkk, dll, area = ops.frozen
    stream = act is not None or life is not None or wind is not None
    act = ops.active if act is None else act
    u, v = uv[0], uv[1]
    dens_prop = dens
    for step in range(n_steps):
        if wind is not None:
            u, v = wind[step, 0], wind[step, 1]
        r_prev, m_prev = r, m
        qd = qr = qm = qu = qv = None
        for cc, bc, first in ray_physics.RK3_STAGES:
            tables = ((u[1:] - u[:-1]) / dz, (v[1:] - v[:-1]) / dz, ops.rhobar)
            fields = (dens, r, dr, k, l, m, dm, phi, dkk, dll, area)
            tend, flux, tier = ray_physics.fused(params, (dt, bvf, kappa, f0),
                                                 tables, fields, act, ops.online,
                                                 ops.faithful, window)
            profiling.add_tiers(tiers, tier)
            dens, qd = ray_physics.rk3_stage(tend["dens"], dens, qd, dt, cc, bc, first)
            r, qr = ray_physics.rk3_stage(tend["r"], r, qr, dt, cc, bc, first)
            m, qm = ray_physics.rk3_stage(tend["m"], m, qm, dt, cc, bc, first)
            if ops.prognostic:
                pm_flux = torch.cat([flux[:, :1], flux, flux[:, -1:]], dim=1)
                grad = (pm_flux[:, 1:] - pm_flux[:, :-1]) / dzf
                du = f0 * v - (ops.pg[0] + grad[0]) * ops.inv_rho
                dv = -f0 * u - (ops.pg[1] + grad[1]) * ops.inv_rho
                u, qu = ray_physics.rk3_stage(du, u, qu, dt, cc, bc, first)
                v, qv = ray_physics.rk3_stage(dv, v, qv, dt, cc, bc, first)
        dens_prop = dens
        if not ops.online:
            dens = _offline_saturation(ops, g, act, dens, r, m, r_prev, m_prev)
        if life is not None:
            dens, r, m, act = _lifecycle(life, dr, act, dens, r, m)
    out = (dens, r, m, torch.stack([u, v]), dens_prop)
    return out + (act,) if stream else out


def _lifecycle(life: Lifecycle, dr, act, dens, r, m):
    """The cull after a step and, with a template, the relaunch of every
    inactive slot (``step_pallas_stream.py:431-465``)."""
    out = ((r - 0.5 * dr) >= life.face_hi) | ((r + 0.5 * dr) <= life.face_lo)
    crit = torch.abs(m) > life.m_max
    finite = torch.isfinite(dens) & torch.isfinite(r) & torch.isfinite(m)
    new_act = act & ~out & ~crit & finite
    if life.src is None:
        return dens, r, m, new_act
    src_dens, src_r, src_m, src_act = life.src
    return (torch.where(new_act, dens, src_dens), torch.where(new_act, r, src_r),
            torch.where(new_act, m, src_m), new_act | src_act)


def _offline_saturation(ops: Operands, g, act, dens, r, m, r_prev, m_prev):
    """The direct saturation after a step, with finite-difference rates
    (quirk 2: the height rate divided by ``rdiv``), rho read at
    ``r_prev + rate·dt`` through a W-wide window (``step_pallas.py:404-483``)."""
    _, _, _, _, dt, bvf, kappa, f0, rdiv = ops.scalars
    dr, k, l, dm, phi, dkk, dll, area = ops.frozen
    r_fin = r_prev + (r - r_prev) / rdiv * dt
    m_fin = m_prev + (m - m_prev) / dt * dt
    qr = (torch.clamp(r_fin, g.g0c, g.hi_c) - g.g0c) / g.dz
    lo = torch.where(act, torch.floor(qr) - 1.0, ray_physics.EMPTY_LO)
    hi = torch.where(act, torch.floor(qr) + 2.0, ray_physics.EMPTY_HI)
    _, win = ray_physics.ray_window(lo, hi, ops.c_pad, ops.w1, 0)
    rho = ray_physics.lookup(ops.rhobar, qr, win)
    kh2 = k * k + l * l
    omh2 = (bvf * bvf * kh2 + f0 * f0 * m_prev * m_prev) \
        * (1.0 / (kh2 + m_prev * m_prev))
    cap = (kappa * kappa * 0.5 * rho * omh2 * torch.rsqrt(omh2) * bvf * bvf
           / (m_fin * m_fin * (omh2 - f0 * f0)))
    pvol = dkk * dll * (area / dr)
    cap_applied = cap if ops.faithful else cap / pvol
    return torch.where((cap < dens * pvol) & act, cap_applied, dens)


def tile_order(ops: Operands, r, m, active, n_members: int = 1):
    """K5's tile order, K7's member by member within each member's slots
    ``[e n, (e + 1) n)`` of the flat ``r``, ``m`` and ``active``: active
    rays with finite r and m by the height cell of their deposit
    (``trunc(r / dz)``, clamped to ``[0, n_tab - 2]`` as
    ``deposit.cuh:cell_span`` clamps it), then by m, every other slot last.
    One stable sort of a 64-bit key (the cell above m's float32 bits mapped
    to their order) per member: equal keys keep the caller's slot order,
    and the order is a function of the state."""
    dz, nzmax = ops.scalars[1], ops.n_tab - 2
    ok = active & torch.isfinite(r) & torch.isfinite(m)
    cell = torch.trunc(r * (1.0 / dz)).clamp_(0, nzmax)
    cell = torch.where(ok, cell, nzmax + 1).to(torch.int64)
    bits = m.view(torch.int32)
    m_key = torch.where(ok, bits ^ ((bits >> 31) & 0x7FFFFFFF), 0)
    key = ((cell << 32) + m_key).view(n_members, -1)
    order = torch.sort(key, stable=True).indices
    if n_members > 1:
        order += torch.arange(0, r.shape[0], key.shape[1], device=r.device)[:, None]
    return order.view(-1)


def simulate_resident(state, statics, bg, cfg, run, include_t0: bool = False,
                      source=None, wind_fn=None, t0: float = 0.0,
                      launch_sort=None, observe=None, source_key=None):
    """Drop-in fast path for :func:`msgwam_tpu_torch.simulate`: whole RK3
    steps per launch of K5, with the JAX package's signature.

    ``observe(state, statics, aux)`` reduces each history frame as in
    ``simulate``; without it the history is the default ``(State, active,
    dens_prop)`` stacked per save point.  ``include_t0`` prepends the
    initial state.  The lifecycle (``cfg.cull``/``cfg.relaunch``), a
    ``wind_fn`` or ``launch_sort=True`` (K6's height sort; ``None`` is
    off) route the call, with ``source``, ``source_key``, ``t0``,
    ``launch_sort`` and ``observe``, to
    :func:`msgwam_tpu_torch.ops.step_cuda_stream.simulate_streaming` (K6);
    K5 runs the rest.  K5 orders its own tiles before every launch of at
    least ``ORDER_MIN_STEPS`` steps and ``ORDER_MIN_RAYS`` rays, by height
    cell, then m (:func:`tile_order`); frames, ``dens_prop`` and the final
    state come back in the caller's slot order, and the final state's
    frozen fields are the caller's tensors.

    K5's run is differentiable in the state, the statics and the
    background: the backward differentiates :func:`msgwam_tpu_torch.
    simulate` on the composable path (``window_cells=0``,
    :func:`.adjoint.plain_config`), as the JAX package's
    ``simulate_resident`` does (it closes over ``bg``).  The route to K6
    is forward only, as in the JAX package."""
    from . import step_cuda_stream

    if cfg.cull or cfg.relaunch or wind_fn is not None or launch_sort:
        return step_cuda_stream.simulate_streaming(
            state, statics, bg, cfg, run, include_t0=include_t0,
            source=source, wind_fn=wind_fn, t0=t0, launch_sort=launch_sort,
            observe=observe, source_key=source_key)
    del source, source_key, t0
    check_run(state, cfg, run, "simulate_resident")
    kernel = functools.partial(whole_run, cfg=cfg, run=run,
                               name="simulate_resident", order="tiles",
                               observe=observe, include_t0=include_t0)

    def plain(state, statics, bg):
        from ..models.integrate import simulate

        return simulate(state, statics, bg,
                        adjoint.plain_config(cfg, window_cells=0), run,
                        observe=observe, include_t0=include_t0, validate=False)

    return adjoint.kernel_call(kernel, plain, state, statics, bg)


def check_run(state, cfg, run, name: str) -> None:
    """The checks of every whole-run entry point (K5-K7): ``hprop=False``,
    a float32 state (a leading member axis is fine) and whole launches."""
    if cfg.hprop:
        raise ValueError(f"{name} requires hprop=False")
    for what, arr in (("state.rays.dens", state.rays.dens),
                      ("state.mean.u", state.mean.u)):
        if arr.dtype != torch.float32:
            raise TypeError(
                f"{name} computes in float32 but {what} has dtype "
                f"{arr.dtype}; build the state with dtype=float32 (or use "
                f"simulate() for the float64 parity path)")
    if run.n_steps % run.save_every:
        raise ValueError("n_steps must be divisible by save_every")


@profiling.spanned("msgwam.whole_run")
def whole_run(state, statics, bg, cfg, run, name: str, stream: bool = False,
              members: bool = False, order: str = None, life: Lifecycle = None,
              relaunch: bool = False, template=None, draw=None, wind=None,
              observe=None, include_t0: bool = False,
              return_final_perm: bool = False):
    """The host launch loop of K5-K7: ``run.n_steps // run.save_every``
    launches of K5, or with ``stream`` of K6 (K7 with ``members``, a
    leading member axis on every leaf of ``state`` and ``statics``), each
    by :func:`run_launch`.  Returns ``(final_state, statics, history)`` in
    the caller's slots and layout (and with ``return_final_perm`` the last
    launch's slot permutation, ``perm[i]`` the slot at position ``i``);
    ``name`` is the entry point's.  A route adds, as data: ``life`` the
    cull bounds, ``relaunch`` from ``template`` (a fixed template's float32
    ``(4, n)`` rows ``(dens, r, m, active)``) or ``draw()`` (a keyed one's,
    drawn each launch), and ``wind(ci)``, launch ``ci``'s wind table.  On
    the card nothing here waits on it: a route that hands it data that
    does (a keyed template's check) waits there alone.  The
    slot policy ``order`` is ``"tiles"`` (K5, K7: from ``ORDER_MIN_STEPS``
    steps and ``ORDER_MIN_RAYS`` rays each launch in :func:`tile_order`
    from the caller-order state, restored after it), ``"heights"`` (K6's
    launch sort: a stable sort of the heights as the slots lie, inactive
    last, carried from launch to launch) or ``None`` (the caller's order);
    a permutation takes one gather of the stacked slab (state, mask, frozen
    terms, fixed template) and one ``index_copy_`` back for each frame.  A
    frame is ``observe(state, statics, aux)`` or ``(State, active,
    dens_prop)``; ``include_t0`` prepends the initial state's."""
    from ..models.integrate import StepAux

    with profiling.span("msgwam.whole_run.prepare"):
        rays, mean = state.rays, state.mean
        n_members, fstate, fstatics = 1, state, statics
        if members:
            n_members = rays.r.shape[0]
            fstatics = tree_map(torch.flatten, statics)
            fstate = State(tree_map(torch.flatten, rays),
                           MeanState(mean.u[0], mean.v[0]))
        rhs_cuda.check_inputs(fstate, fstatics, bg, name, MAX_PAD)
        n = fstatics.active.shape[0]
        cfg = rhs_cuda.apply_champion(cfg, n)
        ops = operands(fstate, fstatics, bg, cfg, run.dt)
        device = rays.r.device
        tiers = profiling.tier_counter(device, kernel_name(stream, n_members))
        work = prepare_launches(ops, n // n_members, n_members, stream, device)
        tiles = (order == "tiles" and run.save_every >= ORDER_MIN_STEPS
                 and n >= ORDER_MIN_RAYS)
        # the slab as it lies between launches: dens, r, m, the mask, the
        # frozen terms, a fixed template; perm: the caller's slot of each column
        slab = torch.stack([x.to(torch.float32) for x in (
            fstate.rays.dens, fstate.rays.r, fstate.rays.m, fstatics.active,
            *ops.frozen, *(() if template is None else template))])
        perm, cur, out = None, None, slab[:4].unbind()
        active = fstatics.active          # the caller-order mask
        uv = torch.stack([mean.u, mean.v], dim=-2).reshape(n_members, 2, -1)
        shape = (lambda x: x.view(rays.r.shape)) if members else (lambda x: x)

    def to_state(out):
        return State(rays._replace(dens=shape(out[0]), r=shape(out[1]),
                                   m=shape(out[2])),
                     MeanState(*(w.reshape(mean.u.shape).clone()
                                 for w in uv.unbind(1))))

    def frame(out):
        fstate, fact = to_state(out), shape(active)
        if observe is None:
            return fstate, fact, shape(out[4])
        return observe(fstate, statics if life is None
                       else statics._replace(active=fact),
                       StepAux(dens_prop=shape(out[4])))

    frames = []
    if include_t0:
        with profiling.span("msgwam.whole_run.frame"):
            frames.append((state, statics.active, rays.dens) if observe is None
                          else observe(state, statics, StepAux(dens_prop=rays.dens)))
    with torch.no_grad():
        for ci in range(run.n_steps // run.save_every):
            cur = slab
            if tiles or order == "heights":
                with profiling.span("msgwam.whole_run.sort"):
                    step = (tile_order(ops, slab[1], slab[2], active, n_members)
                            if tiles else torch.sort(torch.where(
                                slab[3].bool(), slab[1], math.inf),
                                stable=True).indices)
                    cur = slab.index_select(1, step)
                    perm = step if perm is None else perm[step]
            rows = cur.unbind()           # row views in one call: cheap on the host
            src = rows[12:] if template is not None else None
            if draw is not None:
                with profiling.span("msgwam.whole_run.template"):
                    src = draw()
                    src = (src if perm is None else src[:, perm]).unbind()
            table = None
            if wind is not None:
                with profiling.span("msgwam.whole_run.wind_table"):
                    table = wind(ci)
            life_c = (life._replace(src=(*src[:3], src[3].bool())) if relaunch
                      else life)
            act = rows[3].to(torch.uint8)
            _, _, _, uv, prop, act = run_launch(
                ops._replace(frozen=rows[4:12]), *rows[:3], uv, act,
                run.save_every, n_members, life_c, table, tiers, stream, work)
            if order == "tiles":
                profiling.add_order("K7" if stream else "K5", tiles)
            with profiling.span("msgwam.whole_run.frame"):
                rows[3].copy_(act)
                back = torch.stack([*rows[:4], prop])
                if perm is not None:      # back to the caller's slots
                    back = torch.empty_like(back).index_copy_(1, perm, back)
                if tiles:
                    slab[:4].copy_(back[:4])
                    perm = None
                else:
                    slab = cur
                out = back.unbind()
                if life is not None:
                    active = out[3].bool()
                frames.append(frame(out))
    del slab, cur, work           # the run's buffers, before the history's stacks
    with profiling.span("msgwam.whole_run.history"):
        final = to_state(out)
        if life is not None:
            statics = statics._replace(active=shape(active))
        history = tree_map(lambda *xs: torch.stack(xs), *frames)
    if not return_final_perm:
        return final, statics, history
    return (final, statics, history,
            torch.arange(n, device=device) if perm is None else perm)
