"""K5: whole RK3 steps of the coupled model per launch, as a hand-written
persistent cooperative Hopper kernel that keeps the ray state on chip.

Replaces ``msgwam_tpu/ops/step_pallas.py`` (``_kernel``, entry points
``_megakernel_call``, ``_simulate_resident_impl`` and
``simulate_resident``).  The CUDA source is ``csrc/step_resident.cu``.
:func:`simulate_resident` runs ``run.n_steps`` steps as
``n_steps // save_every`` launches, each of ``save_every`` whole steps.
Each block owns the same 256-ray tiles for the whole launch and keeps
their dens, r, m and RK3 registers in registers (its first tile) and
shared memory (the next ones, as far as they fit), and the frozen terms of
each ray from the launch start; per stage the windowed RHS of K3 with the
RK3 update, the next stage's deposit, one grid-wide wait for the flux
(the block partials summed in a fixed order, by blocks without tiles
where the card has room) and the wind's stage update in every block; in
offline mode the direct saturation with finite-difference rates (quirk 2
included) after the third stage.  :func:`resident_plan` mirrors the
kernel's block plan and on-chip capacity for a given card.

K5 orders its own tiles.  A tile's deposit and windows cost what its rays
span in cells (``csrc/deposit.cuh``), and rays of different vertical
wavenumbers part at different group velocities.  So before every launch
of at least ``ORDER_MIN_STEPS`` steps and ``ORDER_MIN_RAYS`` rays
:func:`tile_order` sorts the caller's slots by the deposit's height cell,
then by m (inactive and non-finite slots last, ties in the caller's
order), and gathers of stacked slabs put the state, the frozen terms and
the mask in that order.  After the launch one scatter puts the frame, with
``dens_prop``, back in the caller's slots, and the next launch orders that
again, so the tiles are a function of the state alone.  Shorter launches
run on the caller's order: there the order's small operations cost more
than the narrower tiles save.  K7 orders each ensemble member's slots by
the same key and cut (``step_cuda_stream.member_tile_order``).

Not ported from the JAX module: ``build_operators``/``_host_linear_map``
(matrices that fed the TPU's matrix unit; the kernel takes the shear and
the flux divergence as differences) and the 131,072-ray cap of the TPU's
fast memory (tiles past the on-chip capacity stream through device memory,
so any count that fits the card runs).  The lifecycle (``cfg.cull``,
``cfg.relaunch``), a prescribed ``wind_fn`` and ``launch_sort=True`` route
to the streaming kernel K6 (:mod:`msgwam_tpu_torch.ops.step_cuda_stream`),
the same CUDA template, which keeps its own opt-in height sort.

Float32 only (a float64 state raises ``TypeError``), ``hprop=False``
(else ``ValueError``); differentiable through the plain path
(:mod:`.adjoint`).  For CPU tensors each launch runs
the plain twin :func:`step_resident_reference`; ``LAUNCHES`` counts
kernel launches.  While a profiler records, the whole run is a span
``msgwam.whole_run`` with its phases (each launch's ordering
``msgwam.whole_run.sort``), each launch (or twin) a span
``msgwam.launch.k5``, and the launches add their tile windows' tiers and
their tiles' placement (on chip, streamed, windows in the scratch) to K5's
counts (:mod:`..utils.profiling`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from ..constants import ROT_EARTH
from ..state import MeanState, State, tree_map
from ..utils import profiling
from . import adjoint, ray_physics, rhs_cuda

LAUNCHES = 0

MAX_PAD = 256        # csrc/step_resident.cu Fixed<256>: c_pad, at most
# The smallest launch whose tiles K5 orders (:func:`tile_order`), from Path
# B days timed on an H100 over launch lengths and populations (PERF.md
# section 6).  The order costs 0.2-0.5 ms of device time and ~0.5 ms of host
# time a launch: from 24 steps an input already in order loses at most ~5%
# to it, and from 1e5 rays the launch hides its host time.
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


def operands(state, statics, bg, cfg, dt) -> Operands:
    """The launch operands for a checked float32 state."""
    n_tab = bg.centers.shape[0]
    c_pad = rhs_cuda.c_pad_for(n_tab)
    w1, w2 = rhs_cuda.resolve_window_cells(cfg, c_pad)
    centers, faces = bg.centers.tolist(), bg.faces.tolist()
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


def launch(ops: Operands, dens, r, m, uv, n_steps: int, tiers=None):
    """One launch of ``n_steps`` whole steps on the card: updates ``dens``,
    ``r``, ``m`` and the ``(2, n_tab)`` wind ``uv`` in place and returns
    ``(dens, r, m, uv, dens_prop)``, ``dens_prop`` the density before the
    last step's offline saturation (a copy of ``dens`` online).  ``tiers``,
    a :func:`..utils.profiling.tier_counter` buffer or ``None``, receives
    the launch's tile windows by tier."""
    global LAUNCHES
    lib = _build.library()
    n = dens.shape[0]
    device = dens.device
    with torch.cuda.device(device):
        with profiling.span("msgwam.whole_run.scratch"):
            plan = device_plan(n, 1, ops, False)
            qd, qr, qm = (torch.empty_like(dens) for _ in range(3))
            r_prev = m_prev = dens_prop = None
            if not ops.online:
                r_prev, m_prev, dens_prop = (torch.empty_like(dens)
                                             for _ in range(3))
            work = scratch(plan, n, 1, ops.n_tab - 1, device)
        with profiling.span("msgwam.launch.k5"):
            err = lib.msgwam_step_resident(
                *ops.scalars, ops.n_tab, ops.c_pad, ops.w1, ops.w2,
                *(x.data_ptr() for x in ops.frozen), ops.active.data_ptr(), n,
                dens.data_ptr(), r.data_ptr(), m.data_ptr(),
                qd.data_ptr(), qr.data_ptr(), qm.data_ptr(),
                _ptr(r_prev), _ptr(m_prev), _ptr(dens_prop),
                uv.data_ptr(), ops.rhobar.data_ptr(), ops.pg.data_ptr(),
                ops.inv_rho.data_ptr(), *(x.data_ptr() for x in work),
                plan.blocks_per_member, n_steps, int(ops.online),
                int(ops.prognostic), int(ops.faithful), _ptr(tiers),
                torch.cuda.current_stream(device).cuda_stream,
            )
            _build.check(err, "msgwam_step_resident")
    count_placement("K5", plan, n_steps)
    LAUNCHES += 1
    return dens, r, m, uv, dens.clone() if ops.online else dens_prop


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
    """Plain PyTorch twin of one launch (any device, the inputs' dtype):
    returns new ``(dens, r, m, uv, dens_prop)`` and modifies nothing; the
    tile windows of every stage go to ``tiers`` by tier, as
    :func:`launch`'s.

    The K6 twin (:func:`msgwam_tpu_torch.ops.step_cuda_stream.
    step_stream_reference`) passes the mask ``act`` (default
    ``ops.active``), the lifecycle ``life`` and a ``(n_steps, 2, n_tab)``
    ``wind`` table; it reads the mask after the run from the sixth entry
    this then returns."""
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


def tile_order(ops: Operands, r, m, active):
    """K5's tile order: the slots of active rays with finite r and m by
    the height cell of their deposit (``trunc(r / dz)``, clamped to
    ``[0, n_tab - 2]`` as ``deposit.cuh:cell_span`` clamps it), then by m,
    and every other slot last.  One stable sort of a 64-bit key (the cell
    above m's float32 bits mapped to their order), so that equal keys keep
    the callers' slot order and the order is a function of the state."""
    dz, nzmax = ops.scalars[1], ops.n_tab - 2
    ok = active & torch.isfinite(r) & torch.isfinite(m)
    cell = torch.trunc(r * (1.0 / dz)).clamp_(0, nzmax)
    cell = torch.where(ok, cell, nzmax + 1).to(torch.int64)
    bits = m.view(torch.int32)
    m_key = torch.where(ok, bits ^ ((bits >> 31) & 0x7FFFFFFF), 0)
    return torch.sort((cell << 32) + m_key, stable=True).indices


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

    def kernel(state, statics, bg):
        return _simulate_resident_impl(state, statics, bg, cfg, run,
                                       include_t0=include_t0, observe=observe)

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
def _simulate_resident_impl(state, statics, bg, cfg, run,
                            include_t0: bool = False, observe=None):
    """``run.n_steps // run.save_every`` launches of ``save_every`` steps
    each, on the slots in :func:`tile_order` from ``ORDER_MIN_STEPS`` steps
    and ``ORDER_MIN_RAYS`` rays; returns ``(final_state, statics,
    history)`` in the caller's slot order.  The frozen ray fields (lam,
    phi, dr, k, l, dm) come from the initial state."""
    from ..models.integrate import StepAux

    with profiling.span("msgwam.whole_run.prepare"):
        check_run(state, cfg, run, "simulate_resident")
        rhs_cuda.check_inputs(state, statics, bg, "simulate_resident", MAX_PAD)
        rays, mean = state.rays, state.mean
        cfg = rhs_cuda.apply_champion(cfg, rays.r.shape[0])
        ops = operands(state, statics, bg, cfg, run.dt)
        tiers = profiling.tier_counter(rays.r.device, "K5")
        if rays.r.device.type == "cuda":
            chunk = functools.partial(launch, tiers=tiers)
        else:
            def chunk(ops, dens, r, m, uv, n_steps):
                with profiling.span("msgwam.launch.k5"):
                    out = step_resident_reference(ops, dens, r, m, uv, n_steps,
                                                  tiers=tiers)
                count_placement("K5", mirror_plan(dens.shape[0], 1, ops), n_steps)
                return out
        # the next launch's (dens, r, m), in the caller's slot order; the
        # kernel updates what it is given in place
        cur = torch.stack([rays.dens, rays.r, rays.m])
        uv = torch.stack([mean.u, mean.v])
        ordered = (run.save_every >= ORDER_MIN_STEPS
                   and rays.r.shape[0] >= ORDER_MIN_RAYS)
        if ordered:
            frozen = torch.stack(ops.frozen)

    def to_state(dens, r, m, uv):
        return State(rays._replace(dens=dens, r=r, m=m),
                     MeanState(uv[0].clone(), uv[1].clone()))

    frames, props = [], []
    with torch.no_grad():
        for _ in range(run.n_steps // run.save_every):
            tile_ops, work = ops, cur
            if ordered:
                with profiling.span("msgwam.whole_run.sort"):
                    order = tile_order(ops, cur[1], cur[2], ops.active)
                    tile_ops = ops._replace(
                        frozen=tuple(frozen.index_select(1, order)),
                        active=ops.active.index_select(0, order))
                    work = cur.index_select(1, order)
            dens, r, m, uv, prop = chunk(tile_ops, *work, uv, run.save_every)
            profiling.add_order("K5", ordered)
            with profiling.span("msgwam.whole_run.frame"):
                if ordered:       # back to the caller's slots
                    out = torch.stack([dens, r, m, prop])
                    out = torch.empty_like(out).index_copy_(1, order, out)
                    (dens, r, m, prop), cur = out, out[:3]
                else:             # a copy for the next launch to update
                    cur = torch.stack([dens, r, m])
                frames.append(to_state(dens, r, m, uv))
                props.append(prop)

    final = frames[-1] if frames else to_state(*cur, uv)
    if observe is not None:
        with profiling.span("msgwam.whole_run.frame"):
            hist = [observe(s, statics, StepAux(dens_prop=p))
                    for s, p in zip(frames, props)]
            if include_t0:
                hist.insert(0, observe(state, statics,
                                       StepAux(dens_prop=rays.dens)))
        with profiling.span("msgwam.whole_run.history"):
            return final, statics, tree_map(lambda *xs: torch.stack(xs), *hist)
    with profiling.span("msgwam.whole_run.history"):
        if include_t0:
            frames.insert(0, state)
            props.insert(0, rays.dens)
        history_state = tree_map(lambda *xs: torch.stack(xs), *frames)
        active = torch.stack([statics.active] * len(frames))
        return final, statics, (history_state, active, torch.stack(props))
