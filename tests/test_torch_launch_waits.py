"""The host launch loop of K5-K7 (``step_cuda.whole_run``) waits on the
card nowhere from an entry point's checks to its return: one wind table a
run (``step_cuda_stream._winds``, bitwise the per-launch tables it
replaces, in chunks of whole launches past ``WIND_TABLE_BYTES``), the
grid's scalars from a host copy (``step_cuda.host_list``), and a fixed
relaunch template checked with one read.  On the CPU each launch runs the
kernel's plain twin; the tests marked ``cuda`` run the kernels with
``torch.cuda.set_sync_debug_mode`` on.  Imports no JAX, so the file runs
on the card as it is."""

import math
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.ops import step_cuda, step_cuda_stream
from msgwam_tpu_torch.ops.step_cuda_stream import (simulate_streaming,
                                                   simulate_streaming_ensemble)
from msgwam_tpu_torch.parallel import ensemble_simulate, stack_ensemble
from msgwam_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 600                  # three 256-ray tiles
E = 2
M_MAX = math.pi / 1500.0
RUN = mtt.RunConfig(dt=120.0, n_steps=12, save_every=3)
FROZEN = ("k", "l", "dr", "dm", "phi", "dkk", "dll", "rr_mm_area")


def _config(**kw):
    return mtt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32", "rhs_backend": "pallas",
        "prognostic_mean": False, "m_max": M_MAX, **kw})


def _column(n, device="cpu", **kw):
    """The gaussian spectrum launched at 2 km under the sine jet, from the
    port's own builders."""
    cfg = _config(**kw)
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=torch.float32), cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                             dtype=torch.float32, device=device)
    rays, statics = mtt.gaussian_spectrum_source(
        cfg, bg, n, dtype=torch.float32, device=device, z_launch=2000.0,
        dz_launch=500.0, amplitude_alpha=0.003)
    uu = uu.to(device)
    return cfg, bg, mtt.State(rays, mtt.MeanState(uu, torch.zeros_like(uu))), statics


def _tide(cfg, bg, scale=1.0):
    c = bg.centers
    return lambda t: (scale * mtt.tidal_shear(c, t, cfg, period=43200.0 / scale),
                      torch.zeros_like(c))


def _launch_table(wind_fn, t0, ci, S, dt, n_tab, device):
    """One launch's wind table as the loop built it a launch at a time,
    before the run's table: the float32 times from host scalars, one vmap
    of ``wind_fn`` over the launch's steps."""
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=device)
    ts = f32(t0) + torch.arange(ci * S, ci * S + S, dtype=torch.float32,
                                device=device) * f32(dt)

    def rows(t):
        return torch.stack([
            torch.broadcast_to(torch.as_tensor(w, device=device), (n_tab,))
            .to(torch.float32) for w in wind_fn(t)])

    return torch.func.vmap(rows)(ts).contiguous()


def _equal(a, b) -> bool:
    """Two outputs' tensors, leaf for leaf, bitwise."""
    a, b = (torch.utils._pytree.tree_leaves(x) for x in (a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _counted(fn, calls):
    def wrapped(t):
        calls.append(1)
        return fn(t)
    return wrapped


@pytest.fixture(scope="module")
def column():
    return _column(N, cull=True, relaunch=True)


def _winds_of(case, cfg, bg):
    """The wind of a case: one function, or one per member."""
    tide = _tide(cfg, bg)
    if case == "scalar":
        return lambda t: (2.5 * torch.sin(t * 1e-4), 0.25)
    if case == "members":
        return [tide, _tide(cfg, bg, 1.5)]
    return tide


@pytest.mark.parametrize("case, t0, budget", [
    ("tidal", 0.0, None), ("tidal", 5123.7, None), ("scalar", 0.0, None),
    ("members", 360.0, None), ("tidal", 777.0, 2), ("members", 0.0, 3)])
def test_run_table_is_the_launch_tables_bitwise(column, monkeypatch, case,
                                                t0, budget):
    """Launch ``ci`` reads rows ``[ci S, (ci + 1) S)`` of the run's table,
    bitwise the table the loop built for that launch alone; each function
    is called once a chunk, and a budget of ``budget`` launches' bytes
    builds ``ceil(launches / budget)`` chunks."""
    cfg, bg, state, _ = column
    n_tab, S, L = bg.centers.shape[0], RUN.save_every, RUN.n_steps // RUN.save_every
    wind = _winds_of(case, cfg, bg)
    fns = wind if isinstance(wind, list) else [wind]
    if budget is not None:
        monkeypatch.setattr(step_cuda_stream, "WIND_TABLE_BYTES",
                            budget * S * 2 * len(fns) * n_tab * 4 + 7)
    calls = [[] for _ in fns]
    counted = [_counted(f, c) for f, c in zip(fns, calls)]
    table = step_cuda_stream._winds(counted if isinstance(wind, list)
                                    else counted[0], t0, RUN, bg,
                                    state.rays.r, "K6")
    got = [table(ci) for ci in range(L)]
    want = [torch.cat([_launch_table(f, t0, ci, S, RUN.dt, n_tab, "cpu")
                       for f in fns], dim=1) for ci in range(L)]
    chunks = 1 if budget is None else -(-L // budget)
    assert all(len(c) == chunks for c in calls)
    for g, w in zip(got, want):
        assert g.shape == (S, 2 * len(fns), n_tab) and g.is_contiguous()
        assert g.dtype == torch.float32 and torch.equal(g, w)


def _recorded(fn):
    """``fn()`` under a profiler session from zeroed counts: its result
    and ``profiling.counts()["wind"]``."""
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.counts()["wind"]


@pytest.mark.parametrize("budget", [None, 1, 3])
def test_k6_run_builds_one_table_a_chunk(column, monkeypatch, budget):
    """A K6 run with the tidal wind, the cull and the template counts one
    table a chunk and every launch under a session, and its outputs do not
    depend on the chunking: a budget of one launch is the loop's table a
    launch."""
    cfg, bg, state, statics = column
    L = RUN.n_steps // RUN.save_every
    calls = []
    wind = _counted(_tide(cfg, bg), calls)
    run = lambda: simulate_streaming(state, statics, bg, cfg, RUN,
                                     source=(state.rays, statics), wind_fn=wind)
    with monkeypatch.context() as m:
        m.setattr(step_cuda_stream, "WIND_TABLE_BYTES", 1)
        want = run()
    if budget is not None:
        n_tab = bg.centers.shape[0]
        monkeypatch.setattr(step_cuda_stream, "WIND_TABLE_BYTES",
                            budget * RUN.save_every * 2 * n_tab * 4)
    calls.clear()
    got, wind_counts = _recorded(run)
    chunks = 1 if budget is None else -(-L // budget)
    assert len(calls) == chunks
    assert wind_counts == {"K6": [chunks, L], "K7": [0, 0]}
    assert _equal(want, got)


@pytest.mark.parametrize("per_member", [False, True])
def test_k7_run_builds_one_table(per_member):
    """K7 with a shared or a per-member wind counts one table a run and
    every launch; without a wind it counts nothing."""
    cfg, bg, state, statics = _column(N)
    states, stats = stack_ensemble([(state, statics)] * E)
    wind = ([_tide(cfg, bg), _tide(cfg, bg, 1.5)] if per_member
            else _tide(cfg, bg))
    L = RUN.n_steps // RUN.save_every
    _, got = _recorded(lambda: simulate_streaming_ensemble(
        states, stats, bg, cfg, RUN, wind_fn=wind))
    assert got == {"K6": [0, 0], "K7": [1, L]}
    _, got = _recorded(lambda: simulate_streaming_ensemble(
        states, stats, bg, cfg.replace(prognostic_mean=True), RUN))
    assert got == {"K6": [0, 0], "K7": [0, 0]}


def _scalars(bg):
    """``operands``' grid scalars from a fresh ``.tolist()``."""
    c, f = bg.centers.tolist(), bg.faces.tolist()
    return (c[0], c[1] - c[0], f[1], f[1] - f[0])


def test_operands_grid_scalars_from_the_host_copy():
    """``operands`` gives the scalars a fresh ``.tolist()`` gives, keeps
    the copy while the tensor lives, sees an in-place edit of ``bg.faces``
    (and the cull bounds with it) and a new background."""
    cfg, bg, state, statics = _column(N, cull=True)
    ops = step_cuda.operands(state, statics, bg, cfg, RUN.dt)
    assert ops.scalars[:4] == _scalars(bg)
    assert bg.centers in step_cuda._HOST_LISTS and bg.faces in step_cuda._HOST_LISTS
    again = step_cuda.operands(state, statics, bg, cfg, RUN.dt)
    assert again.scalars == ops.scalars

    life = step_cuda_stream.lifecycle_for(bg, cfg)
    bg.faces.add_(250.0)                      # in place: a new version
    moved = step_cuda.operands(state, statics, bg, cfg, RUN.dt)
    assert moved.scalars[:4] == _scalars(bg)
    assert moved.scalars[2] != ops.scalars[2]
    life2 = step_cuda_stream.lifecycle_for(bg, cfg)
    assert (life2.face_lo, life2.face_hi) == (float(bg.faces[0]),
                                              float(bg.faces[-1]))
    assert life2.face_lo != life.face_lo

    other = bg._replace(centers=bg.centers * 1.5, faces=bg.faces * 1.5)
    new = step_cuda.operands(state, statics, other, cfg, RUN.dt)
    assert new.scalars[:4] == _scalars(other)
    assert new.scalars[:4] != moved.scalars[:4]


def test_host_list_reads_an_inference_tensor_every_call():
    with torch.inference_mode():
        x = torch.arange(4.0)
        assert step_cuda.host_list(x) == [0.0, 1.0, 2.0, 3.0]
        x.add_(1.0)
        assert step_cuda.host_list(x) == [1.0, 2.0, 3.0, 4.0]


@pytest.mark.parametrize("field", FROZEN)
def test_template_that_changes_a_frozen_field_is_named(column, field):
    """A fixed template that changes one frozen field raises the same
    ``ValueError``, naming that field; one that changes two names the
    first of the eight."""
    cfg, bg, state, statics = column
    rays, stats = state.rays, statics
    part = "rays" if field in rays._fields else "statics"
    changed = lambda x: x.clone().index_fill_(0, torch.tensor([5]), 0.123)
    if part == "rays":
        rays = rays._replace(**{field: changed(getattr(rays, field))})
    else:
        stats = stats._replace(**{field: changed(getattr(stats, field))})
    with pytest.raises(ValueError, match=f"template's '{field}' differs"):
        simulate_streaming(state, statics, bg, cfg, RUN, source=(rays, stats))
    later = FROZEN[-1] if field != FROZEN[-1] else FROZEN[0]
    tree = "rays" if later in rays._fields else "statics"
    if tree == "rays":
        rays = rays._replace(**{later: changed(getattr(rays, later))})
    else:
        stats = stats._replace(**{later: changed(getattr(stats, later))})
    first = min(field, later, key=FROZEN.index)
    with pytest.raises(ValueError, match=f"template's '{first}' differs"):
        simulate_streaming(state, statics, bg, cfg, RUN, source=(rays, stats))


def test_template_with_a_nan_differs_as_torch_equal_says(column):
    """A NaN in a frozen field differs from itself, as ``torch.equal``
    has it, so the check raises even on the running state's own tensors."""
    cfg, bg, state, statics = column
    phi = state.rays.phi.clone()
    phi[3] = float("nan")
    nan_state = state._replace(rays=state.rays._replace(phi=phi))
    with pytest.raises(ValueError, match="template's 'phi' differs"):
        simulate_streaming(nan_state, statics, bg, cfg, RUN,
                           source=(nan_state.rays, statics))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, for the tests that run a CUDA kernel; they skip without
    one (decided here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _syncs(fn, mode):
    """``fn()`` with ``torch.cuda.set_sync_debug_mode(mode)`` from its
    call to its return: its result and the synchronizing operations it
    warned of (``"error"`` raises at the first)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, [w for w in seen if "synchroniz" in str(w.message)]


@pytest.mark.cuda
def test_k6_run_waits_on_nothing_on_gpu(cuda_device):
    """K6, three launches with the cull and the tidal wind and no
    template, after a warm-up call: no synchronizing operation from the
    entry to its return."""
    cfg, bg, state, statics = _column(100_000, cuda_device, cull=True)
    run = mtt.RunConfig(dt=120.0, n_steps=216, save_every=72)
    call = lambda: simulate_streaming(state, statics, bg, cfg, run,
                                      wind_fn=_tide(cfg, bg))
    want = call()
    got, _ = _syncs(call, "error")
    assert _equal(want, got)


@pytest.mark.cuda
def test_k7_ensemble_call_waits_on_nothing_on_gpu(cuda_device):
    """One ``ensemble_simulate(..., backend="mega")`` call of
    ``ens8_125k``'s shape (8 members of 125,000 rays, one ordered K7
    launch of 72 steps), after a warm-up call: no synchronizing
    operation from the entry to its return."""
    cfg, bg, state, statics = _column(125_000, cuda_device,
                                      prognostic_mean=True)
    states, stats = stack_ensemble([(state, statics)] * 8)
    run = mtt.RunConfig(dt=120.0, n_steps=72, save_every=72)
    call = lambda: ensemble_simulate(states, stats, bg, cfg, run,
                                     backend="mega")
    want = call()
    got, _ = _syncs(call, "error")
    assert _equal(want, got)


@pytest.mark.cuda
def test_k6_fixed_template_reads_once_on_gpu(cuda_device):
    """K6 with the cull, a fixed template and the tidal wind, after a
    warm-up call: the template check's one read is the run's only
    synchronizing operation."""
    cfg, bg, state, statics = _column(100_000, cuda_device, cull=True,
                                      relaunch=True)
    run = mtt.RunConfig(dt=120.0, n_steps=216, save_every=72)
    call = lambda: simulate_streaming(state, statics, bg, cfg, run,
                                      source=(state.rays, statics),
                                      wind_fn=_tide(cfg, bg))
    call()
    _, syncs = _syncs(call, "warn")
    assert len(syncs) == 1, [str(w.message) for w in syncs]
