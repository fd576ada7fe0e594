"""K7's tile order (``step_cuda.tile_order`` with ``n_members``): each member's
slots in K5's (height cell, m) order, within the member's own slot range,
before every launch of ``step_cuda.ORDER_MIN_STEPS`` steps and
``ORDER_MIN_RAYS`` rays in all, and the state back in the caller's slots
after it.  A shuffled ensemble's run, read back through the shuffle, is
the unshuffled run; the order is ``tile_order`` member by member; the
ordered launches are counted while a profiler records (K5's too); the
JAX ensemble case of ``test_torch_ensemble`` holds with the order on.  On
the CPU each launch runs the kernel's plain twin; the small runs here
force the order by lowering both constants."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import msgwam_tpu_torch as mtt
import test_torch_ensemble as ens
from msgwam_tpu_torch.ops import step_cuda
from msgwam_tpu_torch.ops.step_cuda_stream import simulate_streaming_ensemble
from msgwam_tpu_torch.parallel import stack_ensemble
from msgwam_tpu_torch.state import MeanState, State
from msgwam_tpu_torch.utils import profiling

torch.set_num_threads(1)

E, N, TOL, RUN = ens.E, ens.N, ens.TOL, ens.RUN


def _order_tiles(monkeypatch, on=True):
    """K5's and K7's tile order on every launch of these small runs, or on
    none."""
    monkeypatch.setattr(step_cuda, "ORDER_MIN_STEPS", 0)
    monkeypatch.setattr(step_cuda, "ORDER_MIN_RAYS", 0 if on else 1 << 40)


def _case(case):
    """``test_torch_ensemble.CASES[case]``'s members, stacked, with every
    seventh slot inactive (so that the order puts slots last), and the
    call's keyword arguments."""
    over, opts = ens.CASES[case]
    cfg, bg, members = ens._members(**over)
    states, statics = stack_ensemble(members)
    idle = (torch.arange(N) % 7 == 3).expand(E, N)
    statics = statics._replace(active=statics.active & ~idle)
    kw = {}
    if opts.get("sources"):
        kw["sources"] = (states.rays, statics)
    winds = ens._tides(cfg, (1.0, 1.5))
    if opts.get("wind") == "member":
        kw["wind_fn"] = winds
    return cfg, bg, states, statics, kw


def _take(tree, perm):
    """Every ``(E, N)`` leaf with member e's slot i holding its ray
    ``perm[e, i]``."""
    return type(tree)(*(torch.gather(x, 1, perm) for x in tree))


@pytest.mark.parametrize("case", ["plain", "lifecycle", "member_wind"])
def test_k7_shuffled_members_come_back_in_their_slots(case, monkeypatch):
    """Each member shuffled on its own: the ordered run, read back through
    the shuffles, is the unshuffled ordered run and the unordered one, per
    slot (final dens, r, m, masks identical, the wind and its history);
    inactive slots stay inactive and unmoved in the caller's slots, and
    the caller's tensors are left as they were."""
    cfg, bg, states, statics, kw = _case(case)
    g = torch.Generator().manual_seed(22)
    perm = torch.stack([torch.randperm(N, generator=g) for _ in range(E)])
    inv = torch.argsort(perm, dim=1)
    sstates = State(_take(states.rays, perm), states.mean)
    sstatics = _take(statics, perm)
    skw = dict(kw)
    if "sources" in kw:
        skw["sources"] = (sstates.rays, sstatics)
    before = [x.clone() for x in sstates.rays]

    _order_tiles(monkeypatch, on=False)
    plain = simulate_streaming_ensemble(states, statics, bg, cfg, RUN, **kw)
    _order_tiles(monkeypatch)
    want = simulate_streaming_ensemble(states, statics, bg, cfg, RUN, **kw)
    got = simulate_streaming_ensemble(sstates, sstatics, bg, cfg, RUN, **skw)

    back = lambda x: torch.gather(x, 1, inv)
    assert all(torch.equal(x, y) for x, y in zip(before, sstates.rays))
    for ref in (want, plain):
        assert torch.equal(ref[1].active, back(got[1].active))
        for f in ("dens", "r", "m"):
            assert ens._rel(getattr(ref[0].rays, f),
                            back(getattr(got[0].rays, f))) < TOL, f
        assert ens._rel(ref[0].mean.u, got[0].mean.u) < TOL
        assert ens._rel(ref[2].u, got[2].u) < TOL
    idle = ~statics.active      # inactive, and the template's too
    assert not back(got[1].active)[idle].any()
    assert torch.equal(back(got[0].rays.r)[idle], states.rays.r[idle])


def _random_column(n_members, n, seed):
    """Flat member-major heights and wavenumbers over the grid and past
    it, with ties in m, non-finite values and inactive slots."""
    g = torch.Generator().manual_seed(seed)
    size = n_members * n
    r = torch.rand(size, generator=g) * 1.2e5 - 1e4
    m = torch.randint(-40, 40, (size,), generator=g).to(torch.float32) * 1e-4
    r[torch.randint(0, size, (5,), generator=g)] = float("nan")
    m[torch.randint(0, size, (5,), generator=g)] = float("inf")
    active = torch.rand(size, generator=g) > 0.1
    return r, m, active


@pytest.mark.parametrize("n_members, n", [(2, 500), (3, 700), (1, 300)])
def test_member_order_is_tile_order_member_by_member(n_members, n):
    """The permutation keeps each member in its slot range and is
    ``tile_order`` of that member alone plus the member's offset,
    bitwise."""
    cfg, bg, members = ens._members()
    state, statics = members[0]
    ops = step_cuda.operands(state, statics, bg, cfg, RUN.dt)
    r, m, active = _random_column(n_members, n, seed=n)
    order = step_cuda.tile_order(ops, r, m, active, n_members)
    assert order.shape == (n_members * n,)
    for e in range(n_members):
        sl = slice(e * n, (e + 1) * n)
        alone = step_cuda.tile_order(ops, r[sl], m[sl], active[sl])
        assert torch.equal(order[sl], alone + e * n)
        assert torch.equal(order[sl].sort().values, torch.arange(e * n, (e + 1) * n))


def test_k7_orders_from_the_caller_order_state(monkeypatch):
    """Every launch orders the state the last launch left, in the caller's
    slots: two launches in one call are bitwise one call, then one more
    from its final state."""
    _order_tiles(monkeypatch)
    cfg, bg, states, statics, kw = _case("plain")
    seen, order = [], step_cuda.tile_order

    def spy(ops, r, m, active, n_members):
        seen.append(r.clone())
        return order(ops, r, m, active, n_members)

    monkeypatch.setattr(step_cuda, "tile_order", spy)
    one = mtt.RunConfig(dt=120.0, n_steps=3, save_every=3)
    straight = simulate_streaming_ensemble(states, statics, bg, cfg, RUN)
    half = simulate_streaming_ensemble(states, statics, bg, cfg, one)
    resumed = simulate_streaming_ensemble(half[0], half[1], bg, cfg, one)
    assert len(seen) == 4
    assert torch.equal(seen[0], states.rays.r.reshape(-1))
    assert torch.equal(seen[1], half[0].rays.r.reshape(-1))
    for f in ("dens", "r", "m"):
        assert torch.equal(getattr(straight[0].rays, f),
                           getattr(resumed[0].rays, f)), f
    assert torch.equal(straight[0].mean.u, resumed[0].mean.u)


def _k5_run(states, statics, bg, cfg, run):
    member = lambda tree: type(tree)(*(x[0] for x in tree))
    state = State(member(states.rays), MeanState(states.mean.u[0],
                                                 states.mean.v[0]))
    return mtt.simulate_resident(state, member(statics), bg, cfg, run)


@pytest.mark.parametrize("kernel", ["K5", "K7"])
def test_ordered_launches_are_counted_above_the_cut(kernel, monkeypatch):
    """``counts()["ordered"][kernel]`` is ``[ordered, launches]``: no
    ordered launch below the cut (launches of 3 steps, or of 24 steps on
    fewer rays than ``ORDER_MIN_RAYS``), every launch from it (K7's cut is
    on all the members' rays), with one ``msgwam.whole_run.sort`` before
    each ordered launch and a ``.frame`` after it; nothing is counted
    without a profiler."""
    cfg, bg, states, statics, _ = _case("plain")
    rays = N if kernel == "K5" else E * N
    go = (lambda run: _k5_run(states, statics, bg, cfg, run)) if kernel == "K5" \
        else (lambda run: simulate_streaming_ensemble(states, statics, bg, cfg,
                                                      run))
    launch = f"msgwam.launch.{kernel.lower()}"

    def counted(run):
        profiling.reset_counts()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            go(run)
        spans = sorted((e for e in prof.events() if e.name.startswith("msgwam.")),
                       key=lambda e: e.time_range.start)
        return profiling.counts()["ordered"][kernel], spans

    day = mtt.RunConfig(dt=120.0, n_steps=24, save_every=24)
    assert step_cuda.ORDER_MIN_STEPS > RUN.save_every
    assert step_cuda.ORDER_MIN_RAYS > rays and step_cuda.ORDER_MIN_STEPS <= 24
    for run in (RUN, day):
        got, spans = counted(run)
        assert got == [0, run.n_steps // run.save_every]
        assert not any(e.name == "msgwam.whole_run.sort" for e in spans)
    monkeypatch.setattr(step_cuda, "ORDER_MIN_STEPS", RUN.save_every)
    monkeypatch.setattr(step_cuda, "ORDER_MIN_RAYS", rays + 1)
    assert counted(RUN)[0] == [0, 2]
    monkeypatch.setattr(step_cuda, "ORDER_MIN_RAYS", rays)
    got, spans = counted(RUN)
    assert got == [2, 2]
    names = [e.name for e in spans if e.name in (
        "msgwam.whole_run.sort", launch, "msgwam.whole_run.frame")]
    assert names == ["msgwam.whole_run.sort", launch, "msgwam.whole_run.frame"] * 2
    profiling.reset_counts()
    go(RUN)
    assert profiling.counts()["ordered"][kernel] == [0, 0]


def test_ordered_k7_matches_jax_ensemble(monkeypatch):
    """``test_torch_ensemble.test_k7_matches_jax_ensemble``'s case (cull,
    relaunch and a shared tidal wind against JAX's one-launch ensemble)
    with both of its launches ordered."""
    _order_tiles(monkeypatch)
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ens.test_k7_matches_jax_ensemble()
    assert profiling.counts()["ordered"]["K7"] == [2, 2]
    assert Counter(e.name for e in prof.events())["msgwam.whole_run.sort"] == 2
