"""``correct`` comes out false when the timed path is broken underneath
the harness, and true when it is not: a whole run of each cell's mix on
the CPU (the program's kernels run their plain twins there), with the
port's entry points replaced by broken ones.  The faults a cell on one
card can have: a step that returns its state unchanged; half of the rays
left out, the rest counted twice; an answer altered where it is made;
and in a member-stacked cell, two members' answers exchanged.  (The
exchange between cards has no place in a one-card cell.)"""

import pytest
import torch

import msgwam_tpu_torch as prog

CELLS = ["ref_1e6.days", "ref_1e6.per_step", "tidal_1e5.days",
         "tidal_1e5.per_step", "ens8_125k.days"]
FAULTS = ["unchanged", "half", "altered"]


def broken_rays(fault, rays_in, rays_out):
    """``rays_out`` (a tuple of dens, r, m, ...) as the fault leaves it."""
    dens, r, m = rays_out[:3]
    if fault == "unchanged":
        return tuple(rays_in)
    if fault == "half":
        h = dens.shape[-1] // 2
        twice = lambda x: torch.cat([x[..., :h], x[..., :h]], dim=-1)[..., :x.shape[-1]]
        return (twice(dens), twice(r), twice(m), *rays_out[3:])
    return (dens * 1.01, r, m, *rays_out[3:])


def exchanged(state):
    """``state`` with its first two members' rays and winds exchanged."""
    order = torch.arange(state.rays.r.shape[0])
    order[:2] = torch.tensor([1, 0])
    rays = state.rays._replace(dens=state.rays.dens[order],
                               r=state.rays.r[order], m=state.rays.m[order])
    return state._replace(rays=rays, mean=state.mean._replace(
        u=state.mean.u[order], v=state.mean.v[order]))


def plant(monkeypatch, fault):
    real_resident, real_step, real_simulate, real_ensemble = (
        prog.simulate_resident, prog.step, prog.simulate,
        prog.parallel.ensemble_simulate)

    def resident(state, statics, bg, cfg, run, **kw):
        final, st, hist = real_resident(state, statics, bg, cfg, run, **kw)
        n = hist[2].shape[0]
        first = (state.rays.dens, state.rays.r, state.rays.m)
        frames = broken_rays(fault, tuple(x.expand(n, -1) for x in first),
                             hist[2:5])
        wind = hist[:2]
        if fault == "unchanged":
            wind = (state.mean.u.expand(n, -1), state.mean.v.expand(n, -1))
        return final, st, (*wind, *frames[:3], hist[5])

    def with_rays(state, rays):
        dens, r, m = rays[:3]
        return state._replace(rays=state.rays._replace(dens=dens, r=r, m=m))

    def step(dt, state, statics, bg, cfg, *a):
        new, st, aux = real_step(dt, state, statics, bg, cfg, *a)
        if fault == "unchanged":
            return state, statics, aux
        return with_rays(new, broken_rays(fault, None, (
            new.rays.dens, new.rays.r, new.rays.m))), st, aux

    def simulate(state, statics, bg, cfg, run, **kw):
        new, st, hist = real_simulate(state, statics, bg, cfg, run, **kw)
        if fault == "unchanged":
            return state, statics, hist
        return with_rays(new, broken_rays(fault, None, (
            new.rays.dens, new.rays.r, new.rays.m))), st, hist

    def ensemble(states, statics, bg, cfg, run, **kw):
        final, st, hist = real_ensemble(states, statics, bg, cfg, run, **kw)
        if fault == "unchanged":
            return states, statics, hist
        if fault == "exchanged":
            return exchanged(final), st, hist
        return with_rays(final, broken_rays(fault, None, (
            final.rays.dens, final.rays.r, final.rays.m))), st, hist

    monkeypatch.setattr(prog.parallel, "ensemble_simulate", ensemble)
    monkeypatch.setattr(prog, "simulate_resident", resident)
    monkeypatch.setattr(prog, "step", step)
    monkeypatch.setattr(prog, "simulate", simulate)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny, cell):
    res = tiny(cell, seed=2**31 + 99)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(tiny, monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    res = tiny(cell, seed=2**31 + 99)
    assert not res["correct"], res["checks"]


def test_exchanged_members_are_not_correct(tiny, monkeypatch):
    plant(monkeypatch, "exchanged")
    res = tiny("ens8_125k.days", seed=2**31 + 99)
    assert not res["correct"], res["checks"]
