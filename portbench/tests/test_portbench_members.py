"""A member-stacked configuration (``"members": E``): its inputs are the
single-column draw split member-major, its answers are judged member by
member, and the single-column configurations keep their inputs and
sampled answers."""

import json

import pytest
import torch

from portbench import check, inputs, manifest, traffic
from portbench.tests.conftest import BENCH

SINGLE = ["ref_1e6", "tidal_1e5"]
SEED = 2**31 + 99
# the sampled answers of the single-column mixes, as drawn before the
# member path was added: {request: [launches]}
PICKS = {
    ("days", 7): {0: [0], 4: [5, 7], 10: [3, 7]},
    ("days", SEED): {0: [0], 18: [2, 3], 1: [4, 6]},
    ("per_step", 7): {0: [0], 436: [0], 1204: [0], 2675: [0], 2042: [0],
                      1339: [0], 885: [0], 1832: [0], 1439: [0], 950: [0],
                      2104: [0], 2806: [0], 2088: [0], 2265: [0], 2370: [0],
                      1932: [0], 1637: [0], 1541: [0], 2330: [0], 848: [0],
                      2920: [0], 820: [0], 1600: [0], 168: [0], 1852: [0]},
}


def config(name, n_ray=512, **extra):
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    conf.update(n_ray=n_ray, **extra)
    return conf


@pytest.mark.parametrize("name", SINGLE)
def test_single_columns_keep_their_inputs(name):
    conf = config(name)
    s = traffic.setup(conf, SEED, "cpu")
    want = [x.to(torch.float32).to(torch.float64)
            for x in inputs.population(conf, SEED, "cpu")]
    assert s.members == 0
    for got, w in zip(s.pop, want):
        assert got.shape == (512,) and torch.equal(got, w)
    for f in ("dens", "lam", "phi", "r", "dr", "k", "l", "m", "dm"):
        assert torch.equal(getattr(s.state0.rays, f),
                           getattr(s.pop, f).to(torch.float32))
    u0 = inputs.sine_jet(inputs.centers(conf["grid"]), conf["model"])
    assert torch.equal(s.u0, u0.to(torch.float32))
    assert torch.equal(s.state0.mean.u, s.u0) and not s.v0.any()


@pytest.mark.parametrize("name", SINGLE)
def test_members_split_the_same_draw(name):
    one = traffic.setup(config(name), SEED, "cpu")
    ens = traffic.setup(config(name, members=8), SEED, "cpu")
    assert ens.members == 8
    for a, b in zip(one.pop, ens.pop):
        assert b.shape == (8, 64) and torch.equal(b.flatten(), a)
    assert torch.equal(ens.state0.rays.r.flatten(), one.state0.rays.r)
    assert ens.statics0.active.shape == (8, 64)
    assert all(torch.equal(u, one.u0) for u in ens.state0.mean.u)
    with pytest.raises(ValueError):
        traffic.setup(config(name, n_ray=500, members=8), SEED, "cpu")


@pytest.mark.parametrize("mix,seed", sorted(PICKS, key=str))
def test_sampled_answers_are_unchanged(mix, seed):
    t = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    n = t["steps_per_request"] // t["save_every"]
    assert traffic.sample(seed, t["check"], n) == PICKS[mix, seed]
    for name in SINGLE:
        for conf in (config(name), config(name, members=8)):
            if conf.get("members") and t["kind"] != "whole_run":
                continue
            d = traffic.Driver(traffic.setup(conf, seed, "cpu"), t, seed)
            assert d.picked == PICKS[mix, seed]


def single(item, s, e):
    """Member ``e`` of an answer and of its setup, as a single column."""
    pick = lambda xs: tuple(x[e] for x in xs)
    return (traffic.Item(item.step0, item.n_steps, pick(item.rays_in),
                         pick(item.wind_in), pick(item.rays_out),
                         pick(item.wind_out)),
            s._replace(pop=inputs.Population(*pick(s.pop)), u0=s.u0[e],
                       v0=s.v0[e], members=0))


def test_a_member_answer_reads_as_its_worst_column(tiny):
    cell = manifest.load(tiny.root, "ens8_125k.days", tiny.root / "pb")
    s = traffic.setup(cell.config, SEED, "cpu")
    d = traffic.Driver(s, cell.traffic, SEED)
    with torch.no_grad():
        items = d.request(0).items
    assert len(items) == 1 and items[0].rays_out[0].shape == (8, 64)
    # member 3's densities off by 2%, so one column reads worse than the rest
    it = items[0]
    dens = it.rays_out[0].clone()
    dens[3] *= 1.02
    bad = it._replace(rays_out=(dens, *it.rays_out[1:]))
    for item in (it, bad):
        cols = [check.judge([c], cs) for c, cs in (single(item, s, e)
                                                    for e in range(8))]
        whole = check.judge([item], s)
        assert whole == {k: max(c[k] for c in cols) for k in whole}
        assert set(whole) == {"flux_gap", "wind_gap", "rays_off"}
    assert check.judge([bad], s)["rays_off"] == 1.0
    assert check.judge([it], s)["rays_off"] < 0.5
