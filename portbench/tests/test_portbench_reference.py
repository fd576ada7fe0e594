"""The reference agrees with the port's plain path (``rhs_backend="xla"``,
exact interpolation and the scatter deposit) in float64 on the CPU, at a
small size, for both configurations."""

import json

import pytest
import torch

import msgwam_tpu_torch as prog
from portbench import check, inputs, traffic
from portbench.reference import model as ref
from portbench.tests.conftest import BENCH

STEPS = 6


def plain(conf):
    model = dict(conf["model"], dtype="float64", rhs_backend="xla",
                 interp_backend="gather", projection_backend="xla")
    return dict(conf, model=model, n_ray=400)


@pytest.mark.parametrize("name", ["ref_1e6", "tidal_1e5"])
def test_reference_follows_the_plain_path(name):
    conf = plain(json.loads((BENCH / "configs" / f"{name}.json").read_text()))
    s = traffic.setup(conf, 1234, torch.device("cpu"))
    d = lambda x: x.to(torch.float64)
    rays = s.state0.rays._replace(**{f: d(getattr(s.state0.rays, f))
                                     for f in s.state0.rays._fields})
    statics = s.statics0._replace(dkk=d(s.statics0.dkk), dll=d(s.statics0.dll),
                                  rr_mm_area=d(s.statics0.rr_mm_area))
    bg = prog.Background(*(d(x) for x in s.bg))
    state = prog.State(rays, prog.MeanState(d(s.u0), d(s.v0)))
    cfg = prog.ModelConfig(**conf["model"])
    wind = None
    if s.wind_fn is not None:
        wind = lambda t: (inputs.tidal(bg.centers, t.to(torch.float64),
                                       conf["model"], conf["wind"]),
                          torch.zeros_like(bg.centers))
    run = prog.RunConfig(dt=conf["dt"], n_steps=STEPS, save_every=STEPS)
    final, fstat, _ = prog.simulate(state, statics, bg, cfg, run,
                                    source=(rays, statics) if s.source else None,
                                    wind_fn=wind)
    item = traffic.Item(0, STEPS, (s.state0.rays.dens, s.state0.rays.r,
                                   s.state0.rays.m, s.statics0.active),
                        (s.u0, s.v0), None, None)
    got_rays, got_u, _ = check.run_item(item, s, torch.float64)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    # float64 round-off of the two implementations' orders of operations
    for f in ("dens", "r", "m"):
        assert rel(getattr(got_rays, f), getattr(final.rays, f)) < 1e-10, f
    assert torch.equal(got_rays.active, fstat.active)
    # a ray at the saturation threshold may be clamped on one side only (an
    # ulp decides), which moves the wind's change by a few 1e-8 of itself
    if conf["model"]["prognostic_mean"]:
        du = final.mean.u - d(s.u0)
        assert float((got_u - final.mean.u).abs().max() / du.abs().max()) < 1e-6
    # the judged flux of the plain path's rays against the reference's
    gaps = check.gaps(item, s, ((final.rays.dens, final.rays.r, final.rays.m,
                                 fstat.active), final.mean.u),
                      (got_rays, got_u))
    assert gaps["flux_gap"] < 1e-8


def test_lifecycle_culls_and_relaunches():
    """A ray past the critical wavenumber is culled and refilled from the
    template; one in the domain with a small |m| is left alone."""
    p = ref.Physics(0.01, 1.0, 0.0, True, False, True, True, 0.02)
    faces = torch.linspace(0, 1e5, 101, dtype=torch.float64)
    col = ref.Column(faces, 0.5 * (faces[1:] + faces[:-1]),
                     torch.ones(100, dtype=torch.float64),
                     torch.zeros(2, 100, dtype=torch.float64))
    one = torch.ones(2, dtype=torch.float64)
    fz = ref.Frozen(one, 0 * one, 500 * one, one, 0 * one, one, one, one)
    rays = ref.Rays(one * 3, torch.tensor([5e3, 6e3], dtype=torch.float64),
                    torch.tensor([-0.01, -0.05], dtype=torch.float64),
                    torch.ones(2, dtype=torch.bool))
    tpl = ref.Rays(one * 7, one * 2e3, -0.003 * one, torch.ones(2, dtype=torch.bool))
    out = ref.lifecycle(rays, col, p, fz, tpl)
    assert out.dens.tolist() == [3.0, 7.0] and out.r.tolist() == [5e3, 2e3]
    assert out.active.tolist() == [True, True]
