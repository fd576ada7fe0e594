"""The comparison that decides ``correct``.

Every judged answer is a run of ``n_steps`` steps that the program made
from an input state: a launch of a whole run (its frame against the frame
before it, or against the seeded initial state for a request's first
launch) or one step of the step loop (its output against its input).  The
reference runs the same steps in float64 from the same input and the
judged numbers are, over all judged answers:

* ``flux_gap``: the widest gap between the pseudo-momentum flux profile of
  the program's rays and of the reference's, both deposited in float64 by
  the reference, over the largest flux of the reference;
* ``wind_gap`` (a wind coupled to the waves): the widest gap between the
  program's change of the mean wind over the answer, as the caller read it
  on the host, and the reference's, over the reference's largest change.

* ``rays_off``: the share of ray slots whose density, height or
  wavenumber is off the reference's by more than ``RAY_TOL`` of its own
  value, or whose activity differs;
* ``diag_gap`` (an answer that carries the program's diagnostics): the
  widest gap between the program's wave action and wave-action flux of its
  output rays and the reference's deposits of those same rays
  (:mod:`.reference.diagnostics`, each ray's edges and cells in the
  precision the rays are stored in), each over the reference's largest
  value.  A
  deposit of given rays is not chaotic, so it is taken of every such
  answer.

Runs of this model part over tens of steps, and two float64
implementations as far as two float32 ones: the deposit of the reference
model is discontinuous where a ray's top crosses a kilometre face (the
absolute overlap of the origin-0 cell rule), rays pile up at critical
levels, and the flux that moves with them drives the wind that refracts
every ray.  So the reference follows the program from the program's own
state at the start of each judged answer, a request's first launch from
the seeded inputs alone; and in a cell whose limits say
``"profiles": "first_launch"`` the flux and wind gaps are taken only of
the answers that start from the seeded inputs, ``rays_off`` of all.  The
control is the same reference computed in bfloat16, judged the same way.

In a member-stacked configuration (``"members": E``) each member of an
answer is a column of its own, judged as above: its own rays, wind and
flux, the reference advanced from the program's state of that member at
the answer's start.  Each number of the answer is the worst over its
members, so an answer in which two members' states are exchanged reads
as wrong as a single column that is wrong.
"""

from __future__ import annotations

import torch

from .reference import diagnostics as ref_diag
from .reference import model as ref
from .traffic import Item, Setup
from . import inputs

CONTROL_DTYPE = torch.bfloat16
RAY_TOL = 1e-3


def _parts(s: Setup, dtype):
    conf = s.conf
    model = conf["model"]
    p = ref.physics(model)
    pop = s.pop
    col = ref.column(model, conf["grid"], s.u0.double(), s.v0.double(), dtype,
                     pop.r.device)
    c = lambda x: x.to(dtype)
    fz = ref.Frozen(c(pop.k), c(pop.l), c(pop.dr), c(pop.dm), c(pop.phi),
                    c(pop.dkk), c(pop.dll), c(pop.area))
    template = None
    if p.relaunch:
        template = ref.Rays(c(pop.dens), c(pop.r), c(pop.m),
                            torch.ones_like(pop.r, dtype=torch.bool))
    wind = None
    if conf["wind"].get("imposed") == "tidal":
        def wind(t):
            u = inputs.tidal(col.centers, float(t), model, conf["wind"])
            return u, torch.zeros_like(u)
    return p, col, fz, template, wind


def run_item(item: Item, s: Setup, dtype):
    """The reference's (or, in bfloat16, the control's) answer to
    ``item``: ``(rays, u, v)``."""
    p, col, fz, template, wind = _parts(s, dtype)
    rays = _rays(item.rays_in, s, dtype)
    u, v = (w.to(device=s.pop.r.device, dtype=dtype) for w in item.wind_in)
    with torch.no_grad():
        return ref.advance(rays, fz, u, v, col, p, float(s.conf["dt"]),
                           item.n_steps, item.step0, wind, template)


def _rays(rays, s: Setup, dtype) -> ref.Rays:
    """``(dens, r, m, active)`` in ``dtype`` on the reference's device."""
    c = lambda x: x.to(device=s.pop.r.device, dtype=dtype)
    return ref.Rays(c(rays[0]), c(rays[1]), c(rays[2]),
                    rays[3].to(s.pop.r.device).bool())


def diag_gap(item: Item, s: Setup, control: bool = False) -> float:
    """The widest gap of the wave action and of its flux of ``item``'s
    output rays, each over the float64 reference's largest value: the
    program's diagnostics, or with ``control`` the reference's deposits in
    the control's dtype."""
    p, col, fz, _, _ = _parts(s, torch.float64)
    want = ref_diag.wave_action(_rays(item.rays_out, s, torch.float64), fz, col,
                                p.bvf, stored=item.rays_out[1].dtype)
    if control:
        _, col_c, fz_c, _, _ = _parts(s, CONTROL_DTYPE)
        got = ref_diag.wave_action(_rays(item.rays_out, s, CONTROL_DTYPE), fz_c,
                                   col_c, p.bvf)
    else:
        got = item.diag
    d = lambda x: x.to(device=s.pop.r.device, dtype=torch.float64)
    return max(float((d(g) - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def columns(item: Item, s: Setup) -> list:
    """``[(item, setup)]``: the single columns of an answer, one for each
    member of a member-stacked configuration (its rays, its wind, its
    frozen fields and its initial wind), or the answer itself."""
    if not s.members:
        return [(item, s)]
    cut = lambda xs, e: tuple(x[e] for x in xs)
    return [(Item(item.step0, item.n_steps, cut(item.rays_in, e),
                  cut(item.wind_in, e), cut(item.rays_out, e),
                  cut(item.wind_out, e)),
             s._replace(pop=inputs.Population(*cut(s.pop, e)), u0=s.u0[e],
                        v0=s.v0[e], members=0))
            for e in range(s.members)]


def rays_off(got: ref.Rays, want: ref.Rays) -> float:
    """The share of ray slots that are off: active on one side only, or
    with a density, height or wavenumber that differs from the reference's
    by more than ``RAY_TOL`` of the reference's own value."""
    live = got.active | want.active
    off = got.active != want.active
    for a, b in ((got.dens, want.dens), (got.r, want.r), (got.m, want.m)):
        off |= live & ~((a - b).abs() <= RAY_TOL * b.abs())
    return float(off.sum()) / off.numel()


def gaps(item: Item, s: Setup, got, want, profiles: bool = True) -> dict:
    """The judged numbers of one answer: ``got`` and ``want`` are
    ``(rays, u)`` of the judged side and of the float64 reference;
    ``profiles`` false leaves out the flux and wind gaps."""
    p, col, fz, _, _ = _parts(s, torch.float64)
    d = lambda x: x.to(device=s.pop.r.device, dtype=torch.float64)
    as64 = lambda r: _rays(r, s, torch.float64)
    out = {"rays_off": rays_off(as64(got[0]), as64(want[0]))}
    if not profiles:
        return out
    f_got = ref.flux(as64(got[0]), fz, col, p.bvf)
    f_want = ref.flux(as64(want[0]), fz, col, p.bvf)
    out["flux_gap"] = float((f_got - f_want).abs().max() / f_want.abs().max())
    if p.prognostic:
        u_in = d(item.wind_in[0])
        du_want = d(want[1]) - u_in
        out["wind_gap"] = float((d(got[1]) - d(want[1])).abs().max()
                                / du_want.abs().max())
    return out


def judge(items, s: Setup, control: bool = False, profiles: str = "all") -> dict:
    """The widest of each judged number over ``items`` and their members'
    columns: the program's answers, or with ``control`` the control's
    answers to the same inputs.  ``profiles="first_launch"`` takes the
    flux and wind gaps of the answers that start a request's cycle (from
    the seeded inputs) only, and ``rays_off`` of every answer."""
    worst = {}
    for item in items:
        whole = profiles == "all" or item.step0 == 0
        for col, cs in columns(item, s):
            want_rays, want_u, _ = run_item(col, cs, torch.float64)
            if control:
                c_rays, c_u, _ = run_item(col, cs, CONTROL_DTYPE)
                got = (c_rays, c_u)
            else:
                got = (col.rays_out, col.wind_out[0])
            numbers = gaps(col, cs, got, (want_rays, want_u), whole)
            if col.diag is not None:
                numbers["diag_gap"] = diag_gap(col, cs, control)
            for k, v in numbers.items():
                v = float("inf") if v != v else v     # a NaN reads worst
                worst[k] = max(worst.get(k, v), v)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, [[name, value, limit], ...])``: every number at or under
    its limit, and no limit without a number."""
    rows, ok = [], True
    for name, limit in sorted(limits.items()):
        value = numbers.get(name, float("inf"))
        rows.append([name, value, limit])
        ok = ok and value <= limit
    return ok, rows
