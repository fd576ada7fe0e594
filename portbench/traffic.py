"""The general driver: one traffic file's parameters turned into requests
that the port serves, with everything the comparison needs of the
requests it samples.

Three kinds of mix (a traffic file's ``kind``):

* ``whole_run``: each request runs ``steps_per_request`` steps from the
  seeded initial state through the port's whole-run entry,
  ``simulate_resident``, in launches of ``save_every`` steps; each frame
  keeps the mean wind and the rays, and the request's wind frames are
  copied to the host when it ends.
* ``stepwise``: each request is one call of the port's public step entry
  (``models.step``, or ``simulate`` with ``n_steps = save_every`` where
  the deployment relaunches or imposes a wind, which ``step`` does not),
  the caller copying the mean wind to the host after it; the state carries
  from request to request and restarts from the seeded initial state
  every ``restart_every`` steps.
* ``cli_run``: each request is one in-process call of the port's
  experiment driver (``python -m msgwam_tpu_torch run``) on the seeded
  state, its frames streamed to a file and its diagnostics saved, all read
  back by the caller (:mod:`.cli_run`).

The configuration decides the rest: an imposed wind (the tidal shear,
made here for every step) and a relaunch template (the launch population
itself).  A configuration that sets ``"members": E`` is an ensemble of E
independent columns: its ``n_ray`` rays are one seeded draw, split
member-major into ``(E, n_ray // E)``, so each member is its own
stochastic draw, and each member starts from the sine jet.  A
``whole_run`` request on it serves the same day as ``steps_per_request //
save_every`` calls of the port's ensemble entry, ``parallel.
ensemble_simulate(..., backend="mega")`` (one launch of K7 each), with
``n_steps = save_every``, each from the member states the last returned:
that entry takes no ``observe``, so a caller that keeps every member's
rays at every frame calls it once a frame.  The day's member wind frames,
``(2, frames, E, n_cell)``, are copied to the host when it ends.  The
program sees only the inputs made here.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import torch
from torch.profiler import record_function

from . import inputs

def _frame(s, st, aux):
    """What every frame of a whole run keeps: the mean wind and the rays."""
    return (s.mean.u, s.mean.v, s.rays.dens, s.rays.r, s.rays.m, st.active)


def _wind_only(s, st, aux):
    return (s.mean.u, s.mean.v)


class Setup(NamedTuple):
    """The program's inputs and what the reference needs of them."""

    conf: dict
    cfg: object            # the port's ModelConfig
    bg: object             # the port's Background
    state0: object         # the port's State, float32 on the card
    statics0: object
    source: object         # the relaunch template, or None
    wind_fn: object        # the imposed wind, or None
    pop: inputs.Population  # the seeded rays, float32 values in float64
    u0: torch.Tensor       # the initial wind, float32, on the device
    v0: torch.Tensor
    members: int = 0       # E of a member-stacked configuration, else 0


def setup(conf: dict, seed: int, device) -> Setup:
    """The program's inputs for configuration ``conf`` from ``seed``: with
    ``"members": E``, every per-ray field ``(E, n_ray // E)`` and the wind
    ``(E, n_cell)``."""
    import msgwam_tpu_torch as prog

    model = conf["model"]
    cfg = prog.ModelConfig(**model)
    grid = prog.GridConfig(n_face=int(conf["grid"]["n_face"]),
                           z_max=float(conf["grid"]["z_max"]))
    z = inputs.centers(conf["grid"])
    u0 = inputs.sine_jet(z, model).to(torch.float32)
    v0 = torch.zeros_like(u0)
    bg = prog.make_background(grid, cfg, u0, v0, dtype=torch.float32,
                              device=device)
    # the program's float32 values, which the reference reads in float64
    pop = inputs.Population(*(x.to(torch.float32).to(torch.float64)
                              for x in inputs.population(conf, seed, device)))
    members = int(conf.get("members", 0))
    if members:
        if pop.r.shape[0] % members:
            raise ValueError(f"{pop.r.shape[0]} rays do not split into "
                             f"{members} members")
        pop = inputs.Population(*(x.reshape(members, -1) for x in pop))
    f32 = lambda x: x.to(torch.float32)
    rays = prog.RayState(dens=f32(pop.dens), lam=f32(pop.lam), phi=f32(pop.phi),
                         r=f32(pop.r), dr=f32(pop.dr), k=f32(pop.k), l=f32(pop.l),
                         m=f32(pop.m), dm=f32(pop.dm))
    active = torch.ones(pop.r.shape, dtype=torch.bool, device=device)
    statics = prog.RayStatics(dkk=f32(pop.dkk), dll=f32(pop.dll),
                              rr_mm_area=f32(pop.area), active=active)
    u0, v0 = u0.to(device), v0.to(device)
    if members:
        u0, v0 = torch.stack([u0] * members), torch.stack([v0] * members)
    state = prog.State(rays, prog.MeanState(u0.clone(), v0.clone()))
    source = (rays, statics) if model["relaunch"] else None
    wind_fn = None
    if conf["wind"].get("imposed") == "tidal":
        zc = bg.centers

        def wind_fn(t):
            t = t.to(device=zc.device, dtype=zc.dtype)
            u = inputs.tidal(zc, t, model, conf["wind"])
            return u, torch.zeros_like(u)
    return Setup(conf, cfg, bg, state, statics, source, wind_fn, pop, u0, v0,
                 members)


class Item(NamedTuple):
    """One answer to judge: the program's input to ``n_steps`` steps that
    begin at step ``step0`` of the cycle, and its output."""

    step0: int
    n_steps: int
    rays_in: tuple      # dens, r, m, active
    wind_in: tuple      # u, v
    rays_out: tuple
    wind_out: tuple     # u, v as the caller read them on the host
    diag: tuple = None  # the program's wave action and flux of rays_out


class Answer(NamedTuple):
    host: torch.Tensor          # the caller's host copy
    items: list                 # what the check needs (sampled requests)
    failed: bool = False        # the caller's read-back found it short


def sample(seed: int, check: dict, n_launches: int) -> dict:
    """``{request: [launches]}`` to judge, drawn from the seed: request 0's
    first launch (the start, from the seeded inputs alone), and
    ``check["requests"]`` more requests among the first
    ``check["within"]``, each with ``check["launches"]`` of its launches."""
    rng = random.Random(f"portbench-check-{int(seed)}")
    within = max(2, int(check["within"]))
    picked = {0: [0]}
    for i in rng.sample(range(1, within), k=min(int(check["requests"]), within - 1)):
        k = min(int(check["launches"]), n_launches)
        picked[i] = sorted(rng.sample(range(n_launches), k=k))
    return picked


class Driver:
    """Serves the requests of one traffic mix on one configuration."""

    def __init__(self, s: Setup, traffic: dict, seed: int):
        import msgwam_tpu_torch as prog

        self.s = s
        self.kind = traffic["kind"]
        if self.kind not in ("whole_run", "stepwise", "cli_run"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self.steps = int(traffic["steps_per_request"])
        self.save_every = int(traffic["save_every"])
        self.restart = int(traffic["restart_every"])
        self.dt = float(s.conf["dt"])
        self.run = prog.RunConfig(dt=self.dt, n_steps=self.steps,
                                  save_every=self.save_every)
        self.lifecycle = s.source is not None or s.wind_fn is not None
        self.n_launches = self.steps // self.save_every
        if s.members and self.kind != "whole_run":
            raise ValueError("a member-stacked configuration serves whole_run "
                             "mixes only")
        self.picked = sample(seed, traffic["check"], self.n_launches)
        self.prog = prog
        self.cli = None
        if self.kind == "cli_run":
            from .cli_run import CliRun

            if self.lifecycle:
                raise ValueError("a cli_run mix runs a deployment without "
                                 "the lifecycle or an imposed wind")
            self.cli = CliRun(s, traffic)
        self.reset()

    def close(self):
        """Remove what the mix wrote outside the program's state."""
        if self.cli is not None:
            self.cli.close()

    def reset(self):
        self.state, self.statics, self.step_no = self.s.state0, self.s.statics0, 0
        self.last = None

    def request(self, i: int, keep: bool = True) -> Answer:
        """Request ``i`` of the window (``keep``: gather its items when it
        is sampled)."""
        launches = self.picked.get(i, []) if keep else []
        if self.kind == "whole_run":
            return self._whole_run(launches)
        if self.kind == "cli_run":
            return self._cli_run(launches)
        return self._stepwise(i, launches)

    def _whole_run(self, launches) -> Answer:
        s = self.s
        with record_function("portbench.request"):
            if s.members:
                hist = self._ensemble_day()
            else:
                _, _, hist = self.prog.simulate_resident(
                    s.state0, s.statics0, s.bg, s.cfg, self.run, observe=_frame,
                    source=s.source, wind_fn=s.wind_fn)
        with record_function("portbench.host_read"):
            host = torch.stack(hist[:2]).cpu()
        self.last = hist
        items = []
        for f in launches:
            if f == 0:
                r_in = (s.state0.rays.dens, s.state0.rays.r, s.state0.rays.m,
                        s.statics0.active)
                w_in = (s.u0, s.v0)
            else:
                r_in = tuple(h[f - 1] for h in hist[2:])
                w_in = (host[0, f - 1], host[1, f - 1])
            items.append(Item(f * self.save_every, self.save_every, r_in, w_in,
                              tuple(h[f] for h in hist[2:]),
                              (host[0, f], host[1, f])))
        return Answer(host, items)

    def _cli_run(self, launches) -> Answer:
        with record_function("portbench.request"):
            self.cli.request()
        with record_function("portbench.host_read"):
            host = self.cli.host_copy()
        self.judged = launches
        return Answer(host, [])

    def verify(self, ans: Answer) -> Answer:
        """The caller's check of the request just served, which the window
        does not time: a ``cli_run`` mix's read-back of the files and of
        the sampled frames (:meth:`.cli_run.CliRun.read_back`); the other
        mixes gather theirs in the request."""
        if self.kind != "cli_run":
            return ans
        s, back = self.s, self.cli.read_back(ans.host, self.judged)
        items = []
        for f in self.judged if not back.failed else ():
            if f == 0:
                r_in = (s.state0.rays.dens, s.state0.rays.r, s.state0.rays.m,
                        s.statics0.active)
                w_in = (s.u0, s.v0)
            else:
                r_in, w_in = back.rays[f - 1], back.wind[f - 1]
            items.append(Item(f * self.save_every, self.save_every, r_in, w_in,
                              back.rays[f], back.wind[f], back.diag[f]))
        return Answer(ans.host, items, back.failed)

    def _ensemble_day(self) -> tuple:
        """A day of a member-stacked configuration: one call of the
        ensemble entry a launch, each from the member states the last
        returned; :func:`_frame` of each, stacked frame-leading."""
        s = self.s
        launch = self.prog.RunConfig(dt=self.dt, n_steps=self.save_every,
                                     save_every=self.save_every)
        state, statics, frames = s.state0, s.statics0, []
        for f in range(self.n_launches):
            state, statics, _ = self.prog.parallel.ensemble_simulate(
                state, statics, s.bg, s.cfg, launch, backend="mega",
                sources=s.source, wind_fn=s.wind_fn,
                t0=f * self.save_every * self.dt)
            frames.append(_frame(state, statics, None))
        return tuple(torch.stack(x) for x in zip(*frames))

    def _stepwise(self, i: int, launches) -> Answer:
        s = self.s
        if (i * self.steps) % self.restart == 0:
            self.reset()
        state_in, statics_in, k = self.state, self.statics, self.step_no
        with record_function("portbench.request"):
            if self.lifecycle:
                new, new_statics, hist = self.prog.simulate(
                    state_in, statics_in, s.bg, s.cfg, self.run,
                    observe=_wind_only, source=s.source, wind_fn=s.wind_fn,
                    t0=k * self.dt, validate=False)
                wind = (hist[0][-1], hist[1][-1])
            else:
                new, new_statics = state_in, statics_in
                for _ in range(self.steps):
                    new, new_statics, _ = self.prog.step(
                        self.dt, new, new_statics, s.bg, s.cfg)
                wind = (new.mean.u, new.mean.v)
        with record_function("portbench.host_read"):
            host = torch.stack(wind).cpu()
        self.state, self.statics, self.step_no = new, new_statics, k + self.steps
        items = []
        if launches:
            items.append(Item(
                k, self.steps,
                (state_in.rays.dens, state_in.rays.r, state_in.rays.m,
                 statics_in.active),
                (state_in.mean.u, state_in.mean.v),
                (new.rays.dens, new.rays.r, new.rays.m, new_statics.active),
                (host[0], host[1])))
        return Answer(host, items)
