"""Gradients through ray sharding and the ensemble's mesh route, on the CPU:
worlds of 2 and 4 gloo ranks, each a process with a ``file://`` store,
against ``jax.grad`` through the JAX package's ``shard_map``
(``build_sharded_simulate_fn`` under ``jax.set_mesh`` on conftest's
virtual devices).

The loss is the same on every rank: L = a sum((u_T - u_init)^2) + b
sum(dens_T^2), the density gathered, ``a`` and ``b`` the inverses of the
two sums on the port's unsharded run, so that the wind's term, which
reaches the initial state only through the flux, weighs as much as the
density's.  The gradients are taken with respect to a replicated
scalar that scales the density before ``shard_state``, the rank's block of
the scaled density, the initial wind ``u`` and ``bg.rhobar``, and held
relative to the largest entry:

- the composable route (``xla`` deposit, float64, 64 rays, 10 steps, with
  ``remat`` False and ``"full"``) at 1e-12 against a JAX mesh of the
  world's size;
- the K4, K3 (rk4) and K2 routes' twins (float32, 256 rays, 2 steps) at
  5e-4, the bar of tests/test_torch_adjoint_kernels.py, against the JAX
  Pallas path in interpret mode on a mesh of 2 for both worlds (the
  function differentiated is the same whatever the mesh);
- the ensemble's ``scan`` (float64) and ``mega`` (K7's twin, float32) mesh
  routes against the port's meshless gradient, at 1e-12 and 5e-4.

Each route's all-reduces are counted forward and backward.  Both worlds
start before the JAX oracles run and finish after them; each worker has
its own timeout."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.parallel import make_mesh as jax_mesh
from msgwam_tpu.parallel import stack_ensemble as jax_stack
from msgwam_tpu.parallel.sharding import build_sharded_simulate_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 240
F64_TOL = 1e-12
KERNEL_TOL = 5e-4      # tests/test_torch_adjoint_kernels.py:22
N_K = 256              # rays of the kernel routes' case
N_STEPS = 10           # steps of the float64 case
K_STEPS = 2            # steps of the kernel routes' case
WORLDS = (2, 4)
GRADS = ("scale", "dens", "u", "rhobar")
ROUTES = {"K4": dict(rhs_backend="pallas", window_cells=16),
          "K3": dict(rhs_backend="pallas", window_cells=16, integrator="rk4"),
          "K2": dict(rhs_backend="pallas", window_cells=0)}

torch.set_num_threads(1)

WORKER = r"""
import sys
rank, world = int(sys.argv[1]), int(sys.argv[2])
init, out = sys.argv[3], sys.argv[4]
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.ops import collective
from msgwam_tpu_torch.parallel import (
    build_sharded_simulate_fn, ensemble_simulate, gather_state,
    initialize_distributed, make_mesh, shard_state)
from msgwam_tpu_torch.parallel.distributed import shutdown

initialize_distributed(init_method=init, world_size=world, rank=rank,
                       device="cpu")
mesh = make_mesh(world)
emesh = make_mesh(world, axis="ensemble")
inp = torch.load(out + "/../inputs.pt", weights_only=False)
res = {}


def put(name, x):
    res[name] = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def counts():
    return collective.ALL_REDUCES, collective.BACKWARD_ALL_REDUCES


def loss_of(final, u_init, weights):
    a, b = weights
    return a * ((final.mean.u - u_init) ** 2).sum() + b * (final.rays.dens ** 2).sum()


def grads(name, cfg, bg, state, statics, run_local, weights):
    # the loss on the gathered state
    dtype = state.rays.dens.dtype
    scale = torch.ones((), dtype=dtype, requires_grad=True)
    u0 = state.mean.u.clone().requires_grad_(True)
    rho = bg.rhobar.clone().requires_grad_(True)
    whole = state._replace(rays=state.rays._replace(dens=scale * state.rays.dens),
                           mean=state.mean._replace(u=u0))
    s, st = shard_state(mesh, whole, statics)
    s.rays.dens.retain_grad()
    collective.ALL_REDUCES = collective.BACKWARD_ALL_REDUCES = 0
    final = gather_state(mesh, run_local(s, st, bg._replace(rhobar=rho)))
    fwd = counts()
    loss = loss_of(final, state.mean.u, weights)
    collective.ALL_REDUCES = collective.BACKWARD_ALL_REDUCES = 0
    loss.backward()
    put(name + "_reduces", [*fwd, *counts()])
    for k, g in zip(("scale", "dens", "u", "rhobar"),
                    (scale.grad, s.rays.dens.grad, u0.grad, rho.grad)):
        put(f"{name}_{k}", g)


cfg, bg, state, statics = inp["f64"]
run = mtt.RunConfig(dt=120.0, n_steps=%(n_steps)d, save_every=%(n_steps)d)
for remat in (False, "full"):
    grads(f"xla_{remat}", cfg, bg, state, statics,
          lambda s, st, b: mtt.simulate(s, st, b, cfg, run,
                                        axis_name=mesh.get_group("rays"),
                                        remat=remat)[0], inp["weights"]["f64"])

cfg, bg, state, statics = inp["f32"]
run = mtt.RunConfig(dt=120.0, n_steps=%(k_steps)d, save_every=%(k_steps)d)
for route, kw in %(routes)r.items():
    fn = build_sharded_simulate_fn(mesh, cfg.replace(**kw), run)
    grads(route, cfg, bg, state, statics, lambda s, st, b: fn(s, st, b)[0],
          inp["weights"]["f32"])


def ens_grads(name, cfg, bg, states, statics, run, backend):
    dtype = states.rays.dens.dtype
    scale = torch.ones((), dtype=dtype, requires_grad=True)
    u0 = states.mean.u.clone().requires_grad_(True)
    rho = bg.rhobar.clone().requires_grad_(True)
    s = states._replace(rays=states.rays._replace(dens=scale * states.rays.dens),
                        mean=states.mean._replace(u=u0))
    collective.ALL_REDUCES = collective.BACKWARD_ALL_REDUCES = 0
    final = ensemble_simulate(s, statics, bg._replace(rhobar=rho), cfg, run,
                              mesh=emesh, backend=backend)[0]
    fwd = counts()
    loss = loss_of(final, states.mean.u, inp["weights"][backend])
    collective.ALL_REDUCES = collective.BACKWARD_ALL_REDUCES = 0
    loss.backward()
    put(name + "_reduces", [*fwd, *counts()])
    for k, g in zip(("scale", "u", "rhobar"), (scale.grad, u0.grad, rho.grad)):
        put(f"{name}_{k}", g)


cfg, bg, states, statics = inp["ens"]
ens_grads("scan", cfg, bg, states, statics,
          mtt.RunConfig(dt=120.0, n_steps=%(n_steps)d, save_every=%(n_steps)d), "scan")
cfg, bg, states, statics = inp["mega"]
ens_grads("mega", cfg, bg, states, statics,
          mtt.RunConfig(dt=120.0, n_steps=4, save_every=2), "mega")
np.savez(out + "/rank%%d.npz" %% rank, **res)
shutdown()
""" % {"repo": REPO, "n_steps": N_STEPS, "k_steps": K_STEPS, "routes": ROUTES}


def _jax_f64():
    cfg = mt.REFERENCE_RUN_CONFIG
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(gc.centers()),
                                                   cfg))
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu))
    rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=60)
    rays, statics = mt.pad_rays(rays, statics, 64)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def _jax_f32(n, **src):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32", projection_backend="mxu",
        interp_backend="mxu")
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(cfg, bg, n, dtype=jnp.float32,
                                                **src)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def _members(make, n_members=4):
    """Members of one configuration with their own amplitudes, stacked."""
    members = [make(e) for e in range(n_members)]
    cfg, bg = members[0][:2]
    states, statics = jax_stack([m[2:] for m in members])
    return cfg, bg, states, statics


def _jax_ens():
    gc = mt.GridConfig()

    def make(e):
        cfg, bg, state, _ = _jax_f64()
        rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=60,
                                          alpha=0.01 * (1 + 0.2 * e))
        rays, statics = mt.pad_rays(rays, statics, 64)
        return cfg, bg, state._replace(rays=rays), statics

    return _members(make)


def _jax_mega():
    return _members(lambda e: _jax_f32(
        N_K, amplitude_alpha=0.003 * (1 + 0.2 * e)))


def _port(tree):
    return mtt.from_numpy(tree, device="cpu")


def _cfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


def _port_inputs(j):
    cfg, bg, state, statics = j
    return _cfg(cfg), _port(bg), _port(state), _port(statics)


def _weights(final, u_init):
    """The loss's weights: the inverses of its two sums on ``final``."""
    return (1.0 / float(((final.mean.u - u_init) ** 2).sum()),
            1.0 / float((final.rays.dens ** 2).sum()))


def _jax_grads(cfg, bg, state, statics, run, world, weights):
    """``jax.grad`` of the loss through ``shard_map`` on ``world`` virtual
    devices: the gradients in (scale, dens, u, rhobar)."""
    mesh = jax_mesh(world)
    fn = build_sharded_simulate_fn(mesh, cfg, run)
    u_init = state.mean.u
    a, b = weights

    def loss(scale, dens, u, rhobar):
        s = state._replace(rays=state.rays._replace(dens=scale * dens),
                           mean=state.mean._replace(u=u))
        final, _, _ = fn(s, statics, bg._replace(rhobar=rhobar))
        return (a * jnp.sum((final.mean.u - u_init) ** 2)
                + b * jnp.sum(final.rays.dens ** 2))

    one = jnp.asarray(1.0, state.rays.dens.dtype)
    with jax.set_mesh(mesh):
        got = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
            one, state.rays.dens, state.mean.u, bg.rhobar)
    return dict(zip(GRADS, (np.asarray(g) for g in got)))


def _start(root, world: int):
    out = root / f"world{world}"
    out.mkdir()
    script = out / "worker.py"
    script.write_text(WORKER)
    init = f"file://{out / 'store'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), init, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    return out, procs


def _finish(out, procs):
    """Each rank's results, every worker within its own timeout."""
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "ranks failed:\n" + (
        "\n".join(f"rank {r}: exit {p.returncode}\n{o[-2000:]}\n{e[-3000:]}"
                  for r, (p, (o, e)) in enumerate(zip(procs, outs))))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(len(procs))]


def _ens_grads(cfg, bg, states, statics, run, backend, weights):
    """The port's meshless ensemble gradients in (scale, u, rhobar), the
    workers' loss."""
    scale = torch.ones((), dtype=states.rays.dens.dtype, requires_grad=True)
    u0 = states.mean.u.clone().requires_grad_(True)
    rho = bg.rhobar.clone().requires_grad_(True)
    a, b = weights
    s = states._replace(rays=states.rays._replace(dens=scale * states.rays.dens),
                        mean=states.mean._replace(u=u0))
    final = mtt.ensemble_simulate(s, statics, bg._replace(rhobar=rho), cfg, run,
                                  backend=backend)[0]
    loss = (a * ((final.mean.u - states.mean.u) ** 2).sum()
            + b * (final.rays.dens ** 2).sum())
    loss.backward()
    return {"scale": scale.grad, "u": u0.grad, "rhobar": rho.grad}


@pytest.fixture(scope="module")
def oracles(tmp_path_factory):
    """Every world's results, and the gradients they are held to."""
    root = tmp_path_factory.mktemp("shard_grad")
    j = {"f64": _jax_f64(), "f32": _jax_f32(N_K), "ens": _jax_ens(),
         "mega": _jax_mega()}
    port = {k: _port_inputs(v) for k, v in j.items()}
    runs = {"f64": mtt.RunConfig(dt=120.0, n_steps=N_STEPS, save_every=N_STEPS),
            "f32": mtt.RunConfig(dt=120.0, n_steps=K_STEPS, save_every=K_STEPS),
            "scan": mtt.RunConfig(dt=120.0, n_steps=N_STEPS, save_every=N_STEPS),
            "mega": mtt.RunConfig(dt=120.0, n_steps=4, save_every=2)}
    with torch.no_grad():
        cfg, bg, state, statics = port["f64"]
        weights = {"f64": _weights(mtt.simulate(state, statics, bg, cfg,
                                                runs["f64"])[0], state.mean.u)}
        cfg, bg, state, statics = port["f32"]
        weights["f32"] = _weights(mtt.simulate(
            state, statics, bg, cfg.replace(**ROUTES["K4"]), runs["f32"])[0],
            state.mean.u)
        for backend, case in (("scan", "ens"), ("mega", "mega")):
            cfg, bg, states, statics = port[case]
            weights[backend] = _weights(mtt.ensemble_simulate(
                states, statics, bg, cfg, runs[backend], backend=backend)[0],
                states.mean.u)
    torch.save({**port, "weights": weights}, root / "inputs.pt")
    started = {w: _start(root, w) for w in WORLDS}
    try:
        jrun = lambda r: mt.RunConfig(dt=r.dt, n_steps=r.n_steps,
                                      save_every=r.save_every)
        want = {f"xla_{w}": _jax_grads(*j["f64"], jrun(runs["f64"]), w,
                                       weights["f64"]) for w in WORLDS}
        cfg, bg, state, statics = j["f32"]
        for route, kw in ROUTES.items():
            want[route] = _jax_grads(cfg.replace(**kw), bg, state, statics,
                                     jrun(runs["f32"]), 2, weights["f32"])
        for backend, case in (("scan", "ens"), ("mega", "mega")):
            want[backend] = _ens_grads(*port[case], runs[backend], backend,
                                       weights[backend])
    except BaseException:
        for _, procs in started.values():
            for p in procs:
                p.kill()
        raise
    got = {w: _finish(*started[w]) for w in WORLDS}
    return want, got


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.max(np.abs(want - got)) / np.max(np.abs(want))


def _check(want: dict, r: dict, name: str, rank: int, world: int, tol: float):
    for k, w in want.items():
        w = np.asarray(w)
        if k == "dens":
            n = w.shape[0] // world
            w = w[rank * n:(rank + 1) * n]
        assert _rel(w, r[f"{name}_{k}"]) < tol, (name, k, rank)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("remat", [False, "full"])
def test_composable_route_gradient_matches_jax_shard_map(oracles, world, remat):
    """Float64, the xla deposit, 64 rays over 2 and 4 ranks, 10 steps
    through ``simulate(axis_name=...)`` on ``shard_state``'s blocks:
    every rank's gradients at 1e-12 of ``jax.grad`` through ``shard_map``
    on a mesh of the same size.  Forward, 3 all-reduces a step; backward,
    none of the flux without ``remat`` and f's 4 a step (3 RHS
    evaluations and the offline saturation's read of rhobar); with
    ``remat="full"`` each step's replay adds the flux's 3 a step (the
    block's checkpoint and the step's within it replay a step once)."""
    want, got = oracles
    for rank, r in enumerate(got[world]):
        _check(want[f"xla_{world}"], r, f"xla_{remat}", rank, world, F64_TOL)
        replayed = 3 * N_STEPS if remat else 0
        assert r[f"xla_{remat}_reduces"].tolist() == [
            3 * N_STEPS, 0, replayed, 4 * N_STEPS]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_routes_gradients_match_jax_pallas_shard_map(oracles, world,
                                                             route):
    """The twins of K4 (flux tail), K3 (rk4) and K2 through
    ``build_sharded_simulate_fn`` over 2 and 4 ranks, 256 rays, float32, 2
    steps: every rank's gradients within 5e-4 of ``jax.grad`` through the
    JAX package's Pallas path under ``shard_map``.  One all-reduce an RHS
    evaluation forward and one backward (f); K4's backward reruns the
    plain sharded step, which makes the flux's again."""
    want, got = oracles
    per_step = 4 if route == "K3" else 3
    rerun = per_step * K_STEPS if route == "K4" else 0
    for rank, r in enumerate(got[world]):
        _check(want[route], r, route, rank, world, KERNEL_TOL)
        assert r[f"{route}_reduces"].tolist() == [
            per_step * K_STEPS, 0, rerun, per_step * K_STEPS]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend,tol", [("scan", F64_TOL),
                                         ("mega", KERNEL_TOL)])
def test_ensemble_mesh_gradients_match_meshless(oracles, world, backend, tol):
    """Four members over an ``"ensemble"`` mesh of 2 and 4 ranks, ``scan``
    in float64 (10 steps) and ``mega`` through K7's twin in float32 (4
    steps, 256 rays a member): every rank's gradients in the scale, the
    members' winds and rhobar equal to the port's meshless ones, at 1e-12
    and 5e-4.  No all-reduce forward; backward, one, rhobar's."""
    want, got = oracles
    for rank, r in enumerate(got[world]):
        for k, w in want[backend].items():
            assert _rel(w, r[f"{backend}_{k}"]) < tol, (backend, k, rank)
        assert r[f"{backend}_reduces"].tolist() == [0, 0, 0, 1]
