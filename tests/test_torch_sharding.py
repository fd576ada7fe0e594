"""Ray sharding (``msgwam_tpu_torch.parallel.sharding``) and the ensemble's
mesh route, on the CPU: worlds of 1, 2 and 4 gloo ranks, each a process
with a ``file://`` store, against ``msgwam_tpu.parallel`` (8 virtual CPU
devices from conftest.py) and unsharded ``msgwam_tpu.simulate`` on the same
inputs: the cases of tests/test_sharding.py at 1e-12 in float64, and the
kernel routes' twins (K4, K3, K2, K1) against JAX's Pallas path under
``shard_map`` in interpret mode at 2e-5 in float32, as
tests/test_windowed.py:131-147 holds it.  Each world runs once per module
(its workers run every case and save their results), with a timeout of
60 s per worker; the refusals run in this process."""

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
from msgwam_tpu.parallel import (ensemble_simulate as jax_ensemble,
                                 make_mesh as jax_mesh,
                                 shard_state as jax_shard_state,
                                 sharded_simulate as jax_sharded,
                                 sharded_step_fn as jax_step_fn,
                                 stack_ensemble as jax_stack)
from msgwam_tpu_torch import _build
from msgwam_tpu_torch.ops import collective, rhs_cuda_windowed
from msgwam_tpu_torch.parallel import (P, ensemble_simulate, gather_state,
                                       initialize_distributed, make_mesh,
                                       sharded_simulate)
from msgwam_tpu_torch.parallel.distributed import shutdown

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 60
F64 = dict(rtol=1e-12, atol=1e-15)
KERNEL_TOL = 2e-5      # tests/test_windowed.py:146-147
MEGA_TOL = 1e-5        # tests/test_sharding.py's mega members
N_K = 1024             # rays of the kernel routes' case (Pallas oracles <= 2048)

torch.set_num_threads(1)

WORKER = r"""
import sys
rank, world = int(sys.argv[1]), int(sys.argv[2])
init, out, cases = sys.argv[3], sys.argv[4], sys.argv[5].split(",")
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.ops import collective
from msgwam_tpu_torch.parallel import (
    ensemble_simulate, gather_state, initialize_distributed, make_mesh,
    shard_state, sharded_simulate, sharded_step_fn)
from msgwam_tpu_torch.parallel.distributed import shutdown

initialize_distributed(init_method=init, world_size=world, rank=rank,
                       device="cpu")
mesh = make_mesh(world)
emesh = make_mesh(world, axis="ensemble")
inp = torch.load(out + "/../inputs.pt", weights_only=False)
res = {}


def put(name, x):
    res[name] = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def case_single():
    cfg, bg, state, statics = inp["ref64"]
    run = mtt.RunConfig(dt=120.0, n_steps=30, save_every=30)
    f, _, h = sharded_simulate(mesh, state, statics, bg, cfg, run)
    put("single_local_n", f.rays.r.shape[0])
    put("single_hist_u_shape", h.u.shape)
    g = gather_state(mesh, f)
    for k in ("dens", "m", "r"):
        put("single_" + k, getattr(g.rays, k))
    put("single_u", g.mean.u)


def case_mesh10():
    cfg, bg, state, statics = inp["ref64"]
    run = mtt.RunConfig(dt=120.0, n_steps=10, save_every=10)
    f, _, _ = sharded_simulate(mesh, state, statics, bg, cfg, run)
    put("mesh10_u", f.mean.u)


def case_cull():
    cfg, bg, state, statics, source = inp["cull"]
    run = mtt.RunConfig(dt=120.0, n_steps=40, save_every=40)
    f, st, _ = sharded_simulate(mesh, state, statics, bg, cfg, run,
                                source=source)
    put("cull_u", f.mean.u)
    put("cull_active", gather_state(mesh, st).active)


def case_step_fn():
    cfg, bg, state, statics = inp["ref64"]
    s8, st8 = shard_state(mesh, state, statics)
    put("step_local_n", s8.rays.dens.shape[0])
    put("step_mean_n", s8.mean.u.shape[0])
    put("step_local_r", s8.rays.r)
    s1, st1 = sharded_step_fn(mesh, bg, cfg, 120.0)(s8, st8)
    put("step_u", s1.mean.u)
    put("step_dens", gather_state(mesh, s1.rays).dens)


def case_refusals():
    cfg, bg, state, statics = inp["ref64"]
    cut = lambda tree: mtt.state.tree_map(lambda x: x[:63], tree)
    try:
        shard_state(mesh, state._replace(rays=cut(state.rays)), cut(statics))
    except ValueError as e:
        put("refuse_odd_rays", str(e))
    members = mtt.stack_ensemble([(state, statics)] * 3)
    run = mtt.RunConfig(dt=120.0, n_steps=1, save_every=1)
    try:
        ensemble_simulate(*members, bg, cfg, run, mesh=emesh)
    except ValueError as e:
        put("refuse_members", str(e))


def case_ens_scan():
    cfg, bg, bstate, bstat = inp["ens"]
    run = mtt.RunConfig(dt=120.0, n_steps=10, save_every=10)
    es, _, eh = ensemble_simulate(bstate, bstat, bg, cfg, run, mesh=emesh)
    put("ens_u", es.mean.u)
    put("ens_hist_u", eh.u)


def case_k():
    cfg, bg, state, statics = inp["k"]
    run = mtt.RunConfig(dt=120.0, n_steps=2, save_every=2)
    for route, kw in (("K4", dict(rhs_backend="pallas", window_cells=16)),
                      ("K3", dict(rhs_backend="pallas", window_cells=16,
                                  integrator="rk4")),
                      ("K2", dict(rhs_backend="pallas", window_cells=0)),
                      ("K1", dict(rhs_backend="xla",
                                  projection_backend="pallas"))):
        collective.ALL_REDUCES = 0
        f, _, _ = sharded_simulate(mesh, state, statics, bg,
                                   cfg.replace(**kw), run)
        put("k_all_reduces_" + route, collective.ALL_REDUCES)
        g = gather_state(mesh, f)
        for k in ("dens", "r", "m"):
            put(f"k_{route}_{k}", getattr(g.rays, k))
        put(f"k_{route}_u", g.mean.u)


def case_mega():
    cfg, bg, bstate, bstat = inp["mega"]
    run = mtt.RunConfig(dt=120.0, n_steps=4, save_every=2)
    fin, st, mh = ensemble_simulate(bstate, bstat, bg, cfg, run, mesh=emesh,
                                    backend="mega")
    for k in ("dens", "r", "m"):
        put("mega_" + k, getattr(fin.rays, k))
    put("mega_u", fin.mean.u)
    put("mega_hist_u", mh.u)


for c in cases:
    globals()["case_" + c]()
np.savez(out + "/rank%%d.npz" %% rank, **res)
shutdown()
""" % {"repo": REPO}


def _jax_ref64(capacity=64):
    cfg = mt.REFERENCE_RUN_CONFIG
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(gc.centers()),
                                                   cfg))
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu))
    rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=60)
    rays, statics = mt.pad_rays(rays, statics, capacity)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def _jax_cull():
    cfg = mt.REFERENCE_RUN_CONFIG.replace(cull=True, relaunch=True,
                                          m_max=2 * np.pi / 3500.0)
    gc = mt.GridConfig()
    uu = 40.0 * np.tanh((gc.centers() - 30e3) / 1e4)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu))
    source = mt.gaussian_spectrum_source(cfg, bg, 64)
    state = mt.State(source[0], mt.MeanState(jnp.asarray(uu), jnp.zeros(100)))
    return cfg, bg, state, source[1], source


def _jax_ens():
    cfg, bg, state, _ = _jax_ref64()
    gc = mt.GridConfig()
    members = [mt.wave_packet_ic(gc, cfg, bg, n_ray=60,
                                 alpha=0.01 * (1 + 0.2 * i)) for i in range(4)]
    brays, bstat = jax_stack(members)
    uu = np.asarray(state.mean.u)
    bstate = mt.State(brays, mt.MeanState(
        jnp.broadcast_to(jnp.asarray(uu), (4,) + uu.shape),
        jnp.zeros((4,) + uu.shape)))
    return cfg, bg, bstate, bstat, members, uu


def _jax_f32(n):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32", projection_backend="mxu",
        interp_backend="mxu")
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(gc.centers(), jnp.float32), cfg)).astype(np.float32)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=jnp.float32)
    return cfg, bg, uu


def _jax_k():
    cfg, bg, uu = _jax_f32(N_K)
    rays, statics = mt.gaussian_spectrum_source(cfg, bg, N_K,
                                                dtype=jnp.float32)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu))))
    return cfg, bg, state, statics


def _jax_mega():
    cfg, bg, uu = _jax_f32(500)
    members = []
    for e in range(4):
        rays, statics = mt.gaussian_spectrum_source(
            cfg, bg, 500, amplitude_alpha=0.003 * (1 + 0.2 * e),
            dtype=jnp.float32)
        members.append((mt.State(rays, mt.MeanState(
            jnp.asarray(uu), jnp.zeros_like(jnp.asarray(uu)))), statics))
    return cfg, bg, jax_stack(members)


def _port(tree):
    return mtt.from_numpy(tree, device="cpu")


def _cfg(cfg):
    return mtt.ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_inputs():
    return {"ref64": _jax_ref64(), "cull": _jax_cull(), "ens": _jax_ens(),
            "k": _jax_k(), "mega": _jax_mega()}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, jax_inputs):
    """The port's inputs, from the JAX package's, saved for the workers."""
    root = tmp_path_factory.mktemp("shard")
    j = jax_inputs
    cfg, bg, state, statics = j["ref64"]
    ccfg, cbg, cstate, cstatics, csource = j["cull"]
    ecfg, ebg, estate, estat = j["ens"][:4]
    kcfg, kbg, kstate, kstatics = j["k"]
    mcfg, mbg, (mstate, mstat) = j["mega"]
    torch.save({
        "ref64": (_cfg(cfg), _port(bg), _port(state), _port(statics)),
        "cull": (_cfg(ccfg), _port(cbg), _port(cstate), _port(cstatics),
                 _port(tuple(csource))),
        "ens": (_cfg(ecfg), _port(ebg), _port(estate), _port(estat)),
        "k": (_cfg(kcfg), _port(kbg), _port(kstate), _port(kstatics)),
        "mega": (_cfg(mcfg), _port(mbg), _port(mstate), _port(mstat)),
    }, root / "inputs.pt")
    return root


def _spmd(root, world: int, cases):
    """``world`` gloo ranks running ``cases``: each rank's results."""
    out = root / f"world{world}"
    out.mkdir()
    script = out / "worker.py"
    script.write_text(WORKER)
    init = f"file://{out / 'store'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), init, str(out),
         ",".join(cases)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    # every rank's report: one that aborted because a peer failed first
    # shows beside that peer
    assert all(p.returncode == 0 for p in procs), "ranks failed:\n" + (
        "\n".join(f"rank {r}: exit {p.returncode}\n{o[-2000:]}\n{e[-3000:]}"
                  for r, (p, (o, e)) in enumerate(zip(procs, outs))))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world1(run_dir):
    return _spmd(run_dir, 1, ["single"])


@pytest.fixture(scope="module")
def world2(run_dir):
    return _spmd(run_dir, 2, ["single", "mesh10", "cull", "step_fn",
                              "ens_scan", "k", "mega", "refusals"])


@pytest.fixture(scope="module")
def world4(run_dir):
    return _spmd(run_dir, 4, ["single", "mesh10"])


def _simulate(cfg, bg, run, **kw):
    return jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run, **kw))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_equals_single_device(request, jax_inputs, world):
    """30 steps of the reference experiment at capacity 64 over 1, 2 and 4
    ranks: the JAX package's 8-device sharded run and its single-device
    run, at 1e-12."""
    res = request.getfixturevalue(f"world{world}")
    cfg, bg, state, statics = jax_inputs["ref64"]
    run = mt.RunConfig(dt=120.0, n_steps=30, save_every=30)
    single, _, _ = _simulate(cfg, bg, run)(state, statics)
    sharded, _, hist = jax_sharded(jax_mesh(8), state, statics, bg, cfg, run)
    for want in (single, sharded):
        for r in res:
            np.testing.assert_allclose(r["single_u"], np.asarray(want.mean.u),
                                       **F64)
            for k in ("dens", "m", "r"):
                np.testing.assert_allclose(r["single_" + k],
                                           np.asarray(getattr(want.rays, k)),
                                           rtol=1e-12)
    assert all(int(r["single_local_n"]) == 64 // world for r in res)
    assert tuple(res[0]["single_hist_u_shape"]) == np.asarray(hist.u).shape \
        == (1, 100)


@pytest.mark.parametrize("world", [2, 4])
def test_world_matches_the_same_jax_mesh(request, jax_inputs, world):
    """10 steps over k ranks against the JAX package on a mesh of k
    devices and unsharded (tests/test_sharding.py::test_mesh_size_2_and_4),
    every rank's replicated wind alike."""
    res = request.getfixturevalue(f"world{world}")
    cfg, bg, state, statics = jax_inputs["ref64"]
    run = mt.RunConfig(dt=120.0, n_steps=10, save_every=10)
    ref, _, _ = _simulate(cfg, bg, run)(state, statics)
    sharded, _, _ = jax_sharded(jax_mesh(world), state, statics, bg, cfg, run)
    for want in (ref, sharded):
        for r in res:
            np.testing.assert_allclose(r["mesh10_u"], np.asarray(want.mean.u),
                                       **F64)


def test_sharded_with_cull_and_relaunch(world2, jax_inputs):
    """Cull and relaunch stay local to each rank: 40 steps over 2 ranks
    with a relaunch template, the wind at 1e-12 and the mask equal to the
    JAX package's sharded and single-device runs; culls fire."""
    cfg, bg, state, statics, source = jax_inputs["cull"]
    run = mt.RunConfig(dt=120.0, n_steps=40, save_every=40)
    ref, refst, _ = _simulate(cfg, bg, run, source=source)(state, statics)
    _, st_cull, _ = _simulate(cfg.replace(relaunch=False), bg, run)(state,
                                                                   statics)
    assert (~np.asarray(st_cull.active)).any()
    jf, jst, _ = jax_sharded(jax_mesh(8), state, statics, bg, cfg, run,
                             source=source)
    for want, want_st in ((ref, refst), (jf, jst)):
        for r in world2:
            np.testing.assert_allclose(r["cull_u"], np.asarray(want.mean.u),
                                       **F64)
            np.testing.assert_array_equal(r["cull_active"].astype(bool),
                                          np.asarray(want_st.active))


def test_sharded_step_fn_and_placement(world2, jax_inputs):
    """shard_state gives each rank its contiguous block of the rays and the
    whole wind; one sharded step matches the JAX package's sharded step and
    the unsharded step at 1e-12."""
    cfg, bg, state, statics = jax_inputs["ref64"]
    r_all = np.asarray(state.rays.r)
    for rank, r in enumerate(world2):
        assert int(r["step_local_n"]) == 32 and int(r["step_mean_n"]) == 100
        np.testing.assert_array_equal(r["step_local_r"],
                                      r_all[32 * rank:32 * (rank + 1)])
    mesh = jax_mesh(8)
    s8, st8 = jax_shard_state(mesh, state, statics)
    s1, _ = jax_step_fn(mesh, bg, cfg, 120.0)(s8, st8)
    s1b, _, _ = mt.step(120.0, state, statics, bg, cfg)
    for want in (s1, s1b):
        for r in world2:
            np.testing.assert_allclose(r["step_u"], np.asarray(want.mean.u),
                                       **F64)
            np.testing.assert_allclose(r["step_dens"],
                                       np.asarray(want.rays.dens), rtol=1e-12)


def test_ensemble_scan_mesh_matches_members(world2, jax_inputs):
    """The scan backend over an "ensemble" mesh of 2 ranks (2 members
    each): every member, gathered to every rank, equals the JAX package's
    4-device ensemble run and its own single-member run at 1e-12."""
    cfg, bg, bstate, bstat, members, uu = jax_inputs["ens"]
    run = mt.RunConfig(dt=120.0, n_steps=10, save_every=10)
    mesh = jax.make_mesh((4,), ("ensemble",), devices=jax.devices()[:4])
    es, _, eh = jax_ensemble(bstate, bstat, bg, cfg, run, mesh=mesh)
    sim = _simulate(cfg, bg, run)
    for r in world2:
        np.testing.assert_allclose(r["ens_u"], np.asarray(jax.device_get(
            es.mean.u)), **F64)
        np.testing.assert_allclose(r["ens_hist_u"], np.asarray(
            jax.device_get(eh.u)), **F64)
    for e in (0, 3):
        s_e = mt.State(members[e][0], mt.MeanState(
            jnp.asarray(uu), jnp.zeros_like(jnp.asarray(uu))))
        f_e, _, _ = sim(s_e, members[e][1])
        np.testing.assert_allclose(world2[0]["ens_u"][e],
                                   np.asarray(f_e.mean.u), **F64)


@pytest.mark.parametrize("route,kw", [
    ("K4", dict(rhs_backend="pallas", window_cells=16)),
    ("K3", dict(rhs_backend="pallas", window_cells=16, integrator="rk4")),
    ("K2", dict(rhs_backend="pallas", window_cells=0)),
    ("K1", dict(rhs_backend="xla", projection_backend="pallas")),
])
def test_kernel_routes_sharded_match_jax_pallas(world2, jax_inputs, route, kw):
    """The kernel routes' twins sharded over 2 ranks (1024 rays, float32,
    2 steps; K4 in its flux tail, K3 (rk4), K2 and K1 with the all-reduce
    after them: one all-reduce an RHS evaluation, three a step, four with
    rk4) against the JAX package's Pallas path under shard_map on 2
    devices, in interpret mode, at 2e-5."""
    cfg, bg, state, statics = jax_inputs["k"]
    run = mt.RunConfig(dt=120.0, n_steps=2, save_every=2)
    want, _, _ = jax_sharded(jax_mesh(2), state, statics, bg, cfg.replace(**kw),
                             run)
    per_step = 4 if kw.get("integrator") == "rk4" else 3
    for r in world2:
        assert int(r["k_all_reduces_" + route]) == per_step * run.n_steps
        for k in ("dens", "r", "m"):
            assert _rel(getattr(want.rays, k), r[f"k_{route}_{k}"]) < KERNEL_TOL, k
        assert _rel(want.mean.u, r[f"k_{route}_u"]) < KERNEL_TOL


def test_ensemble_mega_mesh_matches_unsharded_twin(world2, jax_inputs):
    """backend="mega" over an "ensemble" mesh of 2 ranks, 2 members a rank
    in one K7 launch a window (its twin here): every member within 1e-5 of
    the unsharded twin's, the member-leading history too."""
    cfg, bg, (bstate, bstat) = jax_inputs["mega"]
    run = mtt.RunConfig(dt=120.0, n_steps=4, save_every=2)
    fin, _, mh = ensemble_simulate(_port(bstate), _port(bstat), _port(bg),
                                   _cfg(cfg), run, backend="mega")
    assert tuple(mh.u.shape) == (4, 2, 100)
    for r in world2:
        for k in ("dens", "r", "m"):
            assert _rel(getattr(fin.rays, k), r["mega_" + k]) < MEGA_TOL, k
        assert _rel(fin.mean.u, r["mega_u"]) < MEGA_TOL
        assert _rel(mh.u, r["mega_hist_u"]) < MEGA_TOL


@pytest.fixture
def world_of_one():
    """A world of 1 in this process, taken down after the test."""
    assert not torch.distributed.is_initialized()
    initialize_distributed(device="cpu")
    try:
        yield
    finally:
        shutdown()


def _port_ref64(jax_inputs):
    cfg, bg, state, statics = jax_inputs["ref64"]
    return _cfg(cfg), _port(bg), _port(state), _port(statics)


def test_refusals(world2, world_of_one, jax_inputs):
    """Over 2 ranks, 63 rays (the error names pad_rays) and 3 members do
    not divide; in a world of 1 (the default gloo backend on the CPU), a
    mesh that is not the world, a callable source and a custom observe
    without its spec raise."""
    for r in world2:
        assert "pad with msgwam_tpu_torch.pad_rays" in str(r["refuse_odd_rays"])
        assert "do not divide over the 2 ranks" in str(r["refuse_members"])
    assert torch.distributed.get_backend() == "gloo"
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2)
    mesh = make_mesh()
    cfg, bg, state, statics = _port_ref64(jax_inputs)
    run = mtt.RunConfig(dt=120.0, n_steps=2, save_every=2)
    with pytest.raises(ValueError, match="callable"):
        sharded_simulate(mesh, state, statics, bg, cfg, run,
                         source=lambda key: None)
    with pytest.raises(ValueError, match="observe_spec"):
        sharded_simulate(mesh, state, statics, bg, cfg, run,
                         observe=lambda s, st, aux: s.mean)


def test_sharded_runs_are_forward_only(world_of_one, jax_inputs):
    """Only the K1 and K6 routes stay forward only, sharded or not: the
    calls that refused a gradient before now give one, in a world of 1,
    bitwise the unsharded call's (the composable ``simulate`` in float64,
    the K2-route ``rhs``, the sharded K4 step through its flux tail, whose
    backward reruns the plain step with its all-reduces), f's sum over one
    rank skipped; ``checked`` skips the per-call checks with grad mode left
    on; the sharded K1 route refuses a gradient, as the unsharded one
    does."""
    mesh = make_mesh()
    group = mesh.get_group("rays")

    def grads(fn, state, with_group):
        dens = state.rays.dens.clone().requires_grad_(True)
        u = state.mean.u.clone().requires_grad_(True)
        out = fn(state._replace(rays=state.rays._replace(dens=dens),
                                mean=state.mean._replace(u=u)),
                 group if with_group else None)
        loss = sum((x.double() ** 2).sum()
                   / (x.detach().double() ** 2).sum().clamp_min(1.0)
                   for x in _build._tensors(out) if x.requires_grad)
        return torch.autograd.grad(loss, (dens, u))

    def same(fn, state):
        collective.ALL_REDUCES = collective.BACKWARD_ALL_REDUCES = 0
        got = grads(fn, state, True)
        assert collective.ALL_REDUCES > 0 == collective.BACKWARD_ALL_REDUCES
        for w, g in zip(grads(fn, state, False), got):
            assert torch.isfinite(g).all() and g.abs().max() > 0
            assert torch.equal(w, g)

    cfg, bg, state, statics = _port_ref64(jax_inputs)
    run = mtt.RunConfig(dt=120.0, n_steps=2, save_every=2)
    same(lambda s, g: mtt.simulate(s, statics, bg, cfg, run, axis_name=g)[0],
         state)
    cfg32, bg32, s32, st32 = (_cfg(jax_inputs["k"][0]),
                              *map(_port, jax_inputs["k"][1:]))
    k2 = cfg32.replace(rhs_backend="pallas", window_cells=0)
    same(lambda s, g: mtt.rhs(120.0, s, st32, bg32, k2, g), s32)
    k4 = cfg32.replace(rhs_backend="pallas", window_cells=16)
    same(lambda s, g: rhs_cuda_windowed.rk3_step_fused_windowed(
        120.0, s, st32, bg32, k4, g), s32)
    # a whole run checks its group once at its entry; grad mode stays on
    with collective.checked(group):
        assert torch.is_grad_enabled()
        collective.check_group("rays")
    with pytest.raises(TypeError, match="ProcessGroup"):
        collective.check_group("rays")
    k1 = cfg32.replace(rhs_backend="xla", projection_backend="pallas")
    with pytest.raises(NotImplementedError, match="forward only"):
        grads(lambda s, g: mtt.rhs(120.0, s, st32, bg32, k1, g), s32, True)


def test_gather_state_and_the_flux_tail_twin(world_of_one, jax_inputs):
    """gather_state assembles a history along axis 1 from full_history_
    observe's specs; and K4's twin in its flux tail (one stage, a world of
    1) equals the twin of the wind tail: y', q', the wind, and the flux
    the wind took."""
    mesh = make_mesh()
    cfg, bg, state, statics = (_cfg(jax_inputs["k"][0]),
                               *map(_port, jax_inputs["k"][1:]))
    run = mtt.RunConfig(dt=120.0, n_steps=2, save_every=1)
    spec = mtt.full_history_observe_spec()
    fn = mtt.build_sharded_simulate_fn(mesh, cfg, run,
                                       observe=mtt.full_history_observe,
                                       observe_spec=spec)
    assert fn.out_specs[2] is spec and spec[1] == P(None, "rays")
    hist = gather_state(mesh, fn(state, statics, bg)[2], spec)
    assert tuple(hist[0].rays.r.shape) == tuple(hist[1].shape) == (2, N_K)
    from msgwam_tpu_torch.ops import rhs_cuda

    inp = rhs_cuda.inputs(120.0, state, statics, bg, cfg)
    stage = rhs_cuda_windowed.ray_physics.RK3_STAGES[0]
    collective.ALL_REDUCES = 0
    a = rhs_cuda_windowed.stage_reference(inp, inp.fields, None, *state.mean,
                                          None, stage)
    b = rhs_cuda_windowed.stage_reference(inp, inp.fields, None, *state.mean,
                                          None, stage,
                                          group=mesh.get_group("rays"))
    assert collective.ALL_REDUCES == 1
    for x, y in zip((*a[0], *a[1], a[2], *a[3][:2]), (*b[0], *b[1], b[2],
                                                      *b[3][:2])):
        assert torch.equal(x, y)
