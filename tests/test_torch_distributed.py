"""``msgwam_tpu_torch.parallel.distributed`` on the CPU: two gloo processes
(a ``file://`` store), ``initialize`` called twice, the host arrays placed
with ``make_global_sharded`` on a ``global_mesh`` and a sharded run of 5
steps, against the JAX package in one process at 1e-12 (the port of
tests/test_distributed.py, 16 rays: seconds, so not marked slow); and
``initialize``'s choices of world, backend and device."""

import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu as mt
from msgwam_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from msgwam_tpu_torch.parallel.distributed import (
    global_mesh, initialize, make_global_sharded, shutdown)
device = initialize(init_method=init, world_size=2, rank=rank, device="cpu")
assert initialize() == device  # idempotent: a no-op once initialized
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.parallel.sharding import (
    build_sharded_simulate_fn, gather_state, ray_sharding_specs)

mesh = global_mesh((2,), ("rays",))
cfg = mtt.REFERENCE_RUN_CONFIG
gc = mtt.GridConfig()
uu = mtt.velocities_sine_homogeneous(
    torch.tensor(gc.centers(), dtype=torch.float64), cfg)
bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu), device="cpu")
rays, statics = mtt.wave_packet_ic(gc, cfg, bg, n_ray=16, device="cpu")
state = mtt.State(rays, mtt.MeanState(uu, torch.zeros_like(uu)))

state_spec, statics_spec = ray_sharding_specs()
g_state = make_global_sharded(mesh, state_spec, mtt.to_numpy(state))
g_statics = make_global_sharded(mesh, statics_spec, mtt.to_numpy(statics))
assert g_state.rays.dens.shape == (8,) and g_state.mean.u.shape == (100,)
assert torch.equal(g_state.rays.r, rays.r[8 * rank:8 * (rank + 1)])

run = mtt.RunConfig(dt=120.0, n_steps=5, save_every=5)
fn = build_sharded_simulate_fn(mesh, cfg, run)
final, _, hist = fn(g_state, g_statics, bg)
whole = gather_state(mesh, final)
np.savez(out + "/rank%%d.npz" %% rank, u=final.mean.u.numpy(),
         dens=whole.rays.dens.numpy(), hist_u=hist.u.numpy())
shutdown()
""" % {"repo": REPO}


def test_two_process_sharded_run_matches_single_process(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), init, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "ranks failed:\n" + (
        "\n".join(f"rank {r}: exit {p.returncode}\n{o[-2000:]}\n{e[-3000:]}"
                  for r, (p, (o, e)) in enumerate(zip(procs, outs))))

    cfg = mt.REFERENCE_RUN_CONFIG
    gc = mt.GridConfig()
    uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(gc.centers()),
                                                   cfg))
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, cfg, uu, vv)
    rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=16)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    run = mt.RunConfig(dt=120.0, n_steps=5, save_every=5)
    final, _, hist = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run))(
        state, statics)
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_allclose(got["u"], np.asarray(final.mean.u),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got["hist_u"], np.asarray(hist[0].mean.u),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got["dens"], np.asarray(final.rays.dens),
                                   rtol=1e-12)


def test_initialize_a_world_of_one_on_the_cpu():
    """With no environment and no init_method: a world of 1 in this
    process, gloo on the CPU, the device returned; a second call is a
    no-op."""
    assert not torch.distributed.is_initialized()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    with mock.patch.dict(os.environ, env, clear=True):
        device = distributed.initialize(device="cpu")
    try:
        assert device == torch.device("cpu")
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_backend() == "gloo"
        assert distributed.initialize(device="cuda") == device
        assert distributed.local_device() == device
        mesh = distributed.global_mesh((1,), ("rays",))
        host = np.arange(6.0)
        got = distributed.make_global_sharded(
            mesh, (distributed.P("rays"), distributed.P()), (host, host))
        assert all(torch.equal(g, torch.arange(6.0, dtype=torch.float64))
                   for g in got)
    finally:
        distributed.shutdown()


def test_initialize_names_the_missing_card_and_refuses_nccl_on_the_cpu():
    assert not torch.distributed.is_initialized()
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize()
    with pytest.raises(ValueError, match="NCCL backend runs on the card"):
        distributed.initialize(backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()


def test_nccl_takes_one_rank_per_card():
    """Two ranks of an NCCL world on one card raise, naming gloo; one rank
    a card passes."""
    distributed.check_one_rank_per_card(["h/cuda:0", "h/cuda:1", "g/cuda:0"])
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        distributed.check_one_rank_per_card(["h/cuda:0", "h/cuda:1",
                                             "h/cuda:0"])
