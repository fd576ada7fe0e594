"""Entry points of the port for a one-card run check and a multi-rank dry
run: the counterpart of ``__graft_entry__.py``.

* :func:`entry` — one full coupled model step (RK3 + online saturation)
  on the flagship configuration, with example arguments.
* :func:`dryrun_multichip` — starts ``n_devices`` ranks (gloo, one process
  each), shards the FULL step over a ``('ensemble', 'rays')`` mesh (the
  ray dimension with one all-reduce of the flux per RHS evaluation, the
  mean flow replicated; for n >= 4 and even, two ensemble members), runs
  one step on tiny shapes, then one whole-run kernel launch per rank over
  an ensemble split one member a rank.

The ranks run on the CPU, or share the card (``device="cuda"``): gloo
runs several ranks on one card, where NCCL refuses them.  Each rank is a
fresh Python process that imports this module and not the caller's
script, so any script (and ``python -``) may call the dry run.

Run:  python -m msgwam_tpu_torch.dryrun [--n-devices N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.state import default_device, tree_map

DT = 120.0
N_ENTRY = 8192           # rays of entry()'s step
PER_SHARD = 16           # rays a rank holds in the dry run's step
N_MEGA = 200             # rays of each member of the second leg
WORKER_TIMEOUT_S = 300.0
PACKAGE_ROOT = Path(__file__).resolve().parent.parent   # holds msgwam_tpu_torch


def setup(n_ray: int, dtype=torch.float32, ensemble=None, device=None):
    """``(cfg, bg, state, statics)``: the Gaussian spectrum's defaults over
    the sine jet, online saturation, the dense ``mxu`` backends; with
    ``ensemble``, every leaf repeated along a leading member axis."""
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True,
        dtype="float32" if dtype == torch.float32 else "float64",
        projection_backend="mxu",
        interp_backend="mxu",
    )
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=dtype), cfg)
    vv = torch.zeros_like(uu)
    bg = mtt.make_background(gc, cfg, uu, vv, dtype=dtype,
                             device=default_device(device))
    rays, statics = mtt.gaussian_spectrum_source(cfg, bg, n_ray, dtype=dtype)
    state = mtt.State(rays, mtt.MeanState(uu.to(bg.centers.device),
                                          vv.to(bg.centers.device)))
    if ensemble is not None:
        repeat = lambda x: x.expand((ensemble,) + x.shape).clone()
        state, statics = tree_map(repeat, state), tree_map(repeat, statics)
    return cfg, bg, state, statics


def entry(device=None):
    """Returns ``(fn, example_args)``: one full coupled model step of
    8192 rays in float32 on ``device`` (default: the card)."""
    cfg, bg, state, statics = setup(N_ENTRY, torch.float32, device=device)

    def fn(state, statics):
        new_state, new_statics, _ = mtt.step(DT, state, statics, bg, cfg)
        return new_state, new_statics

    return fn, (state, statics)


def mesh_shape(n_devices: int) -> tuple:
    """``(ensemble, rays)``: two ensemble rows for n >= 4 and even, else
    one row of n ray ranks."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return 2, n_devices // 2
    return 1, n_devices


def mega_members(cfg, bg, n_members: int):
    """The second leg's ensemble: ``n_members`` spectra of 200 rays at
    amplitudes 0.003 (1 + 0.1 e) in a still atmosphere."""
    from msgwam_tpu_torch.parallel import stack_ensemble

    members = []
    for e in range(n_members):
        rays, statics = mtt.gaussian_spectrum_source(
            cfg, bg, N_MEGA, amplitude_alpha=0.003 * (1 + 0.1 * e),
            dtype=torch.float32)
        still = torch.zeros_like(bg.centers)
        members.append((mtt.State(rays, mtt.MeanState(still, still)), statics))
    return stack_ensemble(members)


def _cpu(tree):
    return tree_map(lambda x: x.detach().cpu(), tree)


def _rank(rank: int, world: int, init: str, device: str, out_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: its block of the sharded step
    and its member of the second leg, saved to ``out_dir/rank<rank>.pt``."""
    from msgwam_tpu_torch.ops import step_cuda_stream
    from msgwam_tpu_torch.parallel import ensemble_simulate, global_mesh
    from msgwam_tpu_torch.parallel.distributed import world as world_of

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    with world_of(init_method=init, world_size=world, rank=rank,
                  backend="gloo", device=dev):
        e_size, r_size = mesh_shape(world)
        mesh = global_mesh((e_size, r_size), ("ensemble", "rays"))
        i_e, i_r = mesh.get_local_rank("ensemble"), mesh.get_local_rank("rays")
        cfg, bg, state, statics = setup(PER_SHARD * r_size, ensemble=e_size,
                                        device=dev)
        rows = slice(i_r * PER_SHARD, (i_r + 1) * PER_SHARD)
        member = lambda tree, f: tree_map(f, tree)
        my_state = mtt.State(member(state.rays, lambda x: x[i_e, rows]),
                             member(state.mean, lambda x: x[i_e]))
        my_statics = member(statics, lambda x: x[i_e, rows])
        new_state, new_statics, _ = mtt.step(
            DT, my_state, my_statics, bg, cfg,
            axis_name=mesh.get_group("rays"))
        if not bool(torch.isfinite(new_state.mean.u).all()):
            raise FloatingPointError(
                f"rank {rank}: non-finite wind after a step")

        # second leg: one member a rank, a whole-run kernel launch each
        emesh = global_mesh((world,), ("ensemble",))
        bstates, bstatics = mega_members(cfg, bg, world)
        run = mtt.RunConfig(dt=DT, n_steps=2, save_every=2)
        before = dict(step_cuda_stream.LAUNCHES)
        fin, _, mh = ensemble_simulate(bstates, bstatics, bg, cfg, run,
                                       mesh=emesh, backend="mega")
        launches = {k: v - before[k]
                    for k, v in step_cuda_stream.LAUNCHES.items()}
        torch.save({"member": i_e, "rows": (rows.start, rows.stop),
                    "state": _cpu(new_state), "statics": _cpu(new_statics),
                    "mega_final": _cpu(fin), "mega_mean": _cpu(mh),
                    "launches": launches},
                   os.path.join(out_dir, f"rank{rank}.pt"))


def _run_ranks(world: int, device: str, timeout_s: float) -> list:
    """Start ``world`` ranks, each a fresh Python process that imports this
    module (never the caller's script), with a ``file://`` rendezvous in a
    temporary directory; each has ``timeout_s`` from the start to finish,
    else every rank still running is killed and the call raises."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PACKAGE_ROOT)] + [p for p in (env.get("PYTHONPATH"),) if p])
    with tempfile.TemporaryDirectory(prefix="msgwam_dryrun_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "from msgwam_tpu_torch.dryrun import _rank; "
             f"_rank({r}, {world}, {init!r}, {device!r}, {tmp!r})"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        deadline = time.monotonic() + timeout_s
        outs, hung = [], []
        try:
            for r, p in enumerate(procs):
                try:
                    outs.append(p.communicate(
                        timeout=max(0.0, deadline - time.monotonic()))[0])
                except subprocess.TimeoutExpired:
                    hung.append(r)
                    outs.append("")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if hung:
            raise TimeoutError(f"dry run: ranks {hung} of {world} still "
                               f"running after {timeout_s} s")
        failed = {r: p.returncode for r, p in enumerate(procs) if p.returncode}
        if failed:
            r = min(failed)
            raise RuntimeError(f"dry run: ranks exited with codes {failed}; "
                               f"rank {r}:\n{outs[r][-3000:]}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Shard the full step over an ``n_devices``-rank mesh and run one
    step, then one whole-run kernel launch per rank; print the two OK
    lines.  The ranks run on ``device``'s kind (default: the card; pass
    ``device="cpu"`` for the CPU).  Each rank has ``WORKER_TIMEOUT_S`` to
    finish.

    Mesh layout: for n >= 4 and even, a 2-D ``('ensemble', 'rays')`` mesh
    (the two scale axes of this workload: rays share one all-reduce of the
    flux, ensemble members are independent), else a 1-D ray mesh.  Each
    rank holds 16 rays of its member.

    Returns the step's state and statics assembled from the ranks' blocks
    (leading member axis), the second leg's final states and mean history
    (member-leading, as every rank gathers them) and each rank's launches
    of the whole-run kernel (``K6`` with one member a rank)."""
    device = default_device(device).type
    e_size, r_size = mesh_shape(n_devices)
    outs = _run_ranks(n_devices, device, WORKER_TIMEOUT_S)

    def blocks(e):
        """Member ``e``'s outputs from its ray ranks, in ray order."""
        return sorted((o for o in outs if o["member"] == e),
                      key=lambda o: o["rows"][0])

    stack = lambda trees: tree_map(lambda *xs: torch.stack(xs), *trees)
    cat = lambda trees: tree_map(lambda *xs: torch.cat(xs), *trees)
    # the rays are split over a member's ray ranks, the wind replicated
    state = mtt.State(
        stack([cat([o["state"].rays for o in blocks(e)]) for e in range(e_size)]),
        stack([blocks(e)[0]["state"].mean for e in range(e_size)]))
    statics = stack([cat([o["statics"] for o in blocks(e)])
                     for e in range(e_size)])
    if not bool(torch.isfinite(state.mean.u).all()):
        raise FloatingPointError("dry run: non-finite wind after the step")
    print(f"dryrun_multichip OK: mesh {{'ensemble': {e_size}, 'rays': "
          f"{r_size}}}, capacity/shard {PER_SHARD}, backend gloo on {device}")

    fin, mh = outs[0]["mega_final"], outs[0]["mega_mean"]
    if not bool(torch.isfinite(mh.u).all()):
        raise FloatingPointError("dry run: non-finite mean history (mega)")
    if fin.rays.dens.shape[0] != n_devices:
        raise ValueError(f"dry run: {fin.rays.dens.shape[0]} members back, "
                         f"expected {n_devices}")
    launches = [o["launches"] for o in outs]
    print(f"dryrun_multichip mega-ensemble OK: {n_devices} members split "
          f"over 'ensemble', whole-run kernel launches per rank {launches}")
    return {"mesh": (e_size, r_size), "state": state, "statics": statics,
            "mega_final": fin, "mega_mean": mh, "launches": launches}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m msgwam_tpu_torch.dryrun")
    ap.add_argument("--n-devices", type=int,
                    help="ranks of the dry run (default: the number of cards "
                         "on the card, 1 with --device cpu)")
    ap.add_argument("--device", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    fn, example = entry(device)
    t0 = time.perf_counter()
    new_state, _ = fn(*example)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if not bool(torch.isfinite(new_state.mean.u).all()):
        raise FloatingPointError("entry(): non-finite wind after the step")
    print(f"entry() run OK on {device} ({time.perf_counter() - t0:.3f} s)")
    n = args.n_devices
    if n is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        dryrun_multichip(n, device.type)


if __name__ == "__main__":
    main()
