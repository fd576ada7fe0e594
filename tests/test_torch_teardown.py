"""The end of a multi-process world (``parallel.distributed.shutdown`` and
``world``), on the CPU: two-rank gloo worlds, one after another, each rank
a process with a ``file://`` store that makes a mesh through
``global_mesh`` (1-D, or the 2-D ``('ensemble', 'rays')`` mesh whose
subgroups the dry run uses), sums one flux over the ray group
(``ops/collective.py``), ends its world and exits.  Every rank exits with
its own code (0, or the code of an error it raised inside ``world``), none
prints the C++ runtime's ``terminate called``, and no gloo thread outlives
the teardown: a thread left running can abort the process at exit once the
interpreter is finalizing.  Each world within 60 s."""

import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 60
RAISED = 3      # a rank's exit code after the planned error

WORKER = r"""
import json, os, sys
rank, init, mode = int(sys.argv[1]), sys.argv[2], sys.argv[4]
axes = tuple(int(a) for a in sys.argv[3].split(","))
sys.path.insert(0, %(repo)r)
import torch
torch.set_num_threads(1)
from msgwam_tpu_torch.ops import collective
from msgwam_tpu_torch.parallel import global_mesh, initialize_distributed
from msgwam_tpu_torch.parallel.distributed import (mesh_position, shutdown,
                                                   world)


def gloo_threads():
    tasks = "/proc/self/task"
    names = ([open(f"{tasks}/{t}/comm").read().strip()
              for t in os.listdir(tasks)] if os.path.isdir(tasks) else [])
    return sorted(n for n in names if "gloo" in n)


kept = []      # a caller that keeps its mesh past the world's end


def work():
    mesh = global_mesh(axes, ("ensemble", "rays")[-len(axes):])
    kept.append(mesh)
    group = mesh.get_group("rays")     # held by this frame when it raises
    flux = torch.full((2, 99), float(rank + 1), dtype=torch.float64)
    total = float(collective.all_reduce_flux(flux, group)[0, 0])
    if mode == "raise":
        raise RuntimeError(f"planned error, sum {total}")
    return total, mesh_position(mesh, "rays")[1]


kw = dict(init_method=init, world_size=2, rank=rank, device="cpu")
if mode == "shutdown":
    initialize_distributed(**kw)
    total, ranks = work()
    shutdown()
else:
    try:
        with world(**kw):
            total, ranks = work()
    except RuntimeError as e:
        print(json.dumps({"error": str(e), "gloo_threads": gloo_threads()}))
        sys.exit(%(raised)d)
print(json.dumps({"sum": total, "ranks": ranks,
                  "gloo_threads": gloo_threads()}))
""" % {"repo": REPO, "raised": RAISED}


def _world(tmp_path, axes, mode):
    """Both ranks' exit codes and their last stdout lines as JSON, after
    the checks that hold for every world."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), init, ",".join(map(str, axes)),
         mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}) for r in range(2)]
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        outs = [p.communicate(timeout=max(0.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    report = "\n".join(f"rank {r}: exit {p.returncode}\n{o}\n{e[-3000:]}"
                       for r, (p, (o, e)) in enumerate(zip(procs, outs)))
    assert not any("terminate called" in e for _, e in outs), report
    got = [json.loads(o.splitlines()[-1]) if o.strip() else None
           for o, _ in outs]
    assert all(g is not None and g["gloo_threads"] == [] for g in got), report
    return [p.returncode for p in procs], got, report


@pytest.mark.parametrize("axes", [(2,), (1, 2), (2, 1)])
def test_a_world_ends_cleanly(tmp_path, axes):
    rcs, got, report = _world(tmp_path, axes, "shutdown")
    assert rcs == [0, 0], report
    for r, g in enumerate(got):
        assert g["ranks"] == (1 if axes == (2, 1) else 2)
        assert g["sum"] == (3.0 if g["ranks"] == 2 else r + 1.0)


def test_a_world_block_ends_cleanly(tmp_path):
    rcs, got, report = _world(tmp_path, (1, 2), "world")
    assert rcs == [0, 0], report
    assert [g["sum"] for g in got] == [3.0, 3.0]


@pytest.mark.parametrize("axes", [(2,), (1, 2)])
def test_a_world_that_raises_ends_without_its_threads(tmp_path, axes):
    """The error path of ``world``: no barrier, the groups destroyed even
    though a frame of the error's traceback held one, and the rank exits
    with the code its own handler chose rather than an abort's."""
    rcs, got, report = _world(tmp_path, axes, "raise")
    assert rcs == [RAISED, RAISED], report
    assert all(g["error"] == "planned error, sum 3.0" for g in got), report
