"""Start many two-rank gloo worlds of the port on the CPU, beside busy
processes, and report every world in which a rank did not exit with 0.

A rank that leaves the interpreter with its process groups alive can die
at exit (``terminate called without an active exception``, exit -6) after
its work is done, at a rate of a few percent a world on a loaded machine.
This loop measures that rate.

Modes:

- ``mesh``: each rank calls ``initialize_distributed`` (a ``file://``
  store) and ``make_mesh(2)`` and ``make_mesh(2, axis="ensemble")``, runs
  ``REDUCES`` flux all-reduces (``ops/collective.py``) on each mesh's
  group, saves them and exits: with the port's teardown
  (``--teardown port``, ``parallel.distributed.shutdown``) or without any
  (``--teardown none``, how the port's workers ended before it).
- ``world2``: the ``WORKER`` of ``tests/test_torch_sharding.py`` with the
  eight cases of its ``world2`` fixture, on inputs built by that module's
  own ``jax_inputs`` and ``run_dir`` fixtures (needs jax, as the tests do).

For every failing world it prints each rank's exit code, the last line of
its stderr, and whether the rank saved its results.  Exit code 1 when any
world failed.

    python tools/torch_gloo_exit_stress.py mesh --worlds 300 --load 6
    python tools/torch_gloo_exit_stress.py mesh --worlds 300 --load 6 --teardown none
    python tools/torch_gloo_exit_stress.py world2 --worlds 30 --load 6
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 120
REDUCES = 40    # mesh mode: all-reduces on each mesh's group
# a busy CPU process that ends with the loop that started it
BUSY = "import os\nparent = os.getppid()\nwhile os.getppid() == parent: pass"

MESH_WORKER = r"""
import sys
rank, init, out = int(sys.argv[1]), sys.argv[3], sys.argv[4]
teardown, reduces = sys.argv[5], %(reduces)d
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
from msgwam_tpu_torch.ops import collective
from msgwam_tpu_torch.parallel import initialize_distributed, make_mesh

initialize_distributed(init_method=init, world_size=2, rank=rank, device="cpu")
meshes = ((make_mesh(2), "rays"), (make_mesh(2, axis="ensemble"), "ensemble"))
sums = []
for i in range(reduces):
    for mesh, name in meshes:
        flux = torch.full((2, 101), float(rank + i), dtype=torch.float64)
        sums.append(float(collective.all_reduce_flux(flux, mesh.get_group(name))[0, 0]))
if sums != [float(2 * i + 1) for i in range(reduces) for _ in meshes]:
    raise AssertionError(f"rank {rank}: wrong sums {sums}")
np.savez(out + "/rank%%d.npz" %% rank, sums=np.asarray(sums))
if teardown == "port":
    from msgwam_tpu_torch.parallel.distributed import shutdown
    shutdown()
""" % {"repo": str(REPO), "reduces": REDUCES}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class _TmpFactory:
    """The one method of pytest's ``tmp_path_factory`` that ``run_dir``
    calls."""

    def __init__(self, root: Path):
        self.root = root

    def mktemp(self, name: str) -> Path:
        return Path(tempfile.mkdtemp(prefix=name, dir=self.root))


def world2_setup(root: Path):
    """The ``world2`` fixture's worker script, its arguments after
    ``out``, and the directory that holds its ``inputs.pt``."""
    _load(REPO / "tests" / "conftest.py", "_stress_conftest")
    sharding = _load(REPO / "tests" / "test_torch_sharding.py",
                     "_stress_test_torch_sharding")
    inputs = sharding.jax_inputs.__wrapped__()
    run_dir = sharding.run_dir.__wrapped__(_TmpFactory(root), inputs)
    cases = ["single", "mesh10", "cull", "step_fn", "ens_scan", "k", "mega",
             "refusals"]
    return sharding.WORKER, [",".join(cases)], run_dir


def one_world(base: Path, index: int, script: Path, extra: list) -> dict:
    """Two ranks of one world in ``base/w<index>``: each rank's exit code,
    stderr and whether it saved ``rank<r>.npz``."""
    out = base / f"w{index}"
    out.mkdir()
    init = f"file://{out / 'store'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONFAULTHANDLER": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", init, str(out), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    errs = []
    try:
        for p in procs:
            try:
                errs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[1])
            except subprocess.TimeoutExpired:
                errs.append(f"timed out after {WORKER_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {"rcs": [p.returncode for p in procs], "errs": errs,
            "saved": [(out / f"rank{r}.npz").exists() for r in range(2)]}


def abort_line(text: str) -> str:
    """The C++ runtime's ``terminate called ...`` line of a rank's stderr,
    else its last line (the faulthandler's dump follows the former)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return next((ln for ln in lines if ln.startswith("terminate called")),
                lines[-1] if lines else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("mesh", "world2"))
    ap.add_argument("--worlds", type=int, default=300)
    ap.add_argument("--load", type=int, default=6,
                    help="busy CPU processes beside the worlds")
    ap.add_argument("--teardown", choices=("port", "none"), default="port",
                    help="mesh mode: end each rank with the port's teardown "
                         "or exit with the groups alive")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="gloo_exit_") as tmp:
        base = Path(tmp)
        script = base / "worker.py"
        if args.mode == "mesh":
            script.write_text(MESH_WORKER)
            extra = [args.teardown]
        else:
            text, extra, base = world2_setup(base)
            script.write_text(text)
        busy = [subprocess.Popen([sys.executable, "-c", BUSY])
                for _ in range(args.load)]
        failed = 0
        t0 = time.monotonic()
        try:
            for i in range(args.worlds):
                res = one_world(base, i, script, extra)
                if any(res["rcs"]):
                    failed += 1
                    print(f"world {i}: " + "; ".join(
                        f"rank {r} exit {rc}, saved {saved}, stderr: "
                        f"{abort_line(err)!r}" for r, (rc, saved, err) in
                        enumerate(zip(res["rcs"], res["saved"], res["errs"]))),
                        flush=True)
                    if failed == 1:
                        for r, err in enumerate(res["errs"]):
                            print(f"  rank {r} stderr tail:\n{err[-1500:]}",
                                  flush=True)
        finally:
            for p in busy:
                p.kill()
                p.wait()
    seconds = time.monotonic() - t0
    label = args.mode + (f", teardown {args.teardown}"
                         if args.mode == "mesh" else "")
    print(f"{label}: {failed} of {args.worlds} worlds failed, load "
          f"{args.load}, {seconds:.1f} s ({seconds / max(args.worlds, 1):.2f} "
          f"s a world)", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
