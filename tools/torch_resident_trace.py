#!/usr/bin/env python3
"""Where a stage of the whole-run kernel (K5) spends its cycles, on a GPU.

    python3 tools/torch_resident_trace.py

Copies ``msgwam_tpu_torch`` to ``_trace/`` (git-ignored), adds cycle
stamps (``clock64`` of thread 0 of each block) to the copy's
``csrc/step_resident.cu`` at the phase boundaries of every stage, and runs
one 10-step launch of K5 on the bench population (``chip_smoke.py``'s) at
1e5 rays on the launch state and after a day, and at 1e6 after a day, with
the prognostic wind and without.  The stamps go to the end of the copy's
frozen-terms scratch.  Per stage and tile block, the cycles of:

* ``wind_wait``: the wait for the previous stage's flux and the wind update;
* ``shear``: the shear tables and their two barriers;
* ``update_B``: the ray update of all the block's tiles;
* ``A_tiles``: the next stage's windows and deposit of all its tiles;
* ``A_publish``: storing the block's partial and counting it in;

and, for the blocks without tiles, the wait for the partials and the
reduce.  Prints medians over stages 1-29 and tile blocks, and the largest
per-block median; the stamps cost a few cycles each.  The stamp anchors
are lines of the kernel's source: an edit there fails loudly here.
"""

from __future__ import annotations

import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "_trace")
STAGE_SLOTS = 8      # stamps per stage
BLOCK_SLOTS = 512    # stamps per block

PATCHES = [
    ('''  // --- the launch start: state on chip, invariants once ------------------
''', '''  long long* trace = reinterpret_cast<long long*>(
      a.inv + 8 * static_cast<size_t>(a.n)) + blockIdx.x * 512;
#define STAMP(k) if (threadIdx.x == 0) trace[(k)] = clock64();
  STAMP(0)
  int j0stamp = 0;
  // --- the launch start: state on chip, invariants once ------------------
'''),
    ('''      if (P) walk_finish(S, P, cmin, n_flux);
    }
    if (prog) {''', '''      if (P) walk_finish(S, P, cmin, n_flux);
    }
    if (j0stamp) { STAMP(j0stamp) }
    if (prog) {'''),
    ('''  deposit_pass(0);
  for (int s = 0; s < n_stages; ++s) {
    const int step = s / 3, st = s % 3;
    if (s > 0 && prog) wind_update(s - 1);''', '''  STAMP(1)
  deposit_pass(0);
  for (int s = 0; s < n_stages; ++s) {
    const int step = s / 3, st = s % 3;
    const int sb = 2 + s * 8;
    STAMP(sb)
    if (s > 0 && prog) wind_update(s - 1);
    STAMP(sb + 1)'''),
    ('''    update_pass(step, st);
    if (prog) fs.reduce(reinterpret_cast<double*>(&S.tile), kStage, s);
    if (s + 1 < n_stages) deposit_pass(s + 1);
  }''', '''    STAMP(sb + 2)
    update_pass(step, st);
    STAMP(sb + 3)
    if (prog) fs.reduce(reinterpret_cast<double*>(&S.tile), kStage, s);
    STAMP(sb + 4)
    j0stamp = sb + 6;
    if (s + 1 < n_stages) deposit_pass(s + 1);
    j0stamp = 0;
    STAMP(sb + 5)
  }'''),
    ('''    for (int s = 0; s < n_stages; ++s)
      fs.reduce(reinterpret_cast<double*>(dyn), kStageMax, s);''', '''    long long* rtr = reinterpret_cast<long long*>(
        a.inv + 8 * static_cast<size_t>(a.n)) + blockIdx.x * 512;
    for (int s = 0; s < n_stages; ++s)
      fs.reduce(reinterpret_cast<double*>(dyn), kStageMax, s, rtr + 3 * s);'''),
    ('''  __device__ void reduce(double* stage, int n_stage, int s) const {''',
     '''  __device__ void reduce(double* stage, int n_stage, int s,
                         long long* rtr = nullptr) const {'''),
    ('''    wait_count(count(s), (s / 2 + 1) * nt);''', '''    if (rtr && threadIdx.x == 0) rtr[0] = clock64();
    wait_count(count(s), (s / 2 + 1) * nt);
    if (rtr && threadIdx.x == 0) rtr[1] = clock64();'''),
    ('''    count_up(count(s) + kCountStride, n_mine);''', '''    count_up(count(s) + kCountStride, n_mine);
    if (rtr && threadIdx.x == 0) rtr[2] = clock64();'''),
]
SCRATCH = ('''            torch.empty((8, n) if plan.tiles_per_block > 1 else (8,),
                        dtype=torch.float32, device=device),''',
           '''            torch.zeros(8 * n + 1024 * n_members * plan.blocks_per_member,
                        dtype=torch.float32, device=device),''')


def instrumented_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "msgwam_tpu_torch"),
                    os.path.join(COPY, "msgwam_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, patches in (("csrc/step_resident.cu", PATCHES),
                         ("ops/step_cuda.py", [SCRATCH])):
        path = os.path.join(COPY, "msgwam_tpu_torch", rel)
        with open(path) as f:
            text = f.read()
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"torch_resident_trace: anchor not found once in "
                                 f"{rel}: {old.splitlines()[0]!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)


def main() -> int:
    instrumented_copy()
    sys.path.insert(0, COPY)
    import numpy as np
    import torch

    import msgwam_tpu_torch as mtt
    from msgwam_tpu_torch.ops import step_cuda

    if not torch.cuda.is_available():
        raise SystemExit("torch_resident_trace: no CUDA device")
    dev = torch.device("cuda")
    seen = {}
    scratch = step_cuda.scratch

    def keep(*args, **kw):
        out = scratch(*args, **kw)
        seen["inv"], seen["plan"] = out[3], args[0]
        return out

    step_cuda.scratch = keep
    names = ("wind_wait", "shear", "update_B", "reduce", "A_tiles", "A_publish")
    for n, spread in ((100_000, False), (100_000, True), (1_000_000, True)):
        cfg = mtt.REFERENCE_RUN_CONFIG.replace(
            saturate_online=True, dtype="float32", rhs_backend="pallas",
            window_cells=-1)
        gc = mtt.GridConfig()
        uu = mtt.velocities_sine_homogeneous(
            torch.tensor(gc.centers(), dtype=torch.float32), cfg)
        bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                                 dtype=torch.float32, device=dev)
        rays, statics = mtt.gaussian_spectrum_source(
            cfg, bg, n, dtype=torch.float32, device=dev, z_launch=2000.0,
            dz_launch=500.0, amplitude_alpha=0.003)
        state = mtt.State(rays, mtt.MeanState(uu.to(dev), torch.zeros_like(uu).to(dev)))
        ops = step_cuda.operands(state, statics, bg, cfg, 120.0)
        init = [rays.dens.clone(), rays.r.clone(), rays.m.clone(),
                torch.stack([state.mean.u, state.mean.v])]
        act = statics.active.to(torch.uint8)
        if spread:
            for _ in range(10):
                step_cuda.launch(ops, *init, act, 72)
        for prog in (True, False):
            o = ops._replace(prognostic=prog)
            for _ in range(2):
                step_cuda.launch(o, *[x.clone() for x in init], act, 10)
                torch.cuda.synchronize()
            plan = seen["plan"]
            nt, na = plan.tile_blocks, plan.blocks_per_member
            stamps = (seen["inv"][8 * n:].view(torch.int64)[: na * BLOCK_SLOTS]
                      .view(na, BLOCK_SLOTS).cpu().numpy().astype(np.float64))
            st = stamps[:nt, 2:2 + 30 * STAGE_SLOTS].reshape(nt, 30, STAGE_SLOTS)
            st = st[:, :, [0, 1, 2, 3, 4, 6, 5]]      # A's publish after its tiles
            d = np.diff(st, axis=2)[:, 1:, :]
            med = {k: float(np.median(d[:, :, i])) for i, k in enumerate(names)}
            worst = {k: float(np.median(d[:, :, i], axis=1).max())
                     for i, k in enumerate(names)}
            total = float(np.median(st[:, 2:, 0] - st[:, 1:-1, 0]))
            print(f"n={n} {'after a day' if spread else 'launch state'} "
                  f"prognostic={prog}: cycles per stage {total:.0f}; median "
                  f"{med}; largest block median {worst}")
            if prog and na > nt:
                r = stamps[nt:, :90].reshape(na - nt, 30, 3)[:, 1:]
                print(f"  blocks without tiles: wait {np.median(r[:, :, 1] - r[:, :, 0]):.0f}"
                      f", reduce {np.median(r[:, :, 2] - r[:, :, 1]):.0f} cycles")
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
