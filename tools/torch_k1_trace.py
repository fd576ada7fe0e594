#!/usr/bin/env python3
"""Where a call of the deposit kernel (K1) spends its cycles, on a GPU.

    python3 tools/torch_k1_trace.py [--out FILE]

Copies ``msgwam_tpu_torch`` to ``_trace/`` (git-ignored), adds cycle
stamps (``clock64`` of thread 0 of each block, and ``%globaltimer`` at the
block's start and end) to the copy's ``csrc/projection.cu``, and runs one
call on ``chip_smoke.py``'s K1 populations.  The stamps go past the end of
the call's partials.  Per block, the cycles of:

* ``ray``: from a tile's start to the barrier after its rays' spans (the
  wait for the tile's loads, issued one tile ahead, the rays' cells and
  values, the warps' spans and the barrier), summed over the block's tiles;
* ``deposit``: the deposits (warp 0's own in a per-warp tile, the binned
  walk), summed;
* ``to_arrival``: from the block's start to its arrival (the above, the
  zeroing and the publication of its partials);
* ``wait`` and ``reduce``: the reducers' wait for the other blocks and
  their sums.

Prints, per population, the medians and maxima over blocks, the tiles of
each walk, and the span from the first block's start to the last block's
end on the global timer.  The stamp anchors are lines of the kernel's
source: an edit there fails loudly here.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "_trace")
SLOTS = 16           # stamps per block

PATCHES = [
    ('''  if (blockIdx.x == 0 && tid == 0) a.sync[(1 - a.parity) * kCountStride] = 0;
''', '''  if (blockIdx.x == 0 && tid == 0) a.sync[(1 - a.parity) * kCountStride] = 0;
  long long* trace = reinterpret_cast<long long*>(
      a.partials + 2 * static_cast<size_t>(a.n_cells) * gridDim.x) + blockIdx.x * 16;
  long long tk = clock64(), tl = 0, tw = 0, gt0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt0));
  int n_warp = 0, n_binned = 0;
'''),
    ('''    const ProjRay r = ray_of(next, nzmax, dz);
''', '''    const long long c0 = clock64();
    const ProjRay r = ray_of(next, nzmax, dz);
'''),
    ('''    __syncthreads();                     // the zeroing, and the warps' spans
''', '''    __syncthreads();                     // the zeroing, and the warps' spans
    const long long c1 = clock64();
    tl += c1 - c0;
'''),
    ('''      if constexpr (kWarpSums) warp_deposit(S.wacc[wid], r, g0, dz);
    } else {
      walk_binned(S, r.live, r.nlow, r.nup, r.lo, r.hi, r.a0, r.a1, cmin,
                  cmax - cmin, maxspan, g0, dz);
    }
''', '''      if constexpr (kWarpSums) warp_deposit(S.wacc[wid], r, g0, dz);
      ++n_warp;
    } else {
      walk_binned(S, r.live, r.nlow, r.nup, r.lo, r.hi, r.a0, r.a1, cmin,
                  cmax - cmin, maxspan, g0, dz);
      ++n_binned;
    }
    tw += clock64() - c1;
'''),
    ('''  const int red = blockIdx.x;
  if (red >= a.n_red) return;
''', '''  const int red = blockIdx.x;
  const long long c3 = clock64();
  if (tid == 0) {
    trace[0] = gt0;
    trace[2] = tl;
    trace[3] = tw;
    trace[4] = c3 - tk;
    trace[8] = n_warp;
    trace[9] = n_binned;
  }
  if (red >= a.n_red) {
    long long gt1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt1));
    if (tid == 0) {
      trace[1] = gt1;
      trace[5] = trace[6] = 0;
    }
    return;
  }
'''),
    ('''  wait_count(arrivals, nb);
''', '''  wait_count(arrivals, nb);
  const long long c4 = clock64();
'''),
    ('''        a.out[e] = static_cast<float>(S.wpart[wid][0] + S.wpart[wid + 1][0]);
      __syncthreads();
    }
  }
}''', '''        a.out[e] = static_cast<float>(S.wpart[wid][0] + S.wpart[wid + 1][0]);
      __syncthreads();
    }
  }
  long long gt1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt1));
  if (tid == 0) {
    trace[1] = gt1;
    trace[5] = c4 - c3;
    trace[6] = clock64() - c4;
  }
}'''),
]


def patch() -> None:
    if os.path.isdir(COPY):
        shutil.rmtree(COPY)
    shutil.copytree(os.path.join(ROOT, "msgwam_tpu_torch"),
                    os.path.join(COPY, "msgwam_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(COPY, "msgwam_tpu_torch", "csrc", "projection.cu")
    with open(path) as f:
        src = f.read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"torch_k1_trace: anchor not found once:\n{old}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def worker() -> dict:
    import importlib.util

    import numpy as np
    import torch

    import msgwam_tpu_torch as mtt
    from msgwam_tpu_torch.ops import projection_cuda
    from msgwam_tpu_torch.ops.rhs_cuda import Scratch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")

    def bench(n, day=False):
        cfg, bg, state, statics = smoke.bench_setup(n, dev, window_cells=-1)
        if day:
            state, _, _ = mtt.simulate(state, statics, bg, cfg, mtt.RunConfig(
                dt=120.0, n_steps=720, save_every=720))
        return smoke.k1_inputs(state, statics, bg, cfg)

    pops = {
        "random_100000": lambda: smoke.deposit_population(100_000, dev),
        "random_1000000": lambda: smoke.deposit_population(1_000_000, dev),
        "bench_launch_1000000": lambda: bench(1_000_000),
        "path_a_day_1000000": lambda: bench(1_000_000, day=True),
        "wide_spans_1000000": lambda: smoke.deposit_population(
            1_000_000, dev, extent=(5e3, 40e3)),
        "cells1024_100000": lambda: smoke.deposit_population(
            100_000, dev, n_cells=1024),
    }
    names = ("ray", "deposit", "to_arrival", "wait", "reduce")
    res = {}
    for label, make in pops.items():
        args = make()
        n, n_cells = args[1].shape[0], args[5].shape[0] - 1
        work = projection_cuda.scratch(n, n_cells, dev)
        nb = work.plan.blocks
        part = torch.zeros(2 * n_cells * nb + SLOTS * nb, dtype=torch.float64,
                           device=dev)
        work = Scratch(work.plan, work.flux, part, work.ranges)
        for _ in range(3):
            projection_cuda.launch(*args, work=work)
        torch.cuda.synchronize()
        st = part[2 * n_cells * nb:].view(torch.int64).view(nb, SLOTS).cpu().numpy()
        red = st[:work.plan.reducers]
        out = {"plan": tuple(work.plan),
               "span_us": float(st[:, 1].max() - st[:, 0].min()) / 1e3,
               "start_spread_us": float(st[:, 0].max() - st[:, 0].min()) / 1e3,
               "tiles_per_warp_binned": [int(st[:, k].sum()) for k in (8, 9)]}
        for k, name in enumerate(names):
            col = (red if name in ("wait", "reduce") else st)[:, 2 + k]
            out[name] = {"median": float(np.median(col)), "max": int(col.max())}
        res[label] = out
        print(json.dumps({label: out}), flush=True)
        del args, work, part
        torch.cuda.empty_cache()
    return res


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        sys.path.insert(0, COPY)
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_k1_trace: no CUDA device")
        res = worker()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        res["smi"] = smi
        print(json.dumps(res), flush=True)
        return 0
    patch()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                         capture_output=True, text=True, cwd=ROOT)
    sys.stdout.write(out.stdout)
    sys.stderr.write(out.stderr[-8000:])
    if out.returncode:
        return out.returncode
    if "--out" in argv:
        with open(argv[argv.index("--out") + 1], "w") as f:
            f.write(out.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
