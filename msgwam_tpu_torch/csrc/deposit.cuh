// Ray -> grid flux deposit, shared by the projection kernel (K1,
// projection.cu), the per-stage kernels (K2-K4, rhs_windowed.cu) and the
// whole-run kernel (K5-K7, step_resident.cu).
//
// Reference semantics (lib/libprop.py:121-160, kept by both Pallas kernels):
// a ray volume [r_low, r_up] covers cells nlow <= c < nup, with
// nlow = trunc(r_low / dz) and nup = trunc(r_up / dz + 1) from the origin-0
// ratio, both clamped to nzmax = n_cells - 1 after an out-of-domain test,
// so the top cell never receives flux.  Cell c weighs
// |min(g0 + (c+1) dz, r_up) - max(g0 + c dz, r_low)|.
//
// Layout on Hopper.  A block of kThreads threads walks ray tiles of
// kThreads rays (one ray per thread).  For K2-K7 each thread stages its
// ray's span, edges and two pre-scaled values in shared memory
// (deposit_stage); the block then adds the tile's contributions, cell by
// cell in a fixed order, to float64 sums in shared memory (DepositAccN,
// sized to the grid by the kernel), and each kernel sums its blocks' sums in
// its own tail (K2-K4 by fixed reducer blocks, K5-K7 by step_resident.cu's
// FluxSync).  The walks here follow the tile's width: several warps per cell
// up to kWarps cells (walk), a gather with up to 32 lanes per cell
// (deposit_walk), past kWideCells a walk per warp (walk_wide).  K1 takes the
// span rule, the tile and sum types and the counters from here and has
// walks of its own (projection.cu).  No float atomics: the result is
// bitwise reproducible for a given block count.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace msgwam {

constexpr int kThreads = 256;            // rays per tile = threads per block
constexpr int kMaxCells = 1024;          // cells of the deposit grid, at most
constexpr int kWarps = kThreads / 32;

// Truncated, clamped span of one ray; returns false when the ray is out of
// the domain.  ``lo_ratio`` = r_low/dz, ``up_ratio`` = r_up/dz + 1, each in
// the arithmetic of the calling kernel's Pallas original.
__device__ __forceinline__ bool cell_span(float lo_ratio, float up_ratio,
                                          int nzmax, int& nlow, int& nup) {
  nlow = static_cast<int>(lo_ratio);     // truncation toward zero
  nup = static_cast<int>(up_ratio);
  const bool ood = (nlow >= nzmax && nup >= nzmax) || (nlow <= 0 && nup <= 0);
  nlow = min(max(nlow, 0), nzmax);
  nup = min(max(nup, 0), nzmax);
  return !ood;
}

struct DepositTile {
  float lo[kThreads];
  float hi[kThreads];
  float v0[kThreads];
  float v1[kThreads];
  int nlow[kThreads];
  int nup[kThreads];
  int wmin[kWarps];
  int wmax[kWarps];
};

// Per-block float64 sums of the two value rows, in shared memory, for at
// most kCells cells.
template <int kCells>
struct DepositAccN {
  double v[2][kCells];

  __device__ void zero(int n_cells) {
    for (int c = threadIdx.x; c < n_cells; c += kThreads) v[0][c] = v[1][c] = 0.0;
  }
};

// Every thread of the block calls this once per tile (a dead or missing ray
// passes live = false), then __syncthreads(), then a walk.
__device__ __forceinline__ void deposit_stage(DepositTile& t, bool live,
                                              int nlow, int nup, float r_low,
                                              float r_up, float v0, float v1) {
  const int tid = threadIdx.x;
  if (!live) nlow = nup = 0;             // empty span
  t.lo[tid] = r_low;
  t.hi[tid] = r_up;
  t.v0[tid] = v0;
  t.v1[tid] = v1;
  t.nlow[tid] = nlow;
  t.nup[tid] = nup;
  const int wmin = __reduce_min_sync(0xffffffffu, live ? nlow : INT_MAX);
  const int wmax = __reduce_max_sync(0xffffffffu, live ? nup : INT_MIN);
  if ((tid & 31) == 0) {
    t.wmin[tid >> 5] = wmin;
    t.wmax[tid >> 5] = wmax;
  }
}

// Adds the staged tile's contributions to the block's sums.  The caller
// __syncthreads() after it, before the next tile is staged.  Every thread
// of the block takes part (the shuffles need whole warps).
template <class Acc>
__device__ __forceinline__ void deposit_walk(const DepositTile& t, Acc& acc,
                                             float g0, float dz) {
  int cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    cmin = min(cmin, t.wmin[w]);
    cmax = max(cmax, t.wmax[w]);
  }
  const int width = cmax - cmin;
  if (width <= 0) return;                // block-uniform: no live ray
  int lanes = 32;                        // lanes per cell, a power of two
  while (lanes > 1 && width * lanes > kThreads) lanes >>= 1;
  const int per_pass = kThreads / lanes;
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  for (int base = cmin; base < cmax; base += per_pass) {
    const int c = base + slot;
    double s0 = 0.0, s1 = 0.0;
    if (c < cmax) {
      const float cf = static_cast<float>(c);
      const float face_lo = g0 + cf * dz;
      const float face_hi = g0 + (cf + 1.0f) * dz;
#pragma unroll 4
      for (int i = lane; i < kThreads; i += lanes) {
        if (t.nlow[i] <= c && c < t.nup[i]) {
          const float ov =
              fabsf(fminf(face_hi, t.hi[i]) - fmaxf(face_lo, t.lo[i]));
          s0 += static_cast<double>(ov * t.v0[i]);
          s1 += static_cast<double>(ov * t.v1[i]);
        }
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (lane == 0 && c < cmax) {
      acc.v[0][c] += s0;
      acc.v[1][c] += s1;
    }
  }
}

// The walks of the whole-run kernel, shared by K2-K7.  ``Sh`` is the
// block's shared memory: a DepositTile ``tile``, float64 sums ``acc`` and
// per-warp sums ``wpart[kWarps][2]``.
constexpr int kWideCells = 32;      // walk_wide past this tile width

// The deposit walk of a wide tile (its touched cells [cmin, cmax) more than
// kWideCells): each warp sums its own 32 rays, lane l for cell wmin + l of
// the warp's cells (32 more per pass), adding the rays in order; then the
// warps add their cell sums to the block's sums one after the other, warp 0
// first.  A lane tests 32 rays per pass and waits at 8 barriers, whatever
// the tile's width; deposit_walk's gather has a lane test about width rays
// and no barrier, so it takes the tiles up to kWideCells cells.  Ends with a
// block barrier.
template <class Sh>
__device__ __forceinline__ void walk_wide(Sh& S, float g0, float dz) {
  const DepositTile& t = S.tile;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int passes = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (t.wmax[w] > t.wmin[w]) passes = max(passes, (t.wmax[w] - t.wmin[w] + 31) / 32);
  const bool live = t.wmax[wid] > t.wmin[wid];
  for (int p = 0; p < passes; ++p) {
    const int c = live ? t.wmin[wid] + 32 * p + lane : 0;
    const bool mine = live && c < t.wmax[wid];
    double s0 = 0.0, s1 = 0.0;
    if (mine) {
      const float cf = static_cast<float>(c);
      const float face_lo = g0 + cf * dz;
      const float face_hi = g0 + (cf + 1.0f) * dz;
      for (int k = 0; k < 32; ++k) {
        const int i = wid * 32 + k;
        if (t.nlow[i] <= c && c < t.nup[i]) {
          const float ov = fabsf(fminf(face_hi, t.hi[i]) - fmaxf(face_lo, t.lo[i]));
          s0 += static_cast<double>(ov * t.v0[i]);
          s1 += static_cast<double>(ov * t.v1[i]);
        }
      }
    }
    for (int w = 0; w < kWarps; ++w) {
      if (wid == w && mine) {
        S.acc.v[0][c] += s0;
        S.acc.v[1][c] += s1;
      }
      __syncthreads();
    }
  }
}

// The staged tile's touched cells [cmin, cmax) (block-uniform after the
// barrier that follows deposit_stage); empty when cmax <= cmin.
__device__ __forceinline__ void tile_cells(const DepositTile& t, int& cmin,
                                           int& cmax) {
  cmin = INT_MAX;
  cmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    cmin = min(cmin, t.wmin[w]);
    cmax = max(cmax, t.wmax[w]);
  }
}

// The deposit walk of a staged tile whose touched cells [cmin, cmax) number
// at most kWarps: kw = kWarps / P warps per cell (P the width rounded up to
// a power of two), each lane adding every (32 kw)-th ray in order, a fixed
// butterfly per warp, and the warp sums to wpart; after the caller's
// barrier, walk_finish adds each cell's kw warp sums in warp order to the
// block's sums.  Wider tiles take deposit_walk or walk_wide.  Returns P
// (0: nothing to finish).
template <class Sh>
__device__ __forceinline__ int walk(Sh& S, float g0, float dz, int& cmin) {
  const DepositTile& t = S.tile;
  int cmax;
  tile_cells(t, cmin, cmax);
  if (cmax <= cmin) return 0;            // block-uniform: no live ray
  const int width = cmax - cmin;
  if (width > kWideCells) {
    walk_wide(S, g0, dz);
    return 0;
  }
  if (width > kWarps) {
    deposit_walk(t, S.acc, g0, dz);
    return 0;
  }
  int P = 1;
  while (P < width) P <<= 1;
  const int kw = kWarps / P;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = cmin + wid / kw;
  double s0 = 0.0, s1 = 0.0;
  if (c < cmax) {
    const float cf = static_cast<float>(c);
    const float face_lo = g0 + cf * dz;
    const float face_hi = g0 + (cf + 1.0f) * dz;
    for (int i = (wid % kw) * 32 + lane; i < kThreads; i += kw * 32) {
      if (t.nlow[i] <= c && c < t.nup[i]) {
        const float ov = fabsf(fminf(face_hi, t.hi[i]) - fmaxf(face_lo, t.lo[i]));
        s0 += static_cast<double>(ov * t.v0[i]);
        s1 += static_cast<double>(ov * t.v1[i]);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (lane == 0) {
    S.wpart[wid][0] = s0;
    S.wpart[wid][1] = s1;
  }
  return P;
}

template <class Sh>
__device__ __forceinline__ void walk_finish(Sh& S, int P, int cmin, int n_flux) {
  if (threadIdx.x >= P) return;
  const int c = cmin + threadIdx.x;
  if (c >= n_flux) return;
  const int kw = kWarps / P;
  double s0 = 0.0, s1 = 0.0;
  for (int h = 0; h < kw; ++h) {
    s0 += S.wpart[threadIdx.x * kw + h][0];
    s1 += S.wpart[threadIdx.x * kw + h][1];
  }
  S.acc.v[0][c] += s0;
  S.acc.v[1][c] += s1;
}

// Counters between blocks (K2-K7's flux protocols).
// Thread 0 waits until *c >= target, polling every kPollNs at most (the
// pause keeps hundreds of polling blocks from crowding out the counters'
// updates in L2); then the block goes on.
constexpr int kPollNs = 64;
constexpr int kCountStride = 32;    // ints between counters: one 128-byte line each

// A device-scope acquire-release fence: with the block barrier before it,
// it orders every write of the block before thread 0's next counter update
// (release); after a counter read, every later read of the block after it
// (acquire).  Lighter than __threadfence()'s sequentially consistent fence.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void wait_count(const int* c, int target) {
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<const volatile int*>(c) < target) __nanosleep(kPollNs);
    fence_acq_rel();
  }
  __syncthreads();
}

// Adds v to the counter after every write of the block (release).
__device__ __forceinline__ void count_up(int* c, int v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel();
    atomicAdd(c, v);
  }
}

}  // namespace msgwam
