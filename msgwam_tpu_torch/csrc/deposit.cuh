// Ray -> grid flux deposit, shared by the projection kernel (K1,
// projection.cu) and the fused RHS kernel (K2, rhs_fused.cu).
//
// Reference semantics (lib/libprop.py:121-160, kept by both Pallas kernels):
// a ray volume [r_low, r_up] covers cells nlow <= c < nup, with
// nlow = trunc(r_low / dz) and nup = trunc(r_up / dz + 1) from the origin-0
// ratio, both clamped to nzmax = n_cells - 1 after an out-of-domain test,
// so the top cell never receives flux.  Cell c weighs
// |min(g0 + (c+1) dz, r_up) - max(g0 + c dz, r_low)|.
//
// Layout on Hopper.  A block of kThreads threads walks ray tiles of
// kThreads rays (one ray per thread).  Each thread stages its ray's span,
// edges and two pre-scaled values in shared memory.  The tile's touched cell
// range [cmin, cmax) then gets S lanes per cell (S a power of two up to 32,
// as many as fit in the block): each lane walks every S-th ray of the tile,
// and the S lanes combine their float64 sums with a fixed butterfly of warp
// shuffles.  A ray covers 1-3 cells at the bench population, so a whole warp
// shares each cell's walk.  The block adds each cell's tile sum to a
// float64 accumulator in shared memory and ends with one per-block partial;
// a second kernel adds the partials in block order.  No float atomics: the
// result is bitwise reproducible for a given ray count.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace msgwam {

constexpr int kThreads = 256;            // rays per tile = threads per block
constexpr int kMaxCells = 1024;          // cells of the deposit grid, at most
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 8;      // fixed, so the sum order is too

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

// Per-block float64 sums of the two value rows, in shared memory.
struct DepositAcc {
  double v[2][kMaxCells];

  __device__ void zero(int n_cells) {
    for (int c = threadIdx.x; c < n_cells; c += kThreads) v[0][c] = v[1][c] = 0.0;
  }
};

// Every thread of the block calls this once per tile (a dead or missing ray
// passes live = false), then __syncthreads(), then deposit_walk.
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
__device__ __forceinline__ void deposit_walk(const DepositTile& t,
                                             DepositAcc& acc, float g0,
                                             float dz) {
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

// Writes the block's sums to partials[(block, var, cell)]; call after the
// last tile's __syncthreads().
__device__ __forceinline__ void deposit_store(const DepositAcc& acc,
                                              double* partials, int n_cells) {
  double* p = partials + static_cast<size_t>(blockIdx.x) * 2 * n_cells;
  for (int c = threadIdx.x; c < n_cells; c += kThreads) {
    p[c] = acc.v[0][c];
    p[n_cells + c] = acc.v[1][c];
  }
}

// Second pass: one block per (var, cell); each thread adds a strided set of
// block partials, then a fixed shared-memory tree.  out is (2, n_cells) f32.
// static: each translation unit that includes this header gets its own copy.
static __global__ void __launch_bounds__(kThreads)
deposit_reduce_kernel(const double* __restrict__ partials, int n_blocks,
                      int n_cells, float* __restrict__ out) {
  __shared__ double s[kThreads];
  const int vc = blockIdx.x;             // var * n_cells + cell
  double sum = 0.0;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads)
    sum += partials[static_cast<size_t>(b) * 2 * n_cells + vc];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[vc] = static_cast<float>(s[0]);
}

static inline cudaError_t launch_deposit_reduce(const double* partials, int n_blocks,
                                         int n_cells, float* out,
                                         cudaStream_t stream) {
  if (n_cells > 0)
    deposit_reduce_kernel<<<2 * n_cells, kThreads, 0, stream>>>(
        partials, n_blocks, n_cells, out);
  return cudaGetLastError();
}

}  // namespace msgwam
