// K1: ray -> grid flux deposit on Hopper, one launch.
//
// Replaces msgwam_tpu/ops/projection_pallas.py:_kernel (entry points
// _project_pallas / project_pallas), the projection_backend="pallas"
// deposit.  Same arithmetic as the Pallas kernel: cell indices from the
// *division* r/dz, truncated and clamped after the out-of-domain test; faces
// rebuilt as g0 + c dz; weight |overlap| / dz * phase_vol, contracted with
// at most two value rows; no flux in the top cell.
//
// What bounds it on the H100: per ray it reads 5 f32 fields and one mask
// byte (21 B); the output is (2, n_cells).  At 1e6 rays that is 21 MB, about
// 6.3 us at 3.35 TB/s.  The operations (an overlap, two products and two
// float64 sums per covered cell) are far below the f32 rate, but a walk that
// tests every ray of a tile against every cell the tile touches is not (at
// 79 cells a tile, 20,000 tests for 400 contributions), and a block that
// waits for each tile's loads leaves the memory idle.  The design:
//   - one launch over a persistent grid of at most kProjBlocksPerSm blocks a
//     SM (block b takes tiles b, b + nb, ...; 64 registers a thread, where
//     6 or 8 blocks a SM spilled and were slower), every block resident
//     (msgwam_project_plan checks the occupancy), fixed for a ray count and
//     a card, so the order of every sum is too (mirrored by
//     ops/ray_physics.py:project_plan);
//   - shared memory sized to the grid: kPad = 128, 256 or 1152 cells;
//   - each thread's next ray is loaded while its current one is deposited,
//     so a block's loads overlap its tiles' sums;
//   - per 256-ray tile, one barrier and then a deposit chosen by the span of
//     its rays: up to kWarpSpan cells each warp adds its own 32 rays to
//     float64 sums of its own (warp_deposit: the lanes of a cell in a fixed
//     order, no further barrier; up to 256 cells, where those sums fit in
//     48 KB), else the binned walk below into the block's sum, whose work is
//     the rays times their largest span and not the rays times the tile's
//     width;
//   - the tail of the per-stage kernels (rhs_windowed.cu): each block
//     publishes its float64 sums for the cells its tiles touched, with their
//     range, and counts itself in on the arrival counter of the launch's
//     parity; blocks 0 .. n_red - 1 then sum each (var, cell) entry over the
//     blocks in block order, with groups of reduce_group(nb) threads, and
//     write the (2, n_cells) float32 flux.
// No float atomics: a launch is bitwise repeatable.
#include <algorithm>

#include "deposit.cuh"

namespace msgwam {

constexpr int kProjBlocksPerSm = 4;      // 64 registers a thread
constexpr int kProjReducers = 256;       // reducer blocks, at most
constexpr int kWarpSpan = 4;             // per-warp sums up to this span

// Threads that sum one flux entry in a reducer: the blocks rounded up to a
// power of two, at most 64 (ray_physics.reduce_group).
__device__ __forceinline__ int reduce_group(int nb) {
  int g = 1;
  while (g < nb && g < 64) g <<= 1;
  return g;
}

struct ProjArgs {
  const float *v0, *v1, *r_low, *r_up, *phase_vol;   // v1 may be null
  const unsigned char* valid;                         // may be null
  const float* grid;
  int n, n_cells, n_red, parity;
  float* out;                        // (2, n_cells)
  double* partials;                  // (2 n_cells, nb), entry-major
  int* ranges;                       // (nb,): lo << 16 | hi of the block's cells
  int* sync;                         // (2, 32) ints: the arrival counters of
                                     // even and odd launches
};

// The block's shared memory: the warps' float64 sums (up to 256 cells), the
// block's float64 sum (the binned walks') and the binned walk's scratch.
template <int kPad, bool kWarpSums = (kPad <= 256)>
struct ProjShared {
  double wacc[kWarpSums ? kWarps : 1][2][kWarpSums ? kPad : 1];
  DepositAccN<kPad> acc;
  DepositTile tile;                  // the live rays in bin order
  int start[kPad + 1];               // the bins' first positions in bin order
  unsigned char cnt[kWarps][kPad];   // per warp and bin: its rays there, then
                                     // the rays there of the earlier warps
  int wsum[kWarps];                  // per warp: its threads' bins' rays
  int wspan[2][kWarps];              // per tile parity and warp: the largest
  int wmin[2][kWarps], wmax[2][kWarps];   // span and the cells touched
  int bmin[kWarps], bmax[kWarps];    // per warp: the cells of all its tiles
  double wpart[kWarps][2];
};

// One ray a thread, as the Pallas kernel reads it: the loads (issued
// together, whether or not the ray is live), then live, its clamped span
// [nlow, nup) and edges, and its two values scaled by phase_vol / dz.
struct RawRay {
  float lo = 0.0f, hi = 0.0f, pv = 0.0f, x0 = 0.0f, x1 = 0.0f;
  bool ok = false;
};

struct ProjRay {
  bool live = false;
  int nlow = 0, nup = 0;
  float lo = 0.0f, hi = 0.0f, a0 = 0.0f, a1 = 0.0f;
};

__device__ __forceinline__ RawRay load_raw(const ProjArgs& a, int i) {
  RawRay r;
  if (i >= a.n) return r;
  r.lo = a.r_low[i];
  r.hi = a.r_up[i];
  r.pv = a.phase_vol[i];
  r.x0 = a.v0[i];
  r.x1 = a.v1 == nullptr ? 0.0f : a.v1[i];
  r.ok = a.valid == nullptr || a.valid[i] != 0;
  return r;
}

__device__ __forceinline__ ProjRay ray_of(const RawRay& x, int nzmax, float dz) {
  ProjRay r;
  r.lo = x.lo;
  r.hi = x.hi;
  r.live = x.ok && cell_span(x.lo / dz, x.hi / dz + 1.0f, nzmax, r.nlow, r.nup) &&
           r.nup > r.nlow;
  const float s = x.pv / dz;
  r.a0 = r.live ? x.x0 * s : 0.0f;
  r.a1 = r.live ? x.x1 * s : 0.0f;
  return r;
}

// Adds the contributions of a warp's 32 rays (one a lane) to the warp's own
// float64 sums acc[var][cell].  Round j takes each live ray's cell nlow + j
// (j below its span); the lanes of one cell (__match_any_sync) are summed
// in a fixed order, by a butterfly over the warp where few cells hold many
// lanes each (narrow tiles), else lane by lane in lane order, and the
// cell's lowest lane adds the sum to the warp's.  No barrier.
template <int kPad>
__device__ __forceinline__ void warp_deposit(double (&acc)[2][kPad],
                                             const ProjRay& r, float g0,
                                             float dz) {
  const int lane = threadIdx.x & 31;
  const int span = r.live ? r.nup - r.nlow : 0;
  const int rounds = __reduce_max_sync(0xffffffffu, span);
  for (int j = 0; j < rounds; ++j) {
    const bool on = j < span;
    const int c = on ? r.nlow + j : -1;
    double x0 = 0.0, x1 = 0.0;
    if (on) {
      const float cf = static_cast<float>(c);
      const float face_lo = g0 + cf * dz;
      const float face_hi = g0 + (cf + 1.0f) * dz;
      const float ov = fabsf(fminf(face_hi, r.hi) - fmaxf(face_lo, r.lo));
      x0 = static_cast<double>(ov * r.a0);
      x1 = static_cast<double>(ov * r.a1);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    const bool lead = on && (peers & ((1u << lane) - 1u)) == 0;
    const unsigned leads = __ballot_sync(0xffffffffu, lead);
    const int most = __reduce_max_sync(0xffffffffu, on ? __popc(peers) : 0);
    if (4 * __popc(leads) <= most) {       // a butterfly per cell
      for (unsigned todo = leads; todo; todo &= todo - 1) {
        const int l = __ffs(todo) - 1;
        const bool mine = c == __shfl_sync(0xffffffffu, c, l);
        double s0 = mine ? x0 : 0.0, s1 = mine ? x1 : 0.0;
        for (int o = 16; o > 0; o >>= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (lane == l) {
          acc[0][c] += s0;
          acc[1][c] += s1;
        }
      }
    } else {                               // each cell's lanes in lane order
      double s0 = x0, s1 = x1;             // (a lane a cell: its own)
      if (most > 1) {
        unsigned rest = on ? peers : 0u;
        s0 = s1 = 0.0;
        for (int k = 0; k < most; ++k) {
          const bool got = rest != 0u;
          const int src = got ? __ffs(rest) - 1 : lane;
          rest &= rest - 1u;
          const double y0 = __shfl_sync(0xffffffffu, x0, src);
          const double y1 = __shfl_sync(0xffffffffu, x1, src);
          if (got) {
            s0 += y0;
            s1 += y1;
          }
        }
      }
      if (lead) {
        acc[0][c] += s0;
        acc[1][c] += s1;
      }
    }
  }
}

// The binned walk of a tile whose live rays touch cells [cmin, cmin + width)
// and span at most maxspan cells each.
// The tile's live rays are placed in S.tile in the order of their first cell
// (bin nlow - cmin), stable in the ray index, by integer counts alone, so in
// no order of arrival: a warp's rays of one bin by __match_any_sync and the
// lower lanes among them, the rays of the earlier warps per bin, an
// exclusive scan over the bins.  Then cell c gathers only the bins
// c - maxspan + 1 .. c, a contiguous run of the placed tile that holds every
// ray covering it, with as many lanes per cell as fit, in order, combined by a
// fixed butterfly, and adds the sum to the block's.  Every thread of the block
// calls it with its own ray (live false for a dead or missing one); the bin
// counts are zero on entry and again on return; four block barriers, and the
// caller's before the next tile.
template <class Sh>
__device__ __forceinline__ void walk_binned(Sh& S, bool live, int nlow, int nup,
                                            float lo, float hi, float a0,
                                            float a1, int cmin, int width,
                                            int maxspan, float g0, float dz) {
  const int tid = threadIdx.x, wid = tid >> 5, lane = tid & 31;
  const int key = live ? nlow - cmin : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (live && rank == 0) S.cnt[wid][key] = static_cast<unsigned char>(__popc(peers));
  __syncthreads();

  // thread t owns bins t kb .. t kb + kb - 1: per bin, the rays of the
  // earlier warps (in place of the counts) and the bin's total, then an
  // exclusive scan of the totals over the bins
  const int kb = (width + kThreads - 1) / kThreads;
  int total = 0;
  for (int j = 0; j < kb; ++j) {
    const int b = tid * kb + j;
    if (b < width) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = S.cnt[w][b];
        S.cnt[w][b] = static_cast<unsigned char>(run);   // at most 7 x 32
        run += c;
      }
      S.start[b] = run;
      total += run;
    }
  }
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) S.wsum[wid] = incl;
  __syncthreads();
  int pos = incl - total;
  for (int w = 0; w < wid; ++w) pos += S.wsum[w];
  for (int j = 0; j < kb; ++j) {
    const int b = tid * kb + j;
    if (b < width) {
      const int in_bin = S.start[b];
      S.start[b] = pos;
      pos += in_bin;
    }
  }
  if (tid == kThreads - 1) S.start[width] = pos;   // the live rays
  __syncthreads();

  if (live) {
    const int p = S.start[key] + S.cnt[wid][key] + rank;
    S.tile.lo[p] = lo;
    S.tile.hi[p] = hi;
    S.tile.v0[p] = a0;
    S.tile.v1[p] = a1;
    S.tile.nup[p] = nup;
  }
  __syncthreads();
  for (int b = tid; b < width; b += kThreads) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) S.cnt[w][b] = 0;
  }

  int lanes = 32;                        // lanes per cell, a power of two
  while (lanes > 1 && width * lanes > kThreads) lanes >>= 1;
  const int per_pass = kThreads / lanes;
  const int slot = tid / lanes, ln = tid & (lanes - 1);
  for (int base = 0; base < width; base += per_pass) {
    const int rc = base + slot;          // the cell, from cmin
    double s0 = 0.0, s1 = 0.0;
    if (rc < width) {
      const int c = cmin + rc;
      const float cf = static_cast<float>(c);
      const float face_lo = g0 + cf * dz;
      const float face_hi = g0 + (cf + 1.0f) * dz;
      const int end = S.start[rc + 1];
      for (int p = S.start[max(rc - maxspan + 1, 0)] + ln; p < end; p += lanes) {
        if (S.tile.nup[p] > c) {
          const float ov =
              fabsf(fminf(face_hi, S.tile.hi[p]) - fmaxf(face_lo, S.tile.lo[p]));
          s0 += static_cast<double>(ov * S.tile.v0[p]);
          s1 += static_cast<double>(ov * S.tile.v1[p]);
        }
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (ln == 0 && rc < width) {
      S.acc.v[0][cmin + rc] += s0;
      S.acc.v[1][cmin + rc] += s1;
    }
  }
}

template <int kPad>
__global__ void __launch_bounds__(kThreads, kProjBlocksPerSm)
project_kernel(const ProjArgs a) {
  constexpr bool kWarpSums = kPad <= 256;
  __shared__ ProjShared<kPad> S;
  const int tid = threadIdx.x, wid = tid >> 5, lane = tid & 31;
  const int nb = gridDim.x;
  const int n_cells = a.n_cells;
  const int nzmax = n_cells - 1;
  // the other parity's counter, last used by the previous launch, for the
  // next one
  if (blockIdx.x == 0 && tid == 0) a.sync[(1 - a.parity) * kCountStride] = 0;
  RawRay next = load_raw(a, blockIdx.x * kThreads + tid);
  const float g0 = a.grid[0];
  const float dz = a.grid[1] - g0;
  const int n_tiles = (a.n + kThreads - 1) / kThreads;
  S.acc.zero(n_cells);
  for (int x = tid; x < kWarps * kPad / 4; x += kThreads)
    reinterpret_cast<int*>(&S.cnt[0][0])[x] = 0;
  if constexpr (kWarpSums)
    for (int c = lane; c < n_cells; c += 32) S.wacc[wid][0][c] = S.wacc[wid][1][c] = 0.0;

  int wlo = INT_MAX, whi = INT_MIN;   // the cells the warp's rays touched
  for (int t = blockIdx.x, j = 0; t < n_tiles; t += nb, ++j) {
    const ProjRay r = ray_of(next, nzmax, dz);
    next = load_raw(a, (t + nb) * kThreads + tid);
    const int lo_w = __reduce_min_sync(0xffffffffu, r.live ? r.nlow : INT_MAX);
    const int hi_w = __reduce_max_sync(0xffffffffu, r.live ? r.nup : INT_MIN);
    const int span_w = __reduce_max_sync(0xffffffffu, r.live ? r.nup - r.nlow : 0);
    wlo = min(wlo, lo_w);
    whi = max(whi, hi_w);
    const int par = j & 1;
    if (lane == 0) {
      S.wspan[par][wid] = span_w;
      S.wmin[par][wid] = lo_w;
      S.wmax[par][wid] = hi_w;
    }
    __syncthreads();                     // the zeroing, and the warps' spans
    int cmin = INT_MAX, cmax = INT_MIN, maxspan = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      cmin = min(cmin, S.wmin[par][w]);
      cmax = max(cmax, S.wmax[par][w]);
      maxspan = max(maxspan, S.wspan[par][w]);
    }
    if (cmax <= cmin) continue;          // block-uniform: no live ray
    if (kWarpSums && maxspan <= kWarpSpan) {
      if constexpr (kWarpSums) warp_deposit(S.wacc[wid], r, g0, dz);
    } else {
      walk_binned(S, r.live, r.nlow, r.nup, r.lo, r.hi, r.a0, r.a1, cmin,
                  cmax - cmin, maxspan, g0, dz);
    }
  }
  if (lane == 0) {
    S.bmin[wid] = wlo;
    S.bmax[wid] = whi;
  }
  __syncthreads();
  int bmin = INT_MAX, bmax = INT_MIN;    // the cells the block's tiles touched
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    bmin = min(bmin, S.bmin[w]);
    bmax = max(bmax, S.bmax[w]);
  }

  // --- the tail: publish; blocks 0 .. n_red - 1 sum the flux ---------------
  const int lo = bmax > bmin ? bmin : 0, hi = bmax > bmin ? bmax : 0;
  for (int c = lo + tid; c < hi; c += kThreads) {
    double s0 = 0.0, s1 = 0.0;           // the warps' sums in warp order, then
    if constexpr (kWarpSums) {           // the binned walks'
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s0 += S.wacc[w][0][c];
        s1 += S.wacc[w][1][c];
      }
    }
    s0 += S.acc.v[0][c];
    s1 += S.acc.v[1][c];
    a.partials[static_cast<size_t>(c) * nb + blockIdx.x] = s0;
    a.partials[static_cast<size_t>(n_cells + c) * nb + blockIdx.x] = s1;
  }
  if (tid == 0) a.ranges[blockIdx.x] = lo << 16 | hi;
  // the arrival, without a ticket: the reducers are the blocks 0 .. n_red - 1
  int* arrivals = a.sync + a.parity * kCountStride;
  __syncthreads();
  if (tid == 0) {
    fence_acq_rel();
    atomicAdd(arrivals, 1);
  }
  const int red = blockIdx.x;
  if (red >= a.n_red) return;

  // The reducers' groups of G threads take the 2 n_cells entries (var, cell)
  // in turn: thread t of a group adds blocks t, t + G, ... in order (a block
  // whose range misses the cell adds an exact zero in place of its partial),
  // a butterfly over the group's lanes (over each warp when G is 64, and the
  // two warp sums in order) (ray_physics.sum_blocks).
  const int G = reduce_group(nb);
  const int per_block = kThreads / G, grp = tid / G, gt = tid % G;
  const int groups = a.n_red * per_block, entries = 2 * n_cells;
  wait_count(arrivals, nb);
  for (int base = red * per_block; base < entries; base += groups) {
    const int e = base + grp;
    const int c = e % n_cells;
    double sum = 0.0;
    if (e < entries) {
      const double* p = a.partials + static_cast<size_t>(e) * nb;
#pragma unroll 8
      for (int b = gt; b < nb; b += G) {
        const int rb = __ldcg(a.ranges + b);
        const double pv = __ldcg(p + b);
        sum += (rb >> 16) <= c && c < (rb & 0xffff) ? pv : 0.0;
      }
    }
    for (int o = min(G, 32) >> 1; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (G < 64) {
      if (gt == 0 && e < entries) a.out[e] = static_cast<float>(sum);
    } else {
      if (lane == 0) S.wpart[wid][0] = sum;
      __syncthreads();
      if (gt == 0 && e < entries)
        a.out[e] = static_cast<float>(S.wpart[wid][0] + S.wpart[wid + 1][0]);
      __syncthreads();
    }
  }
}

template <int kPad>
const void* project_entry() {
  return reinterpret_cast<const void*>(project_kernel<kPad>);
}

// The instantiation for n_cells.
const void* project_for(int n_cells) {
  if (n_cells <= 128) return project_entry<128>();
  if (n_cells <= 256) return project_entry<256>();
  return project_entry<kMaxCells + 128>();
}

cudaError_t device_sms(int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace msgwam

// The block plan of K1 for n rays on n_cells cells on the current device:
// out = (blocks, reducers, SMs).  Blocks: one per 256-ray tile up to
// kProjBlocksPerSm a SM, which then loop over
// tiles; reducers: one per cell, at most 256 and at most the blocks.  Fails
// unless the card holds that many blocks of the instantiation a SM, so that
// the whole grid is resident.  A function of n, n_cells and the card only,
// so the order of the flux sums is too.
extern "C" int msgwam_project_plan(int n, int n_cells, int* out) {
  using namespace msgwam;
  if (n < 1 || n_cells < 1 || n_cells > kMaxCells || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, fits = 0;
  cudaError_t err = device_sms(sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fits, project_for(n_cells), kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fits < kProjBlocksPerSm) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (n + kThreads - 1) / kThreads;
  const int nb = std::min(tiles, kProjBlocksPerSm * sms);
  out[0] = nb;
  out[1] = std::min(std::min(nb, n_cells), kProjReducers);
  out[2] = sms;
  return 0;
}

// K1: the (2, n_cells) deposit of n rays onto the cells of the uniform grid
// (grid[0], grid[1] give g0 and dz) into out; v1 (null: a zero row) and valid
// (null: every ray) are optional.  Scratch, sized from msgwam_project_plan's
// plan: partials (2 n_cells, n_blocks) doubles, ranges (n_blocks) ints; sync
// (64) ints, zeroed once, the buffer of the per-stage kernels on the stream,
// with parity the count of earlier launches on it modulo 2.
extern "C" int msgwam_project(const float* v0, const float* v1,
                              const float* r_low, const float* r_up,
                              const float* phase_vol,
                              const unsigned char* valid, const float* grid,
                              int n, int n_cells, float* out, double* partials,
                              int* ranges, int* sync, int parity, int n_blocks,
                              int n_red, void* stream) {
  using namespace msgwam;
  const int tiles = n < 1 ? 0 : (n - 1) / kThreads + 1;
  int sms = 0;
  cudaError_t err = device_sms(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a grid larger than the card holds at once would wait forever
  if (n < 1 || n_cells < 1 || n_cells > kMaxCells || n_blocks < 1 ||
      n_blocks > tiles || n_blocks > kProjBlocksPerSm * sms || n_red < 1 ||
      n_red > n_blocks || n_red > kProjReducers ||
      (parity != 0 && parity != 1) || v0 == nullptr || r_low == nullptr ||
      r_up == nullptr || phase_vol == nullptr || grid == nullptr ||
      out == nullptr || partials == nullptr || ranges == nullptr ||
      sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ProjArgs a{v0,    v1,      r_low,  r_up,   phase_vol, valid, grid,
                   n,     n_cells, n_red,  parity, out,       partials,
                   ranges, sync};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cells <= 128)
    project_kernel<128><<<n_blocks, kThreads, 0, s>>>(a);
  else if (n_cells <= 256)
    project_kernel<256><<<n_blocks, kThreads, 0, s>>>(a);
  else
    project_kernel<kMaxCells + 128><<<n_blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
