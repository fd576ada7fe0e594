// K2, K3 and K4: the per-stage kernels of the hprop=False model on Hopper,
// one template.  Each is one launch: the per-ray stage, the flux deposit,
// the sum of the blocks' partials and (K4) the wind's stage update.
//
// Replaces msgwam_tpu/ops/rhs_pallas.py:_kernel (K2, _rhs_fused_call: the
// rhs_backend="pallas", window_cells=0 RHS) and
// msgwam_tpu/ops/rhs_pallas_windowed.py:_kernel, reached through
// _rhs_adaptive_call (K3, staged=False: the RHS with window_cells != 0) and
// _rhs_staged_call (K4, staged=True: the step rk3_step takes on that
// backend, three launches a step).  kMode picks the instantiation: kFull
// (K2: the window compiled out), kWindow (K3), kStaged (K4).
//
// Per 256-ray tile: the per-ray physics of ray_physics.cuh; K3/K4 the
// tile's window from its active rays' touched cells, with the second tier
// W2 and the exact full-width path (rhs_pallas_windowed.py:124-147); the
// shear and rho lookups, through the window; the deposit walk of
// deposit.cuh chosen by the tile's width.  The window is a cost choice and
// never changes a result: K3's outputs equal K2's.  K4: the tendency of each
// field goes straight into the RK3 stage, q' = dt f - c q and y' = y + b q'
// (the first stage adds q'/3 by division); y' is written to out_* and q'
// over q_*; out_* may be the arrays the ray is read from (stages 2 and 3
// update y in place): each ray is read whole, and its deposit staged,
// before its thread writes it.
//
// The launch, and what each part does about the H100:
//   - a persistent grid of kStageBlocksPerSm blocks per SM at most (block b
//     takes tiles b, b + nb, ...), fixed for a given ray count and card, so
//     the order of every sum is too (msgwam_rhs_plan, mirrored by
//     ops/ray_physics.py:stage_plan); every block is resident at once
//     (msgwam_rhs_plan checks the occupancy);
//   - shared memory sized to the grid: tables and float64 sums of kPad = 128
//     or 256 entries (1152 past 255 cells), about 10-14 KB a block;
//   - prologue: the first tile's loads go out, then the shear tables du/dz,
//     dv/dz are built from the wind u, v as (u[c+1] - u[c]) / dz, and rho,
//     in shared memory; the geometry comes from the background's centers
//     and faces on the device;
//   - tail: each block publishes its float64 sums, for the cells its tiles
//     touched only, with their range, and counts itself in on a counter on
//     its own 128-byte line (fence.acq_rel.gpu before it; no value comes
//     back).  Blocks 0 .. n_red - 1 (one per wind cell where there are
//     blocks enough) then wait for the rest and sum the flux by cell (see
//     the reducers below):
//     K2/K3 write it, and so does K4 in its flux tail (kTailFlux: under ray
//     sharding each rank's flux is summed over the ranks before the wind
//     can move, so the wind's stage update is the caller's, after the
//     all-reduce); K4 in its wind tail (kTailWind, a prognostic wind on one
//     rank) sums the four entries each of its cells needs and does that
//     cell's wind stage update of
//     step_pallas.py:384-402 at once, in the order of operations of the
//     torch glue it replaces (rhs_pallas_windowed.py:492-508): the flux
//     padded by copy, its divergence over dzf, Coriolis, the pressure
//     gradient over rho, and the q/y stage update of u, v, qu, qv.  The
//     counters alternate between even and odd launches on a stream (the
//     caller passes the parity): each launch zeroes the other one, which
//     the previous launch used and the next will.  No float atomics; a
//     launch is bitwise repeatable.
// In its empty tail (kTailNone: no prognostic wind) K4 deposits nothing (the
// flux would be unused).
// A two-slot ring of tiles copied in with cp.async while the previous tile
// computed was tried and measured slower at 1e5 and 1e6 rays (PERF.md):
// four blocks a SM already keep enough loads in flight.
//
// What bounds it: K2/K3 read 45 B and write 12 B per ray, K4 reads and
// writes the three RK3 registers besides (81 B after the first stage); the
// operations (chip_smoke.py's RHS_OPS, RK3_OPS, DEPOSIT_CELL_OPS per covered
// cell) are far below the f32 rate, so memory.  At 1e6 rays the kernels
// reach about half of that bound (PERF.md): the rest is the latency of each
// tile's chain (the IEEE divisions, sinf, two block barriers and the walk)
// and, at 1e5 rays, of the tail.
#include <algorithm>

#include "ray_physics.cuh"

namespace msgwam {

constexpr int kFull = 0, kWindow = 1, kStaged = 2;
// K4's tails: nothing, the flux and the wind update, the flux alone
constexpr int kTailNone = 0, kTailWind = 1, kTailFlux = 2;
constexpr int kStageBlocksPerSm = 4;
constexpr int kMaxReducers = 256;

struct StageArgs {
  const float *centers, *faces, *u, *v, *rhobar, *pg;
  float dt, bvf, kappa, f0, ff0, cc, bc;
  int n_tab, c_pad, w1, w2, n, n_red, parity, tail;
  bool online, faithful, first;
  RayFields f;                       // the 11 ray fields and the mask
  float *out_dens, *out_r, *out_m;   // tendencies (K2/K3) or y' (K4)
  float *q_dens, *q_r, *q_m;         // K4: the RK3 registers, in place
  float *u_out, *v_out, *qu, *qv;    // K4 in its wind tail
  float* flux;                       // (2, n_tab - 1)
  double* partials;                  // (2 (n_tab - 1), nb), entry-major
  int* ranges;                       // (nb,): lo << 16 | hi of the block's cells
  int* sync;                         // (2, 32) ints: the arrival counters of
                                     // even and odd launches
  signed char* tiers;                // K3: one byte per tile, or null
  unsigned long long* tier_counts;   // K3/K4: (kTierSlots, 4) counts of
                                     // the tiles' windows, or null
};

template <int kPad>
struct StageShared {
  DepositAccN<kPad> acc;
  float du[kPad], dv[kPad], rho[kPad];
  DepositTile tile;
  WindowScratch wsc;
  double wpart[kWarps][2];
};

template <int kMode, int kPad>
__global__ void __launch_bounds__(kThreads, kStageBlocksPerSm)
stage_kernel(const StageArgs a) {
  __shared__ StageShared<kPad> S;
  constexpr bool kWin = kMode != kFull;
  const int tid = threadIdx.x;
  const int nb = gridDim.x;
  const bool dep = kMode != kStaged || a.tail != kTailNone;
  const bool with_q = kMode == kStaged && !a.first;
  const int n_tiles = (a.n + kThreads - 1) / kThreads;
  // the other parity's counter, last used by the previous launch, for the
  // next one
  if (blockIdx.x == 0 && tid == 0) a.sync[(1 - a.parity) * kCountStride] = 0;
  Ray y;
  float qd = 0.0f, qr = 0.0f, qm = 0.0f;
  auto load = [&](int i) {
    y = load_ray(a.f, i);
    if (with_q) {
      qd = a.q_dens[i];
      qr = a.q_r[i];
      qm = a.q_m[i];
    }
  };
  // the first tile's loads go out before the tables are built
  if (blockIdx.x * kThreads + tid < a.n) load(blockIdx.x * kThreads + tid);
  const float g0c = a.centers[0];
  const Geometry g(g0c, a.centers[1] - g0c, a.faces[1], a.n_tab);
  const int n_flux = g.n_flux;
  for (int c = tid; c < a.c_pad; c += kThreads) {
    S.du[c] = c < n_flux ? (a.u[c + 1] - a.u[c]) / g.dz : 0.0f;
    S.dv[c] = c < n_flux ? (a.v[c + 1] - a.v[c]) / g.dz : 0.0f;
    S.rho[c] = c < a.n_tab ? a.rhobar[c] : 0.0f;
  }
  S.acc.zero(n_flux);

  int bmin = INT_MAX, bmax = INT_MIN;   // the cells the block's tiles touched
  for (int j = 0, t = blockIdx.x; t < n_tiles; ++j, t += nb) {
    const int i = t * kThreads + tid;
    const bool in = i < a.n;
    if (j > 0 && in) load(i);
    __syncthreads();               // the tables, and the last tile done
    RayTerms rt;
    int lo = kEmptyLo, hi = kEmptyHi;
    if (in) {
      rt = ray_terms(y, g, a.dt, a.bvf);
      if (kWin) window_bounds(rt, y.act, lo, hi);
    }
    if (dep) deposit_stage(S.tile, rt.live, rt.nlow, rt.nup, rt.r_lo, rt.r_up,
                           rt.fvk, rt.fvl);
    if (kWin) window_stage(S.wsc, lo, hi);
    __syncthreads();
    int base = 0, width = a.c_pad;
    if (kWin) {
      const int tier = window_read(S.wsc, a.c_pad, a.w1, a.w2, base, width);
      if (kMode == kWindow && a.tiers != nullptr && tid == 0)
        a.tiers[t] = static_cast<signed char>(tier);
      if (a.tier_counts != nullptr && tid == 0) count_tier(a.tier_counts, tier);
    }
    if (in) {
      const float du = interp_window(S.du, n_flux, base, width, rt.qf);
      const float dv = interp_window(S.dv, n_flux, base, width, rt.qf);
      const float rho =
          a.online ? interp_window(S.rho, a.n_tab, base, width, rt.qr) : 0.0f;
      const Tendencies td = ray_tendencies(y, rt, du, dv, rho, a.dt, a.bvf,
                                           a.kappa, a.f0, a.online, a.faithful);
      if (kMode == kStaged) {
        a.out_dens[i] = rk3_stage(td.dens, y.dens, &qd, a.dt, a.cc, a.bc, a.first);
        a.out_r[i] = rk3_stage(td.r, y.r, &qr, a.dt, a.cc, a.bc, a.first);
        a.out_m[i] = rk3_stage(td.m, y.m, &qm, a.dt, a.cc, a.bc, a.first);
        a.q_dens[i] = qd;
        a.q_r[i] = qr;
        a.q_m[i] = qm;
      } else {
        a.out_dens[i] = td.dens;
        a.out_r[i] = td.r;
        a.out_m[i] = td.m;
      }
    }
    if (dep) {
      int cmin, cmax;
      tile_cells(S.tile, cmin, cmax);
      if (cmax > cmin) {
        bmin = min(bmin, cmin);
        bmax = max(bmax, cmax);
      }
      const int P = walk(S, g.g0c, g.dz, cmin);
      if (P) {
        __syncthreads();
        walk_finish(S, P, cmin, n_flux);
      }
    }
  }
  if (!dep) return;

  // --- the tail: publish; the last blocks sum and update the wind --------
  __syncthreads();
  const int lo = bmax > bmin ? bmin : 0, hi = bmax > bmin ? bmax : 0;
  for (int c = lo + tid; c < hi; c += kThreads) {
    a.partials[static_cast<size_t>(c) * nb + blockIdx.x] = S.acc.v[0][c];
    a.partials[static_cast<size_t>(n_flux + c) * nb + blockIdx.x] = S.acc.v[1][c];
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

  // Reducer red owns cells red, red + n_red, ... of the n_tab wind cells:
  // it sums the flux entries (var, cell) that the cell needs, each by a
  // group of 64 threads (thread t of the group adding blocks t, t + 64, ...
  // in order; a block whose range misses the cell adds an exact zero in
  // place of its partial; a butterfly per warp; the group's two warp sums
  // in order).  K2/K3: the cell's own entry of each var, written to flux.
  // K4: the entries at up = min(c, n_flux - 1) and dn = max(c - 1, 0) of
  // both vars (each entry is summed by the reducers of two cells, in the
  // same order, so to the same value), then the cell's wind update.
  const bool wind = kMode == kStaged && a.tail == kTailWind;
  const int n_cell = a.n_tab;
  const int grp = tid >> 6, gt = tid & 63;
  float wu = 0.0f, wv = 0.0f, wrho = 1.0f, wp0 = 0.0f, wp1 = 0.0f, wqu = 0.0f,
        wqv = 0.0f;
  auto wind_load = [&](int c) {   // the cell's operands, by thread 0
    wu = a.u[c];
    wv = a.v[c];
    wrho = a.rhobar[c];
    wp0 = a.pg[c];
    wp1 = a.pg[n_cell + c];
    wqu = a.first ? 0.0f : a.qu[c];
    wqv = a.first ? 0.0f : a.qv[c];
  };
  if (wind && tid == 0 && red < n_cell) wind_load(red);
  wait_count(arrivals, nb);
  for (int c = red; c < n_cell; c += a.n_red) {
    if (!wind && c >= n_flux) break;
    // group g sums entry (var g & 1, cell: K4 g < 2 ? up : dn; else c)
    const int cell = !wind ? c : (grp < 2 ? min(c, n_flux - 1) : max(c - 1, 0));
    double sum = 0.0;
    if (wind || grp < 2) {
      const double* p = a.partials + static_cast<size_t>((grp & 1) * n_flux + cell) * nb;
#pragma unroll 8
      for (int b = gt; b < nb; b += 64) {
        const int rb = __ldcg(a.ranges + b);
        const double pv = __ldcg(p + b);
        sum += (rb >> 16) <= cell && cell < (rb & 0xffff) ? pv : 0.0;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if ((tid & 31) == 0) S.wpart[tid >> 5][0] = sum;
    __syncthreads();
    if (tid == 0) {
      double e[4];
      for (int x = 0; x < 4; ++x) e[x] = S.wpart[2 * x][0] + S.wpart[2 * x + 1][0];
      if (c < n_flux) {
        a.flux[c] = static_cast<float>(e[0]);
        a.flux[n_flux + c] = static_cast<float>(e[1]);
      }
      if (wind) {
        if (c != red) wind_load(c);
        const float dzf = a.faces[1] - a.faces[0];
        const float gx = (static_cast<float>(e[0]) - static_cast<float>(e[2])) / dzf;
        const float gy = (static_cast<float>(e[1]) - static_cast<float>(e[3])) / dzf;
        const float du = a.ff0 * wv - (wp0 + gx) / wrho;
        const float dv = -a.ff0 * wu - (wp1 + gy) / wrho;
        a.u_out[c] = rk3_stage(du, wu, &wqu, a.dt, a.cc, a.bc, a.first);
        a.v_out[c] = rk3_stage(dv, wv, &wqv, a.dt, a.cc, a.bc, a.first);
        a.qu[c] = wqu;
        a.qv[c] = wqv;
      }
    }
    __syncthreads();
  }
}

template <int kMode, int kPad>
cudaError_t launch_stage(const StageArgs& a, int n_blocks, cudaStream_t s) {
  stage_kernel<kMode, kPad><<<n_blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(const StageArgs& a, int n_blocks, cudaStream_t s) {
  if (a.c_pad <= 128) return launch_stage<kMode, 128>(a, n_blocks, s);
  if (a.c_pad <= 256) return launch_stage<kMode, 256>(a, n_blocks, s);
  return launch_stage<kMode, kMaxCells + 128>(a, n_blocks, s);
}

// The common checks and fields of the three entry points.
bool fill_stage(StageArgs& a, const float* centers, const float* faces,
                const float* u, const float* v, const float* rhobar, int n_tab,
                int c_pad, int w1, int w2, float dt, float bvf, float kappa,
                float f0, const float* dens, const float* r, const float* dr,
                const float* k, const float* l, const float* m, const float* dm,
                const float* phi, const float* dkk, const float* dll,
                const float* area, const unsigned char* active, int n,
                float* out_dens, float* out_r, float* out_m, float* flux,
                double* partials, int* ranges, int* sync, int parity,
                int n_blocks, int n_red, int online, int faithful) {
  const int tiles = n < 1 ? 0 : (n - 1) / kThreads + 1;
  if (n_tab < 3 || n_tab > kMaxCells + 1 || c_pad < n_tab ||
      c_pad > kMaxCells + 128 || w1 < 16 || w1 > c_pad ||
      (w2 != 0 && (w2 <= w1 || w2 > c_pad)) || n < 1 || n_blocks < 1 ||
      n_blocks > tiles || n_red < 1 || n_red > n_blocks ||
      n_red > kMaxReducers || (parity != 0 && parity != 1) ||
      centers == nullptr || faces == nullptr ||
      u == nullptr || v == nullptr || rhobar == nullptr || flux == nullptr ||
      partials == nullptr || ranges == nullptr || sync == nullptr)
    return false;
  a = StageArgs{};
  a.centers = centers;
  a.faces = faces;
  a.u = u;
  a.v = v;
  a.rhobar = rhobar;
  a.dt = dt;
  a.bvf = bvf;
  a.kappa = kappa;
  a.f0 = f0;
  a.n_tab = n_tab;
  a.c_pad = c_pad;
  a.w1 = w1;
  a.w2 = w2;
  a.n = n;
  a.n_red = n_red;
  a.online = online != 0;
  a.faithful = faithful != 0;
  a.f = RayFields{dens, r, dr, k, l, m, dm, phi, dkk, dll, area, active};
  a.out_dens = out_dens;
  a.out_r = out_r;
  a.out_m = out_m;
  a.flux = flux;
  a.partials = partials;
  a.ranges = ranges;
  a.sync = sync;
  a.parity = parity;
  return true;
}

}  // namespace msgwam

// The block plan of K2-K4 for n rays on the current device: out = (blocks,
// reducers, SMs).  Blocks: one per 256-ray tile up to kStageBlocksPerSm per
// SM, which then loop over tiles; reducers: the last blocks to arrive, one
// per flux entry, at most 256 and at most the blocks.  A function of n,
// n_flux and the card only, so the order of the flux sums is too.
extern "C" int msgwam_rhs_plan(int n, int n_flux, int* out) {
  using namespace msgwam;
  if (n < 1 || n_flux < 2 || n_flux > kMaxCells || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every instantiation must hold kStageBlocksPerSm blocks per SM, so that
  // the whole grid is resident
  const void* kernels[] = {
      reinterpret_cast<const void*>(stage_kernel<kFull, 128>),
      reinterpret_cast<const void*>(stage_kernel<kFull, 256>),
      reinterpret_cast<const void*>(stage_kernel<kFull, kMaxCells + 128>),
      reinterpret_cast<const void*>(stage_kernel<kWindow, 128>),
      reinterpret_cast<const void*>(stage_kernel<kWindow, 256>),
      reinterpret_cast<const void*>(stage_kernel<kWindow, kMaxCells + 128>),
      reinterpret_cast<const void*>(stage_kernel<kStaged, 128>),
      reinterpret_cast<const void*>(stage_kernel<kStaged, 256>),
      reinterpret_cast<const void*>(stage_kernel<kStaged, kMaxCells + 128>)};
  for (const void* k : kernels) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < kStageBlocksPerSm)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int tiles = (n + kThreads - 1) / kThreads;
  const int nb = std::min(tiles, kStageBlocksPerSm * sms);
  const int red = std::min(std::min(nb, n_flux + 1), kMaxReducers);
  out[0] = nb;
  out[1] = red;
  out[2] = sms;
  return 0;
}

// K2: the fused RHS at full width.  dens_st, drr_st, dmm_st receive the
// tendencies, flux the (2, n_tab - 1) interior flux.  The shear tables come
// from the wind u, v, the geometry from centers (n_tab) and faces.  Scratch,
// sized from msgwam_rhs_plan's plan: partials (2 (n_tab - 1), n_blocks)
// doubles, ranges (n_blocks) ints; sync (64) ints, zeroed once, the same
// buffer for every launch on the stream, with parity the count of earlier
// launches on it modulo 2.
extern "C" int msgwam_rhs_fused(
    const float* centers, const float* faces, const float* u, const float* v,
    const float* rhobar, int n_tab, float dt, float bvf, float kappa, float f0,
    const float* dens, const float* r, const float* dr, const float* k,
    const float* l, const float* m, const float* dm, const float* phi,
    const float* dkk, const float* dll, const float* area,
    const unsigned char* active, int n, float* dens_st, float* drr_st,
    float* dmm_st, float* flux, double* partials, int* ranges, int* sync,
    int parity, int n_blocks, int n_red, int saturate_online, int faithful,
    void* stream) {
  using namespace msgwam;
  const int c_pad = (n_tab + 127) / 128 * 128;
  StageArgs a;
  if (!fill_stage(a, centers, faces, u, v, rhobar, n_tab, c_pad, 16, 0, dt, bvf,
                  kappa, f0, dens, r, dr, k, l, m, dm, phi, dkk, dll, area,
                  active, n, dens_st, drr_st, dmm_st, flux, partials, ranges,
                  sync, parity, n_blocks, n_red, saturate_online, faithful))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_mode<kFull>(a, n_blocks, static_cast<cudaStream_t>(stream)));
}

// staged = 0: K3, out_* are the tendencies, q_*, u_out, v_out, qu, qv and
// pg unused; tiers (optional, one byte per tile: 1 window, 2 second tier, 0
// full width) written.  K3 and K4: tier_counts (optional, (1024, 4):
// ray_physics.cuh's count_tier) receives the launch's count of tiles at
// full width, in the first window and in the second.
// staged = 1: K4, out_* are y' and q_* the RK3 registers (read after the
// first stage, written always); cc, bc and first are the stage's
// coefficients.  tail 0 (kTailNone): no deposit, flux unused.  tail 1
// (kTailWind, a prognostic wind): the flux written and the wind after the
// stage in u_out, v_out (which may be u, v), its registers in qu, qv (read
// after the first stage); ff0 is the wind's Coriolis parameter.  tail 2
// (kTailFlux, a prognostic wind under ray sharding): the flux written, as
// K2/K3 write it, and u_out, v_out, qu, qv, pg unused.
// Scratch as K2's.
extern "C" int msgwam_rhs_windowed(
    const float* centers, const float* faces, const float* u, const float* v,
    const float* rhobar, const float* pg, int n_tab, int c_pad, int w1, int w2,
    float dt, float bvf, float kappa, float f0, float ff0, const float* dens,
    const float* r, const float* dr, const float* k, const float* l,
    const float* m, const float* dm, const float* phi, const float* dkk,
    const float* dll, const float* area, const unsigned char* active, int n,
    float* out_dens, float* out_r, float* out_m, float* q_dens, float* q_r,
    float* q_m, float* u_out, float* v_out, float* qu, float* qv, float* flux,
    double* partials, int* ranges, int* sync, int parity, signed char* tiers,
    unsigned long long* tier_counts, int n_blocks, int n_red,
    int saturate_online, int faithful, int staged, int tail, float cc,
    float bc, int first, void* stream) {
  using namespace msgwam;
  StageArgs a;
  if (!fill_stage(a, centers, faces, u, v, rhobar, n_tab, c_pad, w1, w2, dt,
                  bvf, kappa, f0, dens, r, dr, k, l, m, dm, phi, dkk, dll, area,
                  active, n, out_dens, out_r, out_m, flux, partials, ranges,
                  sync, parity, n_blocks, n_red, saturate_online, faithful) ||
      (staged && (q_dens == nullptr || q_r == nullptr || q_m == nullptr)) ||
      (staged && (tail < kTailNone || tail > kTailFlux)) ||
      (staged && tail == kTailWind &&
       (pg == nullptr || u_out == nullptr || v_out == nullptr ||
        qu == nullptr || qv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.tier_counts = tier_counts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!staged) {
    a.tiers = tiers;
    return static_cast<int>(launch_mode<kWindow>(a, n_blocks, s));
  }
  a.pg = pg;
  a.ff0 = ff0;
  a.cc = cc;
  a.bc = bc;
  a.first = first != 0;
  a.tail = tail;
  a.q_dens = q_dens;
  a.q_r = q_r;
  a.q_m = q_m;
  a.u_out = u_out;
  a.v_out = v_out;
  a.qu = qu;
  a.qv = qv;
  return static_cast<int>(launch_mode<kStaged>(a, n_blocks, s));
}
