// K5: whole Williamson RK3 steps of the coupled hprop=False model in one
// launch, on Hopper, with the ray state kept on chip for the whole launch.
//
// Replaces msgwam_tpu/ops/step_pallas.py:_kernel (entry points
// _megakernel_call, _simulate_resident_impl, simulate_resident).  On the
// TPU the kernel kept the rays, the RK3 registers and the wind in VMEM for
// the whole run over a sequential (steps, stages, tiles) grid.  Here the
// grid is persistent and cooperative (cudaLaunchCooperativeKernel, every
// block resident at once, so blocks may wait on each other), and each tile
// block owns the same 256-ray tiles in every phase (t = rank, rank + n_tb,
// ...), so it keeps its rays' state:
//   - dens, r, m, the RK3 registers qd, qr, qm (and, offline, the pre-step
//     r_prev, m_prev) and the mask of the block's first tile in registers,
//     of its next n_slots tiles in dynamic shared memory, and of any further
//     tiles in device memory, streamed as before (the kernel takes any count
//     that fits the card).  They are loaded once at the launch start and
//     written back once at its end;
//   - the read-only terms of each ray (ray_physics.cuh's RayInv: ff^2,
//     k^2 + l^2, bvf^2 (k^2 + l^2), dr/2, k, l, |dkk dll dm|, dkk dll
//     area/dr), computed once per launch in the order of operations of
//     ray_physics.cuh, so every per-ray value is what it was; in shared
//     memory when every block owns one tile, else in a device-memory scratch
//     (8 floats per ray).
// The on-chip capacity (resident_plan below, mirrored by
// ops/step_cuda.py:resident_plan): 4 blocks of 256 threads per SM, each with
// smem_per_sm / 4 - reserved = 57,344 bytes of shared memory on an H100
// (233,472 / 4 - 1,024), of which the static Fixed<kPad> takes 44 kPad +
// 6,656 (12,288 at kPad = c_pad = 128) and a slot, one tile, 256 (4 f + 1)
// with f = 6 floats online and 8 offline.  So a block holds 1 + 7 tiles on
// chip online: 4,224 tiles (1,081,344 rays) on 132 SMs.
//
// The stages are software-pipelined around the one dependency that crosses
// the grid.  Stage s's ray update (B) needs the wind after stage s - 1's
// flux, but stage s's deposit (A) needs only the state (hprop off), so:
//   prologue: A(0);
//   stage s: [the wind from stage s - 1's flux] B(s) [reduce s] A(s + 1).
//   A: per tile, the window bounds and (prognostic wind) the deposit inputs
//      staged together; block barrier; the window kept for B and the
//      deposit walk into the block's float64 sums; block barrier; at the
//      end the sums go out as the block's stage partial (publish).
//   B: per tile, the three lookups through A's window, the tendencies, the
//      RK3 update of dens, r, m and q in place; after the third stage the
//      lifecycle (K6/K7) or the offline saturation (its own window, two
//      barriers).  No barrier otherwise.
//   reduce: the flux of stage s from the tile blocks' partials (FluxSync);
//      it runs while the tile blocks deposit stage s + 1, and the blocks
//      wait for it (one grid-wide wait per stage) only before B(s + 1).
//   wind: every block updates its own copy: the flux divergence (boundary
//      padding by copy), Coriolis f0, the pressure gradient times the
//      precomputed 1/rho, and the q/y stage update of u and v
//      (step_pallas.py:384-402); then the shear tables.  Every block holds
//      the same wind, computed from the same inputs in the same order.
// Without a prognostic mean flow there is no deposit, no reduce and no
// wait.  The offline saturation (step_pallas.py:404-506: finite-difference
// rates across the step, quirk 2's height rate divided by rdiv = 1, rho at
// r_prev + rate dt through a W-wide window, the pre-saturation density of
// the last step to dens_prop) needs no grid-wide wait: each ray is read and
// written by the same thread in every phase.  The flux sums keep a fixed
// order that depends only on the block count, i.e. on n and the device:
// two runs are bitwise equal, and there are no float atomics.
//
// The TPU built host matrices for the shear and the flux divergence to feed
// its matrix unit (build_operators); here both are two-point differences.
//
// What bounds it on the H100: 3 (120 + 12 + 11 cells) f32 operations per
// ray-step with the deposit (chip_smoke.py's RHS_OPS, RK3_OPS and
// DEPOSIT_CELL_OPS), 462 at the launch state's 2.0 covered cells, 0.69 us a
// step at 1e5 rays at 67 TFLOP/s; the bytes, 57 per ray per launch, are far
// below.  The time
// above that bound is latency: a tile's chain of dependent shared-memory
// reads, divisions and barriers, and the grid-wide wait for the flux.
// What the design does about it: no per-stage device-memory traffic for
// on-chip tiles, no per-stage recomputation of the frozen terms, the wait
// overlapped with the next stage's deposit, the reduce spread over blocks
// without tiles where the card has room, and narrow tiles walked by several
// warps per cell.
//
// K6/K7: the same kernel, instantiated with kStream = true.  Replaces
// msgwam_tpu/ops/step_pallas_stream.py:_kernel (entry point
// _streamkernel_call; K7 is its n_members > 1 form).  What kStream adds:
//   - the lifecycle at the end of the third stage (step_pallas_stream.py:
//     431-465): after the RK3 update a ray is culled when it has left the
//     domain, passed |m| > m_max or gone non-finite; with relaunch every
//     inactive slot is refilled (dens, r, m) from the template and the mask
//     becomes new_act | src_act.  The mask lives with the ray's state and is
//     written back at the launch end (streamed tiles: at each step).  With
//     relaunch the pre-relaunch density of the last step goes to dens_prop;
//   - the prescribed wind (step_pallas_stream.py:234-268): at the start of
//     each step every block overwrites its wind from the step's row of a
//     (n_steps, rows, n_tab) table and rebuilds its shear tables.  The final
//     wind is the last row used, evolved through the step's stages when
//     prognostic;
//   - members (K7): n = n_members * n_per rays, member e at [e n_per,
//     (e+1) n_per), each padded to whole 256-ray tiles by masking.  Block b
//     serves member b / bpm only (bpm blocks per member), holds that
//     member's wind and tables, and takes part in that member's flux
//     protocol only (its own counters and buffers).  With one member it is
//     K5's rule.
// The kStream = false instantiation is K5.
//
// Occupancy: both instantiations are bounded to 64 registers, four
// 256-thread blocks per SM (kBlocksPerSm), which the shared-memory budget
// above assumes.  With a.tier_counts (a profiler's session,
// utils/profiling.py) thread 0 counts its tiles' window tiers: K5 with one
// integer atomicAdd a tile window as it reads it (a block holds many
// tiles, and the adds overlap their work), K6/K7 in shared memory
// (Fixed::tier_n), added once at the launch's end (at 1e5 a block holds
// one tile, and an add a window waited at each grid-wide flux wait: 7.5%
// more time).  K5 counting in shared memory spills at the register bound;
// a count in a register across the launch spills in both.
#include <algorithm>
#include <climits>

#include "ray_physics.cuh"

namespace msgwam {

constexpr int kBlocksPerSm = 4;
constexpr int kInvFields = 8;       // RayInv's floats

struct ResidentArgs {
  float g0c, dz, g0f, dzf, dt, bvf, kappa, f0, rdiv;
  int n_tab, c_pad, w1, w2, n, n_steps;
  bool online, prognostic, faithful;
  RayFields f;                       // f.dens, f.r, f.m alias dens, r, m
  float *dens, *r, *m;               // the state, updated in place
  float *qd, *qr, *qm;               // RK3 registers of streamed tiles
  float *r_prev, *m_prev, *dens_prop;   // offline mode
  float* uv;                         // (2, n_tab) wind: in, and out at the end
  const float *rhobar, *pg, *inv_rho;   // (n_tab,), (2, n_tab), (n_tab,)
  float* flux;                       // (2, members, 2, n_tab - 1) scratch
  double* partials;                  // (2, members, 2 (n_tab - 1), n_tb) scratch
  int* sync;                         // (members, 2, 2, 32) zeroed: per stage
                                     // parity, arrivals and flux entries done
  float* inv;                        // (kInvFields, n) scratch
  int* win;                          // (tiles_per_block - kWinShared, gridDim.x)
  int n_slots;                       // tiles per block in shared memory
  bool inv_shared;                   // every block owns one tile: its
                                     // invariants in shared memory
  unsigned long long* tier_counts;   // (kTierSlots, 4) counts of the
                                     // deposit passes' windows, or null
  // K6/K7 only (kStream)
  unsigned char* act;                // the mask, updated in place (= f.act)
  const float *src_dens, *src_r, *src_m;   // relaunch template, or null
  const unsigned char* src_act;
  const float* wind;                 // (n_steps, wind_rows, n_tab), or null
  int wind_rows;                     // 2 (shared) or 2 * n_members
  float m_max, face_lo, face_hi;
  bool cull, relaunch;
  int n_members, n_per, bpm;         // members, rays and blocks per member
  int n_tb;                          // blocks per member that own tiles; the
                                     // others (rank >= n_tb) only reduce
};

// The block's fixed shared memory for tables of kPad entries (c_pad <=
// kPad): the flux sums, the shear, rho and wind tables with the wind's RK3
// registers, the deposit tile (also the reduce's staging, kStage doubles)
// and the window scratch.
constexpr int kWinShared = 64;      // tiles per block whose window is kept
                                    // in shared memory (the rest: a.win)
template <int kPad>
struct Fixed {
  DepositAccN<kPad> acc;
  float du[kPad], dv[kPad], rho[kPad], u[kPad], v[kPad], qu[kPad], qv[kPad];
  DepositTile tile;
  WindowScratch wsc;
  int win[kWinShared];     // each tile's window, base << 16 | width
  double wpart[kWarps][2]; // a narrow tile's per-warp deposit sums
  unsigned tier_n[4];      // K6/K7: the block's tile windows by tier
};
constexpr int kStage = sizeof(DepositTile) / sizeof(double);
constexpr int kStageMax = kInvFields * kThreads / 2;   // the one-tile dyn area

static_assert(sizeof(Fixed<128>) == 44 * 128 + 6672 &&
                  sizeof(Fixed<256>) == 44 * 256 + 6672,
              "ops/step_cuda.py:resident_plan assumes 44 kPad + 6672 bytes");

__host__ __device__ constexpr int slot_floats(bool online) {
  return online ? 6 : 8;
}

// Dynamic shared memory of one on-chip tile past the first: dens, r, m,
// qd, qr, qm (and r_prev, m_prev offline) and the mask byte of each ray.
__host__ __device__ constexpr int slot_bytes(bool online) {
  return kThreads * (4 * slot_floats(online) + 1);
}

// The evolving state of one ray.
struct RayMut {
  float dens = 0.0f, r = 0.0f, m = 0.0f, qd = 0.0f, qr = 0.0f, qm = 0.0f;
  float rp = 0.0f, mp = 0.0f;       // offline: r, m before the step
  bool act = false;
};

// Slot s of the dynamic shared memory (n_slots of them).
__device__ __forceinline__ RayMut get_slot(const float* dyn, int n_slots,
                                           int s, bool online) {
  const int nf = slot_floats(online);
  const float* p = dyn + s * nf * kThreads + threadIdx.x;
  RayMut y;
  y.dens = p[0];
  y.r = p[kThreads];
  y.m = p[2 * kThreads];
  y.qd = p[3 * kThreads];
  y.qr = p[4 * kThreads];
  y.qm = p[5 * kThreads];
  if (!online) {
    y.rp = p[6 * kThreads];
    y.mp = p[7 * kThreads];
  }
  const unsigned char* act =
      reinterpret_cast<const unsigned char*>(dyn + n_slots * nf * kThreads);
  y.act = act[s * kThreads + threadIdx.x] != 0;
  return y;
}

__device__ __forceinline__ void put_slot(float* dyn, int n_slots, int s,
                                         bool online, const RayMut& y) {
  const int nf = slot_floats(online);
  float* p = dyn + s * nf * kThreads + threadIdx.x;
  p[0] = y.dens;
  p[kThreads] = y.r;
  p[2 * kThreads] = y.m;
  p[3 * kThreads] = y.qd;
  p[4 * kThreads] = y.qr;
  p[5 * kThreads] = y.qm;
  if (!online) {
    p[6 * kThreads] = y.rp;
    p[7 * kThreads] = y.mp;
  }
  unsigned char* act = reinterpret_cast<unsigned char*>(dyn + n_slots * nf * kThreads);
  act[s * kThreads + threadIdx.x] = y.act ? 1 : 0;
}

// A ray's invariants at p, field f at p[f stride].
__device__ __forceinline__ void put_inv(float* p, size_t stride, const RayInv& v) {
  p[0] = v.hdr;
  p[stride] = v.k;
  p[2 * stride] = v.l;
  p[3 * stride] = v.kh2;
  p[4 * stride] = v.bk;
  p[5 * stride] = v.ff2;
  p[6 * stride] = v.pv;
  p[7 * stride] = v.pvol;
}

__device__ __forceinline__ RayInv get_inv(const float* p, size_t stride) {
  RayInv v;
  v.hdr = p[0];
  v.k = p[stride];
  v.l = p[2 * stride];
  v.kh2 = p[3 * stride];
  v.bk = p[4 * stride];
  v.ff2 = p[5 * stride];
  v.pv = p[6 * stride];
  v.pvol = p[7 * stride];
  return v;
}

// The shear tables du/dz, dv/dz on the interior faces from the block's
// wind, zero-padded to c_pad.
template <int kPad>
__device__ __forceinline__ void shear_tables(const ResidentArgs& a,
                                             const Geometry& g, Fixed<kPad>& S) {
  for (int c = threadIdx.x; c < a.c_pad; c += kThreads) {
    S.du[c] = c < g.n_flux ? (S.u[c + 1] - S.u[c]) / g.dz : 0.0f;
    S.dv[c] = c < g.n_flux ? (S.v[c + 1] - S.v[c]) / g.dz : 0.0f;
  }
}

// The lifecycle of one ray after the third stage (kStream): the cull, then
// the relaunch from the template; y holds the ray's new dens, r, m.
__device__ __forceinline__ void lifecycle(const ResidentArgs& a, int i,
                                          float hdr, RayMut& y,
                                          bool last_step) {
  const bool out = (y.r - hdr >= a.face_hi) || (y.r + hdr <= a.face_lo);
  const bool crit = fabsf(y.m) > a.m_max;
  const bool fin = isfinite(y.dens) && isfinite(y.r) && isfinite(y.m);
  bool na = y.act && !out && !crit && fin;
  if (a.relaunch) {
    if (last_step) a.dens_prop[i] = y.dens;   // propagated, before the refill
    if (!na) {
      y.dens = a.src_dens[i];
      y.r = a.src_r[i];
      y.m = a.src_m[i];
    }
    na = na || a.src_act[i] != 0;
  }
  y.act = na;
}

// The flux protocol of stage s, for the block's member: nt blocks own
// tiles (ranks 0 .. nt - 1), na >= nt blocks in all.  After a tile block's
// deposit of stage s its sums go to partials[s % 2] and the member's arrival
// count goes up (publish).  Entry e of the flux (var, cell), e < nv, is
// summed by the block of rank nt + e % (na - nt) when there are blocks
// without tiles, else by rank na - 1 - e % na (the last ranks own one tile
// fewer): once every tile block has arrived it adds the nt partials of the
// entry (staged in shared memory, each lane adding every 32nd in rank
// order, then a fixed butterfly of the 32 lane sums) into flux[s % 2] and
// counts it done (reduce).  A block that needs the flux waits until all nv
// entries of stage s are done (wait_flux).  The order of every sum depends
// only on nt.  The buffers and the counters alternate between even and odd
// stages: a block publishes stage s + 2 only after stage s's flux is done,
// so the count of stage s's parity reaches (s / 2 + 1) nt only when every
// stage-s partial is in; and stage s + 2's flux is summed only after every
// tile block has published stage s + 2, i.e. has read stage s's flux.
struct FluxSync {
  const ResidentArgs& a;
  int member, rank, nt, na, nv;

  // arrivals (count(s)) and entries done (count(s) + kCountStride) of the
  // stages of s's parity
  __device__ int* count(int s) const {
    return a.sync + (4 * member + 2 * (s & 1)) * kCountStride;
  }
  __device__ double* part(int s) const {
    return a.partials +
           ((static_cast<size_t>(s & 1) * a.n_members + member) * nt) * nv;
  }
  __device__ float* flux(int s) const {
    return a.flux + (static_cast<size_t>(s & 1) * a.n_members + member) * nv;
  }

  // partials[s % 2] is (members, nv, nt): each entry's partials side by side
  template <class Acc>
  __device__ void publish(Acc& acc, int s) const {
    double* p = part(s) + rank;
    const int n_flux = nv / 2;
    for (int c = threadIdx.x; c < n_flux; c += kThreads) {
      p[static_cast<size_t>(c) * nt] = acc.v[0][c];
      p[static_cast<size_t>(n_flux + c) * nt] = acc.v[1][c];
      acc.v[0][c] = acc.v[1][c] = 0.0;
    }
    count_up(count(s), 1);
  }

  // stage: shared scratch of n_stage doubles, n_stage <= kStageMax
  __device__ void reduce(double* stage, int n_stage, int s) const {
    const int stride = na > nt ? na - nt : na;
    const int e0 = na > nt ? rank - nt : na - 1 - rank;
    if (e0 < 0 || e0 >= nv) return;
    wait_count(count(s), (s / 2 + 1) * nt);
    const double* p = part(s);
    float* fl = flux(s);
    const int n_mine = (nv - e0 + stride - 1) / stride;
    const int per = max(1, min(n_stage / nt, n_mine));
    const int lane = threadIdx.x & 31;
    constexpr int kLoads = (kStageMax + kThreads - 1) / kThreads;
    for (int q0 = 0; q0 < n_mine; q0 += per) {
      const int qn = min(per, n_mine - q0);
      const int total = qn * nt;
      double val[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int x = threadIdx.x + u * kThreads;
        val[u] = x < total ? __ldcg(p + static_cast<size_t>(e0 + (q0 + x / nt) * stride) * nt +
                                    x % nt)
                           : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int x = threadIdx.x + u * kThreads;
        if (x < total) stage[x] = val[u];
      }
      __syncthreads();
      for (int q = threadIdx.x >> 5; q < qn; q += kWarps) {
        double sum = 0.0;
        for (int b = lane; b < nt; b += 32) sum += stage[q * nt + b];
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) fl[e0 + (q0 + q) * stride] = static_cast<float>(sum);
      }
      __syncthreads();
    }
    count_up(count(s) + kCountStride, n_mine);
  }

  __device__ void wait_flux(int s) const {
    wait_count(count(s) + kCountStride, (s / 2 + 1) * nv);
  }
};

template <bool kStream, int kPad>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
step_resident_kernel(const ResidentArgs a) {
  __shared__ Fixed<kPad> S;
  extern __shared__ __align__(16) float dyn[];   // the slots, or the one
                                                 // tile's invariants
  const Geometry g(a.g0c, a.dz, a.g0f, a.n_tab);
  const int n_cell = a.n_tab;
  const int n_flux = g.n_flux;
  // the block's member, its rank among the member's blocks, and the
  // member's blocks (K5: one member served by every block)
  const int member = kStream ? blockIdx.x / a.bpm : 0;
  const int rank = kStream ? blockIdx.x % a.bpm : blockIdx.x;
  const int n_ranks = kStream ? a.bpm : gridDim.x;
  const int n_tb = a.n_tb;
  const int n_mem = kStream ? a.n_per : a.n;
  const int off = kStream ? member * a.n_per : 0;
  float* uv = a.uv + 2 * n_cell * member;
  const bool prescribed = kStream && a.wind != nullptr;
  const bool life = kStream && a.cull;
  const bool online = a.online;
  const bool prog = a.prognostic;
  const int n_tiles = (n_mem + kThreads - 1) / kThreads;
  const FluxSync fs{a, member, rank, n_tb, n_ranks, 2 * n_flux};
  const int n_stages = 3 * a.n_steps;
  if (rank >= n_tb) {           // a block without tiles: it only reduces
    // (its dynamic shared memory is the one-tile invariants' area, unused)
    for (int s = 0; s < n_stages; ++s)
      fs.reduce(reinterpret_cast<double*>(dyn), kStageMax, s);
    return;
  }
  if (kStream && a.tier_counts != nullptr && threadIdx.x == 0)
    S.tier_n[0] = S.tier_n[1] = S.tier_n[2] = 0;
  for (int c = threadIdx.x; c < a.c_pad; c += kThreads) {
    S.u[c] = c < n_cell ? uv[c] : 0.0f;
    S.v[c] = c < n_cell ? uv[n_cell + c] : 0.0f;
    S.rho[c] = c < n_cell ? a.rhobar[c] : 0.0f;
    S.acc.v[0][c] = S.acc.v[1][c] = 0.0;
  }

  // --- the launch start: state on chip, invariants once ------------------
  RayMut y0;
  for (int j = 0, t = rank; t < n_tiles; ++j, t += n_tb) {
    const int il = t * kThreads + threadIdx.x;
    const int i = off + il;
    RayMut y;
    if (il < n_mem) {
      const Ray ray = load_ray(a.f, i);
      const RayInv v = ray_invariants(ray, a.bvf);
      y.dens = ray.dens;
      y.r = ray.r;
      y.m = ray.m;
      y.act = ray.act;
      if (a.inv_shared)
        put_inv(dyn + threadIdx.x, kThreads, v);
      else
        put_inv(a.inv + i, a.n, v);
    }
    if (j == 0)
      y0 = y;
    else if (j <= a.n_slots)
      put_slot(dyn, a.n_slots, j - 1, online, y);
  }
  __syncthreads();

  // The state of tile j of the block (ray i) and its invariants.
  auto load = [&](int j, int i, bool in, bool with_q) {
    RayMut y;
    if (j == 0) {
      y = y0;
    } else if (j <= a.n_slots) {
      y = get_slot(dyn, a.n_slots, j - 1, online);
    } else if (in) {
      y.dens = a.dens[i];
      y.r = a.r[i];
      y.m = a.m[i];
      if (with_q) {
        y.qd = a.qd[i];
        y.qr = a.qr[i];
        y.qm = a.qm[i];
        if (!online) {
          y.rp = a.r_prev[i];
          y.mp = a.m_prev[i];
        }
      }
      y.act = a.f.act[i] != 0;
    }
    return y;
  };
  auto invariants = [&](int i, bool in) {
    RayInv v;
    if (a.inv_shared)
      v = get_inv(dyn + threadIdx.x, kThreads);
    else if (in)
      v = get_inv(a.inv + i, a.n);
    return v;
  };

  // A: the windows of every tile from the state, and with a prognostic
  // wind the deposit of the state into the block's sums (independent of the
  // wind, hprop off), published as stage s's partial.  Two block barriers
  // per tile.
  auto deposit_pass = [&](int s) {
    for (int j = 0, t = rank; t < n_tiles; ++j, t += n_tb) {
      const int il = t * kThreads + threadIdx.x;
      const bool in = il < n_mem;
      const int i = off + il;
      const RayMut y = load(j, i, in, false);
      const RayInv v = invariants(i, in);
      RayTerms rt;
      int lo = kEmptyLo, hi = kEmptyHi;
      if (in) {
        rt = stage_terms(v, y.dens, y.r, y.m, y.act, g, a.dt);
        window_bounds(rt, y.act, lo, hi);
      }
      if (prog)
        deposit_stage(S.tile, rt.live, rt.nlow, rt.nup, rt.r_lo, rt.r_up,
                      rt.fvk, rt.fvl);
      window_stage(S.wsc, lo, hi);
      __syncthreads();
      if (threadIdx.x == 0) {
        int base, width;
        const int tier = window_read(S.wsc, a.c_pad, a.w1, a.w2, base, width);
        if (a.tier_counts != nullptr) {
          if (kStream)
            ++S.tier_n[tier];
          else
            count_tier(a.tier_counts, tier);
        }
        const int w = base << 16 | width;
        if (j < kWinShared)
          S.win[j] = w;
        else
          a.win[static_cast<size_t>(j - kWinShared) * gridDim.x + blockIdx.x] = w;
      }
      int cmin = 0, P = 0;
      if (prog) P = walk(S, g.g0c, g.dz, cmin);
      __syncthreads();
      if (P) walk_finish(S, P, cmin, n_flux);
    }
    if (prog) {
      __syncthreads();
      fs.publish(S.acc, s);
    }
  };

  // B: stage st of step `step` on every tile with the block's wind: the
  // lookups through the tile's window, the tendencies, the RK3 update of
  // dens, r, m and q in place; after the third stage the lifecycle (K6/K7)
  // or the offline saturation.
  auto update_pass = [&](int step, int st) {
    const bool first = st == 0;
    const bool last_step = step == a.n_steps - 1;
    const float cc = st == 1 ? 5.0f / 9.0f : (st == 2 ? 153.0f / 128.0f : 0.0f);
    const float bc = st == 1 ? 15.0f / 16.0f : (st == 2 ? 8.0f / 15.0f : 0.0f);
    for (int j = 0, t = rank; t < n_tiles; ++j, t += n_tb) {
      const int il = t * kThreads + threadIdx.x;
      const bool in = il < n_mem;
      const int i = off + il;
      RayMut y = load(j, i, in, !first);
      const RayInv v = invariants(i, in);
      const int w = j < kWinShared
                        ? S.win[j]
                        : a.win[static_cast<size_t>(j - kWinShared) * gridDim.x + blockIdx.x];
      const int base = w >> 16, width = w & 0xffff;
      if (!online && first) {       // pre-step state for the FD rates
        y.rp = y.r;
        y.mp = y.m;
      }
      if (in) {
        const RayTerms rt = stage_terms(v, y.dens, y.r, y.m, y.act, g, a.dt);
        const float du = interp_window(S.du, n_flux, base, width, rt.qf);
        const float dv = interp_window(S.dv, n_flux, base, width, rt.qf);
        const float rho =
            online ? interp_window(S.rho, a.n_tab, base, width, rt.qr) : 0.0f;
        const Tendencies td =
            stage_tendencies(v, y.dens, y.m, y.act, rt, du, dv, rho, a.dt,
                             a.bvf, a.kappa, a.f0, online, a.faithful);
        y.dens = rk3_stage(td.dens, y.dens, &y.qd, a.dt, cc, bc, first);
        y.r = rk3_stage(td.r, y.r, &y.qr, a.dt, cc, bc, first);
        y.m = rk3_stage(td.m, y.m, &y.qm, a.dt, cc, bc, first);
        if (life && st == 2) lifecycle(a, i, v.hdr, y, last_step);
      }
      if (!online && st == 2) {     // the offline saturation across the step
        float qr = 0.0f, m_fin = 0.0f;
        int lo = kEmptyLo, hi = kEmptyHi;
        if (in) {
          const float r_rate = (y.r - y.rp) / a.rdiv;
          const float m_rate = (y.m - y.mp) / a.dt;
          const float r_fin = y.rp + r_rate * a.dt;
          m_fin = y.mp + m_rate * a.dt;
          qr = (fminf(fmaxf(r_fin, g.g0c), g.hi_c) - g.g0c) / g.dz;
          if (y.act) {
            lo = static_cast<int>(qr) - 1;
            hi = static_cast<int>(qr) + 2;
          }
        }
        int sbase, swidth;
        tile_window(S.wsc, lo, hi, a.c_pad, a.w1, 0, sbase, swidth);
        if (in) {
          const float rho = interp_window(S.rho, a.n_tab, sbase, swidth, qr);
          const float m_p = y.mp;
          const float omh2 = (v.bk + a.f0 * a.f0 * m_p * m_p) *
                             (1.0f / (v.kh2 + m_p * m_p));
          const float cap = a.kappa * a.kappa * 0.5f * rho * omh2 *
                            rsqrtf(omh2) * a.bvf * a.bvf /
                            (m_fin * m_fin * (omh2 - a.f0 * a.f0));
          const float cap_applied = a.faithful ? cap : cap / v.pvol;
          const bool exceed = (cap < y.dens * v.pvol) && y.act;
          if (last_step) a.dens_prop[i] = y.dens;   // propagated, before the cap
          y.dens = exceed ? cap_applied : y.dens;
        }
        __syncthreads();
      }
      if (j == 0) {
        y0 = y;
      } else if (j <= a.n_slots) {
        put_slot(dyn, a.n_slots, j - 1, online, y);
      } else if (in) {
        a.dens[i] = y.dens;
        a.r[i] = y.r;
        a.m[i] = y.m;
        a.qd[i] = y.qd;
        a.qr[i] = y.qr;
        a.qm[i] = y.qm;
        if (!online && first) {
          a.r_prev[i] = y.rp;
          a.m_prev[i] = y.mp;
        }
        if (life && st == 2) a.act[i] = y.act ? 1 : 0;
      }
    }
  };

  // The wind's stage update from stage s's flux, in every block: the flux
  // divergence (boundary padding by copy), Coriolis f0, the pressure
  // gradient times the precomputed 1/rho, and the q/y stage update of u and
  // v (step_pallas.py:384-402).
  auto wind_update = [&](int s) {
    fs.wait_flux(s);
    const float* fl = fs.flux(s);
    const int st = s % 3;
    const bool first = st == 0;
    const float cc = st == 1 ? 5.0f / 9.0f : (st == 2 ? 153.0f / 128.0f : 0.0f);
    const float bc = st == 1 ? 15.0f / 16.0f : (st == 2 ? 8.0f / 15.0f : 0.0f);
    for (int c = threadIdx.x; c < n_cell; c += kThreads) {
      const int up = min(c, n_flux - 1);
      const int dn = max(c - 1, 0);
      const float gx = (__ldcg(fl + up) - __ldcg(fl + dn)) / a.dzf;
      const float gy = (__ldcg(fl + n_flux + up) - __ldcg(fl + n_flux + dn)) / a.dzf;
      const float u = S.u[c], v = S.v[c];
      const float irho = __ldg(a.inv_rho + c);
      const float du = a.f0 * v - (__ldg(a.pg + c) + gx) * irho;
      const float dv = -a.f0 * u - (__ldg(a.pg + n_cell + c) + gy) * irho;
      S.u[c] = rk3_stage(du, u, S.qu + c, a.dt, cc, bc, first);
      S.v[c] = rk3_stage(dv, v, S.qv + c, a.dt, cc, bc, first);
    }
  };

  // The stages, software-pipelined: stage s's lookups need the wind after
  // stage s - 1's flux, but its deposit needs only the state, so each block
  // deposits stage s + 1 (A) before it waits for stage s's flux, and the
  // reduce of stage s runs while the blocks deposit.  Per stage s:
  // [wind from s - 1's flux] B(s) [reduce s] A(s + 1).
  deposit_pass(0);
  for (int s = 0; s < n_stages; ++s) {
    const int step = s / 3, st = s % 3;
    if (s > 0 && prog) wind_update(s - 1);
    if (st == 0 && prescribed) {    // the step's row of the wind table
      const int row = a.wind_rows == 2 ? 0 : 2 * member;
      const float* w = a.wind + (static_cast<size_t>(step) * a.wind_rows + row) * n_cell;
      __syncthreads();
      for (int c = threadIdx.x; c < n_cell; c += kThreads) {
        S.u[c] = w[c];
        S.v[c] = w[n_cell + c];
      }
    }
    if (s == 0 || prog || (st == 0 && prescribed)) {
      __syncthreads();
      shear_tables(a, g, S);
      __syncthreads();
    }
    update_pass(step, st);
    if (prog) fs.reduce(reinterpret_cast<double*>(&S.tile), kStage, s);
    if (s + 1 < n_stages) deposit_pass(s + 1);
  }
  if (prog) {
    wind_update(n_stages - 1);
    __syncthreads();
  }

  // --- the launch end: the on-chip state back to device memory ----------
  for (int j = 0, t = rank; t < n_tiles && j <= a.n_slots; ++j, t += n_tb) {
    const int il = t * kThreads + threadIdx.x;
    const int i = off + il;
    const RayMut y = j == 0 ? y0 : get_slot(dyn, a.n_slots, j - 1, online);
    if (il < n_mem) {
      a.dens[i] = y.dens;
      a.r[i] = y.r;
      a.m[i] = y.m;
      if (life) a.act[i] = y.act ? 1 : 0;
    }
  }
  if ((prog || prescribed) && rank == 0)
    for (int c = threadIdx.x; c < n_cell; c += kThreads) {
      uv[c] = S.u[c];
      uv[n_cell + c] = S.v[c];
    }
  if (kStream && a.tier_counts != nullptr && threadIdx.x == 0)
    for (int t = 0; t < 3; ++t) count_tier(a.tier_counts, t, S.tier_n[t]);
}

// The block plan of a launch (mirrored by ops/step_cuda.py:resident_plan).
struct Plan {
  int bpm, n_tb, tiles_per_block, n_slots, smem, on_chip, tiles;
};

}  // namespace msgwam

namespace {

template <bool kStream, int kPad>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(msgwam::step_resident_kernel<kStream, kPad>);
}

template <bool kStream>
const void* kernel_for(int c_pad) {
  return c_pad <= 128 ? kernel_ptr<kStream, 128>() : kernel_ptr<kStream, 256>();
}

template <bool kStream>
cudaError_t resident_plan(int n_per, int n_members, int c_pad, int n_flux,
                          bool online, bool prognostic, msgwam::Plan* p) {
  using namespace msgwam;
  const void* kernel = kernel_for<kStream>(c_pad);
  const int fixed = c_pad <= 128 ? static_cast<int>(sizeof(Fixed<128>))
                                 : static_cast<int>(sizeof(Fixed<256>));
  int dev = 0, sms = 0, coop = 0, per_sm_smem = 0, reserved = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm_smem,
                                 cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved,
                                 cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  // the dynamic shared memory a block may take with kBlocksPerSm per SM
  const int budget = per_sm_smem / kBlocksPerSm - reserved - fixed;
  if (budget < kInvFields * kThreads * 4) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             budget);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        budget);
  if (err != cudaSuccess) return err;
  const int capacity = per_sm * sms;
  const int tiles = (n_per + kThreads - 1) / kThreads;
  const int per_member = capacity / n_members;
  p->tiles = tiles;
  p->n_tb = std::max(1, std::min(tiles, per_member));
  // blocks without tiles that only reduce the flux, where the card has room
  p->bpm = p->n_tb + (prognostic ? std::min(2 * n_flux, std::max(0, per_member - p->n_tb))
                                 : 0);
  p->tiles_per_block = (tiles + p->n_tb - 1) / p->n_tb;
  p->n_slots = std::min(p->tiles_per_block - 1, budget / slot_bytes(online));
  p->smem = p->tiles_per_block == 1 ? kInvFields * kThreads * 4
                                    : p->n_slots * slot_bytes(online);
  p->on_chip = 0;
  for (int r = 0; r < p->n_tb; ++r)
    p->on_chip += std::min((tiles - r + p->n_tb - 1) / p->n_tb, p->n_slots + 1);
  return cudaSuccess;
}

// The fields K5 and K6 share; returns false on arguments the kernel does
// not take.
bool fill_args(msgwam::ResidentArgs& a, float g0c, float dz, float g0f,
               float dzf, float dt, float bvf, float kappa, float f0,
               float rdiv, int n_tab, int c_pad, int w1, int w2,
               const float* dr, const float* k, const float* l,
               const float* dm, const float* phi, const float* dkk,
               const float* dll, const float* area, const unsigned char* active,
               int n, float* dens, float* r, float* m, float* qd, float* qr,
               float* qm, float* r_prev, float* m_prev, float* dens_prop,
               float* uv, const float* rhobar, const float* pg,
               const float* inv_rho, float* flux, double* partials,
               int* sync, float* inv, int* win, int n_blocks,
               int n_steps, int online, int prognostic, int faithful) {
  using namespace msgwam;
  if (n_tab < 3 || c_pad < n_tab || c_pad > 256 || w1 < 16 ||
      w1 > c_pad || (w2 != 0 && (w2 <= w1 || w2 > c_pad)) || n < 1 ||
      n_blocks < 1 || n_steps < 1 ||
      n_steps > INT_MAX / 3 / std::max(n_blocks, 2 * n_tab) ||
      (!online && (r_prev == nullptr || m_prev == nullptr ||
                   dens_prop == nullptr)))
    return false;
  a = ResidentArgs{};
  a.g0c = g0c;
  a.dz = dz;
  a.g0f = g0f;
  a.dzf = dzf;
  a.dt = dt;
  a.bvf = bvf;
  a.kappa = kappa;
  a.f0 = f0;
  a.rdiv = rdiv;
  a.n_tab = n_tab;
  a.c_pad = c_pad;
  a.w1 = w1;
  a.w2 = w2;
  a.n = n;
  a.n_steps = n_steps;
  a.online = online != 0;
  a.prognostic = prognostic != 0;
  a.faithful = faithful != 0;
  a.f = RayFields{dens, r, dr, k, l, m, dm, phi, dkk, dll, area, active};
  a.dens = dens;
  a.r = r;
  a.m = m;
  a.qd = qd;
  a.qr = qr;
  a.qm = qm;
  a.r_prev = r_prev;
  a.m_prev = m_prev;
  a.dens_prop = dens_prop;
  a.uv = uv;
  a.rhobar = rhobar;
  a.pg = pg;
  a.inv_rho = inv_rho;
  a.flux = flux;
  a.partials = partials;
  a.sync = sync;
  a.win = win;
  a.n_members = 1;
  a.inv = inv;
  return true;
}

// The plan of the launch into a, after checking that the caller sized its
// scratch for the same block count, and the cooperative launch.
template <bool kStream>
cudaError_t launch_planned(msgwam::ResidentArgs& a, int n_per, int n_members,
                           int blocks_per_member, void* stream) {
  msgwam::Plan p;
  const cudaError_t err = resident_plan<kStream>(
      n_per, n_members, a.c_pad, a.n_tab - 1, a.online, a.prognostic, &p);
  if (err != cudaSuccess) return err;
  if (p.bpm != blocks_per_member) return cudaErrorInvalidValue;
  a.n_tb = p.n_tb;
  a.n_slots = p.n_slots;
  a.inv_shared = p.tiles_per_block == 1;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      kernel_for<kStream>(a.c_pad), dim3(n_members * blocks_per_member),
      dim3(msgwam::kThreads), args, static_cast<size_t>(p.smem),
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// The block plan of K5 (stream = 0) or K6/K7 (stream = 1) for n_members
// members of n_per rays on the current device: out = (blocks per member,
// of them with tiles, tiles per block at most, shared-memory slots, dynamic
// shared bytes, tiles on chip per member, tiles per member).  A function of its arguments and the device only, so
// the order of the flux sums is too.  With more members than resident
// blocks the plan has one block per member and the launch is refused.
extern "C" int msgwam_step_resident_plan(int n_per, int n_members, int c_pad,
                                         int n_flux, int online, int prognostic,
                                         int stream, int* out) {
  using namespace msgwam;
  if (n_per < 1 || n_members < 1 || c_pad < 3 || c_pad > 256 || n_flux < 2 ||
      n_flux >= c_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err =
      stream ? resident_plan<true>(n_per, n_members, c_pad, n_flux, online != 0,
                                   prognostic != 0, &p)
             : resident_plan<false>(n_per, n_members, c_pad, n_flux, online != 0,
                                    prognostic != 0, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[] = {p.bpm, p.n_tb, p.tiles_per_block, p.n_slots, p.smem,
                   p.on_chip, p.tiles};
  std::copy(v, v + 7, out);
  return 0;
}

// The whole-run kernel: K5 (stream = 0), K6 (stream = 1, n_members = 1)
// and K7, n_steps whole steps in one cooperative launch; dens, r, m (n_members
// * n_per rays, member-major), the (n_members, 2, n_tab) wind uv and, with the
// lifecycle, the byte mask act are updated in place.  Scratch, sized from
// msgwam_step_resident_plan's plan with the same stream: flux (2, n_members,
// 2, n_tab - 1), partials (2, n_members, 2 (n_tab - 1), tile blocks per
// member), sync (n_members, 2, 2, 32) ints zeroed before the launch, inv (8,
// n_members * n_per) (unused when every block owns one tile), win
// (tiles_per_block - 64, n_members * blocks_per_member) ints (unused below 65
// tiles per block); blocks_per_member must be the plan's.  Offline, r_prev,
// m_prev and dens_prop are needed and dens_prop receives the density before
// the last step's saturation; with relaunch, the last step's density before
// the refill.  K6/K7 only, refused with stream = 0 as more than one member
// is: the lifecycle (cull, and relaunch when the template src_* is given)
// and the prescribed wind table (n_steps, wind_rows, n_tab), wind_rows 2
// (shared) or 2 * n_members.  tier_counts (optional, (1024, 4):
// ray_physics.cuh's count_tier) receives the launch's count of tile windows
// at full width, in the first window and in the second, one per tile and
// stage (the offline saturation's window is not counted).  A refused launch
// (cudaErrorCooperativeLaunchTooLarge and the like) comes back as its error
// code.
extern "C" int msgwam_step_resident(
    float g0c, float dz, float g0f, float dzf, float dt, float bvf,
    float kappa, float f0, float rdiv, int n_tab, int c_pad, int w1, int w2,
    const float* dr, const float* k, const float* l, const float* dm,
    const float* phi, const float* dkk, const float* dll, const float* area,
    unsigned char* act, int n_per, int n_members, float* dens, float* r,
    float* m, float* qd, float* qr, float* qm, float* r_prev, float* m_prev,
    float* dens_prop, float* uv, const float* rhobar, const float* pg,
    const float* inv_rho, float* flux, double* partials, int* sync,
    float* inv, int* win, int blocks_per_member, int n_steps, int online,
    int prognostic, int faithful, int stream, int cull, float m_max,
    float face_lo, float face_hi, const float* src_dens, const float* src_r,
    const float* src_m, const unsigned char* src_act, const float* wind,
    int wind_rows, unsigned long long* tier_counts, void* cuda_stream) {
  using namespace msgwam;
  const bool relaunch = src_dens != nullptr;
  if (n_members < 1 || n_per < 1 || blocks_per_member < 1 ||
      n_per > INT_MAX / n_members ||
      blocks_per_member > INT_MAX / n_members ||
      (!stream && (cull || relaunch || wind != nullptr || n_members != 1)) ||
      (relaunch && (!cull || src_r == nullptr || src_m == nullptr ||
                    src_act == nullptr || dens_prop == nullptr)) ||
      (cull && !online) ||
      (wind != nullptr && wind_rows != 2 && wind_rows != 2 * n_members))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = n_members * blocks_per_member;
  ResidentArgs a;
  if (!fill_args(a, g0c, dz, g0f, dzf, dt, bvf, kappa, f0, rdiv, n_tab, c_pad,
                 w1, w2, dr, k, l, dm, phi, dkk, dll, area, act,
                 n_members * n_per, dens, r, m, qd, qr, qm, r_prev, m_prev,
                 dens_prop, uv, rhobar, pg, inv_rho, flux, partials, sync,
                 inv, win, n_blocks, n_steps, online, prognostic, faithful))
    return static_cast<int>(cudaErrorInvalidValue);
  a.tier_counts = tier_counts;
  if (!stream)
    return static_cast<int>(
        launch_planned<false>(a, n_per, 1, n_blocks, cuda_stream));
  a.act = act;
  a.src_dens = src_dens;
  a.src_r = src_r;
  a.src_m = src_m;
  a.src_act = src_act;
  a.wind = wind;
  a.wind_rows = wind_rows;
  a.m_max = m_max;
  a.face_lo = face_lo;
  a.face_hi = face_hi;
  a.cull = cull != 0;
  a.relaunch = relaunch;
  a.n_members = n_members;
  a.n_per = n_per;
  a.bpm = blocks_per_member;
  return static_cast<int>(launch_planned<true>(a, n_per, n_members,
                                               blocks_per_member, cuda_stream));
}
