// K5: whole Williamson RK3 steps of the coupled hprop=False model in one
// launch, on Hopper.
//
// Replaces msgwam_tpu/ops/step_pallas.py:_kernel (entry points
// _megakernel_call, _simulate_resident_impl, simulate_resident).  One launch
// runs n_steps steps; per step, per RK3 stage:
//   1. every block walks its 256-ray tiles: the windowed RHS of
//      ray_physics.cuh (the window rule of K3), the stage update of
//      dens/r/m in place (rk3_stage; in offline mode r and m are saved
//      before the first stage writes them), and the flux deposit into the
//      block's float64 sums, stored as the block's partial;
//   2. grid sync;
//   3. the blocks share out the (var, cell) entries of the flux and add the
//      partials of each in a fixed order (deposit.cuh's sum_partials);
//   4. grid sync;
//   5. every block reads the flux and updates its own copy of the wind: the
//      flux divergence (boundary padding by copy), Coriolis f0, the pressure
//      gradient times the precomputed 1/rho, and the q/y stage update of u
//      and v (step_pallas.py:384-402); then the next stage's shear tables
//      from the new u, v.  Every block holds the same wind, computed from
//      the same inputs in the same order, so the copies stay bitwise equal.
// In offline mode a fourth phase follows the third stage: the direct
// saturation with finite-difference rates across the step, quirk 2 (the
// height rate divided by rdiv = 1) included, rho read at r_prev + rate dt
// (division by dz, as on the TPU) through a W-wide window, and the
// pre-saturation density written to dens_prop before the cap
// (step_pallas.py:404-506).  It needs no grid sync: each ray is read and
// written by the same thread in every phase.
//
// On the TPU the grid was sequential, (steps, stages, tiles); here the
// stage boundary is a dependency across the whole grid, so the kernel is
// persistent and cooperative (cudaLaunchCooperativeKernel, every block
// resident) and the boundary is grid.sync().  The TPU built host matrices
// for the shear and the flux divergence to feed its matrix unit
// (build_operators); here both are two-point differences.  The TPU's
// 131,072-ray VMEM cap does not apply: the rays live in device memory and
// the kernel takes any count.  Without a prognostic mean flow there is no
// wind update and no grid sync at all.
//
// What bounds it on the H100: per stage, the K4 traffic (about 70 B per
// ray) plus two grid syncs, a few microseconds each; the wind update is
// ~100 cells.  At 1e5 rays the state (~6 MB) stays in the 50 MB L2.
//
// K6/K7: the same kernel, instantiated with kStream = true.  Replaces
// msgwam_tpu/ops/step_pallas_stream.py:_kernel (entry point
// _streamkernel_call; K7 is its n_members > 1 form).  On the TPU, K6 was K5
// for any ray count, streaming the state through fast memory; here K5
// already takes any count, so what kStream adds is:
//   - the lifecycle at the end of the third stage (step_pallas_stream.py:
//     431-465): after the RK3 update a ray is culled when it has left the
//     domain, passed |m| > m_max or gone non-finite; with relaunch every
//     inactive slot is refilled (dens, r, m) from the template and the mask
//     becomes new_act | src_act.  The mask is a writable byte array updated
//     in place; it needs no grid sync, because every phase gives each block
//     the same tiles and each thread the same ray.  With relaunch the
//     pre-relaunch density of the last step goes to dens_prop;
//   - the prescribed wind (step_pallas_stream.py:234-268): at the start of
//     each step every block overwrites its wind from the step's row of a
//     (n_steps, rows, n_tab) table and rebuilds its shear tables (no grid
//     sync: each block reads the same row).  The final wind is the last
//     row used, evolved through the step's stages when prognostic;
//   - members (K7): n = n_members * n_per rays, member e at [e n_per,
//     (e+1) n_per), each padded to whole 256-ray tiles by masking.  Block b
//     serves member b / bpm only (bpm blocks per member, all members the
//     same count), walks that member's tiles from b % bpm in steps of bpm,
//     and holds that member's wind and tables; its flux partial is summed,
//     in block order, with the other bpm - 1 blocks of its member only.
//     This rule fixes the order of every member's sums; with one member it
//     is K5's.
// The kStream = false instantiation is K5.
//
// Occupancy: both instantiations are bounded to 64 registers, four
// 256-thread blocks per SM.  Left to itself ptxas gives K5 100 registers
// (two blocks per SM) once the template exists; at the bound neither
// spills, and on an H100 (700 W) K5 takes 16% less device time per step
// at 1e6 rays than at its earlier 80 registers with spills and three
// blocks per SM, and 1-1.5% more at 1e5.
#include <algorithm>
#include <climits>

#include <cooperative_groups.h>

#include "ray_physics.cuh"

namespace cg = cooperative_groups;

namespace msgwam {

constexpr int kResidentPad = 256;   // c_pad of the resident kernel, at most

struct ResidentArgs {
  float g0c, dz, g0f, dzf, dt, bvf, kappa, f0, rdiv;
  int n_tab, c_pad, w1, w2, n, n_steps;
  bool online, prognostic, faithful;
  RayFields f;                       // f.dens, f.r, f.m alias dens, r, m
  float *dens, *r, *m;               // the state, updated in place
  float *qd, *qr, *qm;               // RK3 registers
  float *r_prev, *m_prev, *dens_prop;   // offline mode
  float* uv;                         // (2, n_tab) wind: in, and out at the end
  const float *rhobar, *pg, *inv_rho;   // (n_tab,), (2, n_tab), (n_tab,)
  float* flux;                       // (members, 2, n_tab - 1) scratch
  double* partials;                  // (gridDim.x, 2, n_tab - 1) scratch
  // K6/K7 only (kStream)
  unsigned char* act;                // the mask, updated in place (= f.act)
  const float *src_dens, *src_r, *src_m;   // relaunch template, or null
  const unsigned char* src_act;
  const float* wind;                 // (n_steps, wind_rows, n_tab), or null
  int wind_rows;                     // 2 (shared) or 2 * n_members
  float m_max, face_lo, face_hi;
  bool cull, relaunch;
  int n_members, n_per, bpm;         // members, rays and blocks per member
};

// The shear tables du/dz, dv/dz on the interior faces from the block's
// wind, zero-padded to c_pad.
__device__ __forceinline__ void shear_tables(const ResidentArgs& a,
                                             const Geometry& g,
                                             const float* s_u,
                                             const float* s_v, float* s_du,
                                             float* s_dv) {
  for (int c = threadIdx.x; c < a.c_pad; c += kThreads) {
    s_du[c] = c < g.n_flux ? (s_u[c + 1] - s_u[c]) / g.dz : 0.0f;
    s_dv[c] = c < g.n_flux ? (s_v[c + 1] - s_v[c]) / g.dz : 0.0f;
  }
}

// The lifecycle of one ray after the third stage (kStream): the cull, then
// the relaunch from the template.  dn, rn, mn are the ray's new dens, r, m.
__device__ __forceinline__ void lifecycle(const ResidentArgs& a, int i,
                                          bool act, float dr, float dn,
                                          float rn, float mn, bool last_step) {
  const bool out = (rn - 0.5f * dr >= a.face_hi) || (rn + 0.5f * dr <= a.face_lo);
  const bool crit = fabsf(mn) > a.m_max;
  const bool fin = isfinite(dn) && isfinite(rn) && isfinite(mn);
  bool na = act && !out && !crit && fin;
  if (a.relaunch) {
    if (last_step) a.dens_prop[i] = dn;   // propagated, before the refill
    if (!na) {
      a.dens[i] = a.src_dens[i];
      a.r[i] = a.src_r[i];
      a.m[i] = a.src_m[i];
    }
    na = na || a.src_act[i] != 0;
  }
  a.act[i] = na ? 1 : 0;
}

template <bool kStream>
__global__ void __launch_bounds__(kThreads, 4)
step_resident_kernel(const ResidentArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ DepositTile tile;
  __shared__ DepositAccN<kResidentPad> acc;
  __shared__ WindowScratch wsc;
  __shared__ double s_red[kThreads];
  __shared__ float s_du[kResidentPad], s_dv[kResidentPad], s_rho[kResidentPad];
  __shared__ float s_u[kResidentPad], s_v[kResidentPad];
  __shared__ float s_qu[kResidentPad], s_qv[kResidentPad];

  const Geometry g(a.g0c, a.dz, a.g0f, a.n_tab);
  const int n_cell = a.n_tab;
  const int n_flux = g.n_flux;
  // the block's member, its rank among the member's blocks, and the member's
  // rays (K5: one member of all n rays served by every block; written as
  // blockIdx.x, gridDim.x and a.n there, so that K5's code is as before)
  const int member = kStream ? blockIdx.x / a.bpm : 0;
#define RANK (kStream ? blockIdx.x % a.bpm : blockIdx.x)
#define N_RANKS (kStream ? a.bpm : gridDim.x)
  const int n_mem = kStream ? a.n_per : a.n;
  const int off = kStream ? member * a.n_per : 0;
  float* uv = a.uv + 2 * n_cell * member;
  const float* flux = a.flux + 2 * n_flux * member;
  const bool prescribed = kStream && a.wind != nullptr;
  for (int c = threadIdx.x; c < a.c_pad; c += kThreads) {
    s_u[c] = c < n_cell ? uv[c] : 0.0f;
    s_v[c] = c < n_cell ? uv[n_cell + c] : 0.0f;
    s_rho[c] = c < n_cell ? a.rhobar[c] : 0.0f;
  }
  __syncthreads();
  shear_tables(a, g, s_u, s_v, s_du, s_dv);
  __syncthreads();

  const int n_tiles = (n_mem + kThreads - 1) / kThreads;
  for (int step = 0; step < a.n_steps; ++step) {
    if (prescribed) {       // the step's row of the wind table
      const int row = a.wind_rows == 2 ? 0 : 2 * member;
      const float* w = a.wind + (static_cast<size_t>(step) * a.wind_rows + row) * n_cell;
      __syncthreads();
      for (int c = threadIdx.x; c < n_cell; c += kThreads) {
        s_u[c] = w[c];
        s_v[c] = w[n_cell + c];
      }
      __syncthreads();
      shear_tables(a, g, s_u, s_v, s_du, s_dv);
      __syncthreads();
    }
    for (int st = 0; st < 3; ++st) {
      const bool first = st == 0;
      const float cc = st == 1 ? 5.0f / 9.0f : (st == 2 ? 153.0f / 128.0f : 0.0f);
      const float bc = st == 1 ? 15.0f / 16.0f : (st == 2 ? 8.0f / 15.0f : 0.0f);

      // --- 1. tiles: windowed RHS, stage update in place, deposit --------
      acc.zero(n_flux);
      __syncthreads();
      for (int t = RANK; t < n_tiles; t += N_RANKS) {
        const int il = t * kThreads + threadIdx.x;
        const bool in = il < n_mem;
        const int i = kStream ? off + il : il;
        Ray y;
        RayTerms rt;
        int lo = kEmptyLo, hi = kEmptyHi;
        if (in) {
          y = load_ray(a.f, i);
          if (!a.online && first) {     // pre-step state for the FD rates
            a.r_prev[i] = y.r;
            a.m_prev[i] = y.m;
          }
          rt = ray_terms(y, g, a.dt, a.bvf);
          window_bounds(rt, y.act, lo, hi);
        }
        int base, width;
        tile_window(wsc, lo, hi, a.c_pad, a.w1, a.w2, base, width);
        if (in) {
          const float du = interp_window(s_du, n_flux, base, width, rt.qf);
          const float dv = interp_window(s_dv, n_flux, base, width, rt.qf);
          const float rho =
              a.online ? interp_window(s_rho, a.n_tab, base, width, rt.qr) : 0.0f;
          const Tendencies td =
              ray_tendencies(y, rt, du, dv, rho, a.dt, a.bvf, a.kappa, a.f0,
                             a.online, a.faithful);
          // each field's q and y are stored before the next field's stage
          const float dn = rk3_stage(td.dens, y.dens, a.qd + i, a.dt, cc, bc, first);
          a.dens[i] = dn;
          const float rn = rk3_stage(td.r, y.r, a.qr + i, a.dt, cc, bc, first);
          a.r[i] = rn;
          const float mn = rk3_stage(td.m, y.m, a.qm + i, a.dt, cc, bc, first);
          a.m[i] = mn;
          if (kStream && a.cull && st == 2)
            lifecycle(a, i, y.act, y.dr, dn, rn, mn, step == a.n_steps - 1);
        }
        deposit_stage(tile, rt.live, rt.nlow, rt.nup, rt.r_lo, rt.r_up, rt.fvk,
                      rt.fvl);
        __syncthreads();
        deposit_walk(tile, acc, g.g0c, g.dz);
        __syncthreads();
      }
      deposit_store(acc, a.partials, n_flux);

      // --- offline saturation after the third stage ----------------------
      if (!a.online && st == 2) {
        for (int t = RANK; t < n_tiles; t += N_RANKS) {
          const int il = t * kThreads + threadIdx.x;
          const bool in = il < n_mem;
          const int i = kStream ? off + il : il;
          float qr = 0.0f, r_p = 0.0f, m_p = 0.0f, m_fin = 0.0f, dens_n = 0.0f;
          bool act = false;
          int lo = kEmptyLo, hi = kEmptyHi;
          if (in) {
            r_p = a.r_prev[i];
            m_p = a.m_prev[i];
            dens_n = a.dens[i];
            a.dens_prop[i] = dens_n;          // propagated, before the cap
            const float r_rate = (a.r[i] - r_p) / a.rdiv;
            const float m_rate = (a.m[i] - m_p) / a.dt;
            const float r_fin = r_p + r_rate * a.dt;
            m_fin = m_p + m_rate * a.dt;
            qr = (fminf(fmaxf(r_fin, g.g0c), g.hi_c) - g.g0c) / g.dz;
            act = a.f.act[i] != 0;
            if (act) {
              lo = static_cast<int>(qr) - 1;
              hi = static_cast<int>(qr) + 2;
            }
          }
          int base, width;
          tile_window(wsc, lo, hi, a.c_pad, a.w1, 0, base, width);
          if (in) {
            const float rho = interp_window(s_rho, a.n_tab, base, width, qr);
            const float k = a.f.k[i], l = a.f.l[i];
            const float kh2 = k * k + l * l;
            const float omh2 = (a.bvf * a.bvf * kh2 + a.f0 * a.f0 * m_p * m_p) *
                               (1.0f / (kh2 + m_p * m_p));
            const float cap = a.kappa * a.kappa * 0.5f * rho * omh2 *
                              rsqrtf(omh2) * a.bvf * a.bvf /
                              (m_fin * m_fin * (omh2 - a.f0 * a.f0));
            const float dmm_fin = a.f.area[i] / a.f.dr[i];
            const float pvol = a.f.dkk[i] * a.f.dll[i] * dmm_fin;
            const float cap_applied = a.faithful ? cap : cap / pvol;
            const bool exceed = (cap < dens_n * pvol) && act;
            a.dens[i] = exceed ? cap_applied : dens_n;
          }
          __syncthreads();
        }
      }
      if (!a.prognostic) continue;

      // --- 2-3. fixed-order reduce of each member's block partials --------
      grid.sync();
      // entry w = (member, var, cell) sums the member's n_ranks partials
      const int n_members = kStream ? a.n_members : 1;
      for (int w = blockIdx.x; w < n_members * 2 * n_flux; w += gridDim.x) {
        const int e = kStream ? w / (2 * n_flux) : 0;
        const double total =
            sum_partials(a.partials + static_cast<size_t>(e) * N_RANKS * 2 * n_flux,
                         N_RANKS, n_flux, w - e * 2 * n_flux, s_red);
        if (threadIdx.x == 0) a.flux[w] = static_cast<float>(total);
      }
      grid.sync();

      // --- 5. the wind update, in every block -----------------------------
      for (int c = threadIdx.x; c < n_cell; c += kThreads) {
        const int up = min(c, n_flux - 1);
        const int dn = max(c - 1, 0);
        const float gx = (__ldcg(flux + up) - __ldcg(flux + dn)) / a.dzf;
        const float gy =
            (__ldcg(flux + n_flux + up) - __ldcg(flux + n_flux + dn)) / a.dzf;
        const float u = s_u[c], v = s_v[c];
        const float du = a.f0 * v - (a.pg[c] + gx) * a.inv_rho[c];
        const float dv = -a.f0 * u - (a.pg[n_cell + c] + gy) * a.inv_rho[c];
        s_u[c] = rk3_stage(du, u, s_qu + c, a.dt, cc, bc, first);
        s_v[c] = rk3_stage(dv, v, s_qv + c, a.dt, cc, bc, first);
      }
      __syncthreads();
      shear_tables(a, g, s_u, s_v, s_du, s_dv);
      __syncthreads();
    }
  }
  if ((a.prognostic || prescribed) && RANK == 0)
    for (int c = threadIdx.x; c < n_cell; c += kThreads) {
      uv[c] = s_u[c];
      uv[n_cell + c] = s_v[c];
    }
#undef RANK
#undef N_RANKS
}

}  // namespace msgwam

namespace {

cudaError_t resident_blocks_per_sm(const void* kernel, int* capacity) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        msgwam::kThreads, 0);
  *capacity = per_sm * sms;
  return err;
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
               int n_blocks, int n_steps, int online, int prognostic,
               int faithful) {
  using namespace msgwam;
  if (n_tab < 3 || c_pad < n_tab || c_pad > kResidentPad || w1 < 16 ||
      w1 > c_pad || (w2 != 0 && (w2 <= w1 || w2 > c_pad)) || n < 1 ||
      n_blocks < 1 || n_steps < 1 ||
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
  return true;
}

cudaError_t launch_cooperative(const void* kernel, msgwam::ResidentArgs& a,
                               int n_blocks, void* stream) {
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(kernel, dim3(n_blocks),
                                     dim3(msgwam::kThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// The block count of K5 for n rays on the current device: one 256-ray tile
// per block, at most as many blocks as the device holds resident at once
// (a cooperative launch needs them all resident).  A function of n and the
// device only, so the order of the flux sums is too.
extern "C" int msgwam_step_resident_blocks(int n, int* n_blocks) {
  using namespace msgwam;
  int capacity = 0;
  const cudaError_t err = resident_blocks_per_sm(
      reinterpret_cast<const void*>(step_resident_kernel<false>), &capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + kThreads - 1) / kThreads;
  *n_blocks = std::max(1, std::min(n_tiles, capacity));
  return 0;
}

// n_steps whole steps in one cooperative launch; dens, r, m and uv are
// updated in place.  A refused launch (cudaErrorCooperativeLaunchTooLarge
// and the like) comes back as its error code.
extern "C" int msgwam_step_resident(
    float g0c, float dz, float g0f, float dzf, float dt, float bvf,
    float kappa, float f0, float rdiv, int n_tab, int c_pad, int w1, int w2,
    const float* dr, const float* k, const float* l, const float* dm,
    const float* phi, const float* dkk, const float* dll, const float* area,
    const unsigned char* active, int n, float* dens, float* r, float* m,
    float* qd, float* qr, float* qm, float* r_prev, float* m_prev,
    float* dens_prop, float* uv, const float* rhobar, const float* pg,
    const float* inv_rho, float* flux, double* partials, int n_blocks,
    int n_steps, int online, int prognostic, int faithful, void* stream) {
  using namespace msgwam;
  ResidentArgs a;
  if (!fill_args(a, g0c, dz, g0f, dzf, dt, bvf, kappa, f0, rdiv, n_tab, c_pad,
                 w1, w2, dr, k, l, dm, phi, dkk, dll, area, active, n, dens, r,
                 m, qd, qr, qm, r_prev, m_prev, dens_prop, uv, rhobar, pg,
                 inv_rho, flux, partials, n_blocks, n_steps, online,
                 prognostic, faithful))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(step_resident_kernel<false>), a, n_blocks,
      stream));
}

// The blocks per member of K6/K7 for n_members members of n_per rays:
// one tile per block, and all members' blocks resident at once.  With more
// members than resident blocks this returns 1 and the launch is refused.
extern "C" int msgwam_step_stream_blocks(int n_per, int n_members,
                                         int* blocks_per_member) {
  using namespace msgwam;
  if (n_per < 1 || n_members < 1) return static_cast<int>(cudaErrorInvalidValue);
  int capacity = 0;
  const cudaError_t err = resident_blocks_per_sm(
      reinterpret_cast<const void*>(step_resident_kernel<true>), &capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_per + kThreads - 1) / kThreads;
  *blocks_per_member = std::max(1, std::min(n_tiles, capacity / n_members));
  return 0;
}

// K6 (n_members = 1) and K7: K5's launch plus the lifecycle (cull, and
// relaunch when the template is given), the prescribed wind table and the
// member partition.  act is the mask, updated in place; uv is
// (n_members, 2, n_tab), flux (n_members, 2, n_tab - 1), partials
// (n_members * blocks_per_member, 2, n_tab - 1).  With relaunch, dens_prop
// receives the last step's density before the refill.
extern "C" int msgwam_step_stream(
    float g0c, float dz, float g0f, float dzf, float dt, float bvf,
    float kappa, float f0, float rdiv, int n_tab, int c_pad, int w1, int w2,
    const float* dr, const float* k, const float* l, const float* dm,
    const float* phi, const float* dkk, const float* dll, const float* area,
    unsigned char* act, int n_per, int n_members, float* dens, float* r,
    float* m, float* qd, float* qr, float* qm, float* r_prev, float* m_prev,
    float* dens_prop, float* uv, const float* rhobar, const float* pg,
    const float* inv_rho, float* flux, double* partials,
    int blocks_per_member, int n_steps, int online, int prognostic,
    int faithful, int cull, float m_max, float face_lo, float face_hi,
    const float* src_dens, const float* src_r, const float* src_m,
    const unsigned char* src_act, const float* wind, int wind_rows,
    void* stream) {
  using namespace msgwam;
  const bool relaunch = src_dens != nullptr;
  if (n_members < 1 || n_per < 1 || blocks_per_member < 1 ||
      n_per > INT_MAX / n_members ||
      blocks_per_member > INT_MAX / n_members ||
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
                 dens_prop, uv, rhobar, pg, inv_rho, flux, partials, n_blocks,
                 n_steps, online, prognostic, faithful))
    return static_cast<int>(cudaErrorInvalidValue);
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
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(step_resident_kernel<true>), a, n_blocks,
      stream));
}
