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
#include <algorithm>

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
  float* flux;                       // (2, n_tab - 1) scratch
  double* partials;                  // (gridDim.x, 2, n_tab - 1) scratch
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

__global__ void __launch_bounds__(kThreads)
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
  for (int c = threadIdx.x; c < a.c_pad; c += kThreads) {
    s_u[c] = c < n_cell ? a.uv[c] : 0.0f;
    s_v[c] = c < n_cell ? a.uv[n_cell + c] : 0.0f;
    s_rho[c] = c < n_cell ? a.rhobar[c] : 0.0f;
  }
  __syncthreads();
  shear_tables(a, g, s_u, s_v, s_du, s_dv);
  __syncthreads();

  const int n_tiles = (a.n + kThreads - 1) / kThreads;
  for (int step = 0; step < a.n_steps; ++step) {
    for (int st = 0; st < 3; ++st) {
      const bool first = st == 0;
      const float cc = st == 1 ? 5.0f / 9.0f : (st == 2 ? 153.0f / 128.0f : 0.0f);
      const float bc = st == 1 ? 15.0f / 16.0f : (st == 2 ? 8.0f / 15.0f : 0.0f);

      // --- 1. tiles: windowed RHS, stage update in place, deposit --------
      acc.zero(n_flux);
      __syncthreads();
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int i = t * kThreads + threadIdx.x;
        const bool in = i < a.n;
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
          a.dens[i] = rk3_stage(td.dens, y.dens, a.qd + i, a.dt, cc, bc, first);
          a.r[i] = rk3_stage(td.r, y.r, a.qr + i, a.dt, cc, bc, first);
          a.m[i] = rk3_stage(td.m, y.m, a.qm + i, a.dt, cc, bc, first);
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
        for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
          const int i = t * kThreads + threadIdx.x;
          const bool in = i < a.n;
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

      // --- 2-3. fixed-order reduce of the block partials ------------------
      grid.sync();
      for (int vc = blockIdx.x; vc < 2 * n_flux; vc += gridDim.x) {
        const double total = sum_partials(a.partials, gridDim.x, n_flux, vc, s_red);
        if (threadIdx.x == 0) a.flux[vc] = static_cast<float>(total);
      }
      grid.sync();

      // --- 5. the wind update, in every block -----------------------------
      for (int c = threadIdx.x; c < n_cell; c += kThreads) {
        const int up = min(c, n_flux - 1);
        const int dn = max(c - 1, 0);
        const float gx = (__ldcg(a.flux + up) - __ldcg(a.flux + dn)) / a.dzf;
        const float gy =
            (__ldcg(a.flux + n_flux + up) - __ldcg(a.flux + n_flux + dn)) / a.dzf;
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
  if (a.prognostic && blockIdx.x == 0)
    for (int c = threadIdx.x; c < n_cell; c += kThreads) {
      a.uv[c] = s_u[c];
      a.uv[n_cell + c] = s_v[c];
    }
}

}  // namespace msgwam

// The block count of K5 for n rays on the current device: one 256-ray tile
// per block, at most as many blocks as the device holds resident at once
// (a cooperative launch needs them all resident).  A function of n and the
// device only, so the order of the flux sums is too.
extern "C" int msgwam_step_resident_blocks(int n, int* n_blocks) {
  using namespace msgwam;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, step_resident_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + kThreads - 1) / kThreads;
  *n_blocks = std::max(1, std::min(n_tiles, per_sm * sms));
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
  if (n_tab < 3 || c_pad < n_tab || c_pad > kResidentPad || w1 < 16 ||
      w1 > c_pad || (w2 != 0 && (w2 <= w1 || w2 > c_pad)) || n < 1 ||
      n_blocks < 1 || n_steps < 1 ||
      (!online && (r_prev == nullptr || m_prev == nullptr ||
                   dens_prop == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  ResidentArgs a;
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
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(step_resident_kernel), dim3(n_blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream)));
}
