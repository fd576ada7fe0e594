// K3 and K4: the fused hprop=False right-hand side with a height window per
// tile (K3), and the same kernel with the Williamson RK3 stage update of
// dens/r/m fused in (K4), on Hopper.
//
// Replaces msgwam_tpu/ops/rhs_pallas_windowed.py:_kernel, reached through
// _rhs_adaptive_call (staged=False: rhs_fused_windowed, the rhs() of
// rhs_backend="pallas" with window_cells != 0) and _rhs_staged_call
// (staged=True: rk3_step_fused_windowed, the step rk3_step takes on that
// backend).  One template, kStaged, as the TPU's _kernel(..., staged=...).
//
// Per 256-ray tile (the port's tile; the TPU's was 8192 rays): the per-ray
// physics of ray_physics.cuh; the tile's window from its active rays'
// touched cells, with the second tier W2 and the exact full-width path for
// a tile that outgrows both (rhs_pallas_windowed.py:124-147); the shear and
// rho lookups, which read the tables only inside the window; the deposit
// through deposit.cuh, whose cell walk covers exactly the cells the tile's
// rays touch, which lie inside the window.  The window is a cost choice and
// never changes a result: K3's outputs equal K2's.
//
// K4 (kStaged): the tendency of each field goes straight into the RK3
// stage, q' = dt f - c q and y' = y + b q' (the first stage adds q'/3 by
// division).  y' is written to out_* and q' over q_* in place; out_* may be
// the very arrays the ray is read from (stages 2 and 3 update y in place).
// That is safe because each ray is read and written by one thread, which
// reads it whole, and stages its deposit inputs in registers, before it
// writes.  The deposit of a stage therefore uses the stage's input state,
// as on the TPU.
//
// What bounds it on the H100: as K2, 45 B read and 12 B written per ray
// (K4: 12 B more read and 12 B more written for q), far below the compute
// roofline, so memory; the window costs one block reduction per tile.
// The tables (c_pad entries, zero-padded past the grid, so a window
// clipped to c_pad - W never reads outside them) are staged in shared
// memory once per block.
#include "ray_physics.cuh"

namespace msgwam {

constexpr int kMaxPad = 1152;   // c_pad for at most kMaxCells + 1 centers

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
rhs_windowed_kernel(const float* __restrict__ params, float dt, float bvf,
                    float kappa, float f0, const float* __restrict__ du_dz,
                    const float* __restrict__ dv_dz,
                    const float* __restrict__ rhobar, int n_tab, int c_pad,
                    int w1, int w2, RayFields f, int n, float* out_dens,
                    float* out_r, float* out_m, float* q_dens, float* q_r,
                    float* q_m, double* __restrict__ partials,
                    signed char* __restrict__ tiers, bool online,
                    bool faithful, float cc, float bc, bool first) {
  __shared__ DepositTile tile;
  __shared__ DepositAcc acc;
  __shared__ WindowScratch wsc;
  __shared__ float s_du[kMaxPad], s_dv[kMaxPad], s_rho[kMaxPad];
  const Geometry g(params[0], params[1], params[2], n_tab);
  for (int c = threadIdx.x; c < c_pad; c += kThreads) {
    s_du[c] = c < g.n_flux ? du_dz[c] : 0.0f;
    s_dv[c] = c < g.n_flux ? dv_dz[c] : 0.0f;
    s_rho[c] = c < n_tab ? rhobar[c] : 0.0f;
  }
  acc.zero(g.n_flux);
  __syncthreads();

  const int n_tiles = (n + kThreads - 1) / kThreads;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int i = t * kThreads + threadIdx.x;
    const bool in = i < n;
    Ray y;
    RayTerms rt;
    int lo = kEmptyLo, hi = kEmptyHi;
    if (in) {
      y = load_ray(f, i);
      rt = ray_terms(y, g, dt, bvf);
      window_bounds(rt, y.act, lo, hi);
    }
    int base, width;
    const int tier = tile_window(wsc, lo, hi, c_pad, w1, w2, base, width);
    if (!kStaged && tiers != nullptr && threadIdx.x == 0)
      tiers[t] = static_cast<signed char>(tier);
    if (in) {
      const float du = interp_window(s_du, g.n_flux, base, width, rt.qf);
      const float dv = interp_window(s_dv, g.n_flux, base, width, rt.qf);
      const float rho =
          online ? interp_window(s_rho, n_tab, base, width, rt.qr) : 0.0f;
      const Tendencies td = ray_tendencies(y, rt, du, dv, rho, dt, bvf, kappa,
                                           f0, online, faithful);
      if (kStaged) {
        out_dens[i] = rk3_stage(td.dens, y.dens, q_dens + i, dt, cc, bc, first);
        out_r[i] = rk3_stage(td.r, y.r, q_r + i, dt, cc, bc, first);
        out_m[i] = rk3_stage(td.m, y.m, q_m + i, dt, cc, bc, first);
      } else {
        out_dens[i] = td.dens;
        out_r[i] = td.r;
        out_m[i] = td.m;
      }
    }
    deposit_stage(tile, rt.live, rt.nlow, rt.nup, rt.r_lo, rt.r_up, rt.fvk,
                  rt.fvl);
    __syncthreads();
    deposit_walk(tile, acc, g.g0c, g.dz);
    __syncthreads();
  }
  deposit_store(acc, partials, g.n_flux);
}

}  // namespace msgwam

// staged = 0: K3, out_* are the tendencies, q_* unused, tiers (optional,
// one byte per tile: 1 window, 2 second tier, 0 full width) written.
// staged = 1: K4, out_* are y' and q_* the RK3 registers, updated in place;
// cc, bc and first are the stage's coefficients.
extern "C" int msgwam_rhs_windowed(
    const float* params, float dt, float bvf, float kappa, float f0,
    const float* du_dz, const float* dv_dz, const float* rhobar, int n_tab,
    int c_pad, int w1, int w2, const float* dens, const float* r,
    const float* dr, const float* k, const float* l, const float* m,
    const float* dm, const float* phi, const float* dkk, const float* dll,
    const float* area, const unsigned char* active, int n, float* out_dens,
    float* out_r, float* out_m, float* q_dens, float* q_r, float* q_m,
    float* flux, double* partials, signed char* tiers, int n_blocks,
    int saturate_online, int faithful, int staged, float cc, float bc,
    int first, void* stream) {
  using namespace msgwam;
  if (n_tab < 3 || n_tab > kMaxCells + 1 || c_pad < n_tab || c_pad > kMaxPad ||
      w1 < 16 || w1 > c_pad || (w2 != 0 && (w2 <= w1 || w2 > c_pad)) ||
      n_blocks < 1 || n_blocks > kMaxBlocks ||
      (staged && (q_dens == nullptr || q_r == nullptr || q_m == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RayFields f{dens, r, dr, k, l, m, dm, phi, dkk, dll, area, active};
  if (staged)
    rhs_windowed_kernel<true><<<n_blocks, kThreads, 0, s>>>(
        params, dt, bvf, kappa, f0, du_dz, dv_dz, rhobar, n_tab, c_pad, w1, w2,
        f, n, out_dens, out_r, out_m, q_dens, q_r, q_m, partials, nullptr,
        saturate_online != 0, faithful != 0, cc, bc, first != 0);
  else
    rhs_windowed_kernel<false><<<n_blocks, kThreads, 0, s>>>(
        params, dt, bvf, kappa, f0, du_dz, dv_dz, rhobar, n_tab, c_pad, w1, w2,
        f, n, out_dens, out_r, out_m, nullptr, nullptr, nullptr, partials,
        tiers, saturate_online != 0, faithful != 0, 0.0f, 0.0f, false);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_deposit_reduce(partials, n_blocks, n_tab - 1, flux, s));
}
