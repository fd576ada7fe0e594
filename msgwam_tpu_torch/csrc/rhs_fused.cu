// K2: the whole hprop=False right-hand side per ray, fused, on Hopper.
//
// Replaces msgwam_tpu/ops/rhs_pallas.py:_kernel (entry points
// _rhs_fused_call / rhs_fused), the rhs_backend="pallas", window_cells=0
// RHS.  Per ray: cg_r (with the ray's own phi); the shears du/dz, dv/dz
// interpolated at r on the interior faces and rhobar at the extrapolated
// height r + cg_r dt on the centers; dm/dt = -(k du/dz + l dv/dz); online
// saturation (faithful or corrected cap, f0 from the configured phi0, the
// volume from area/dr, exceed tested on the uncorrected cap); the masked
// dens/r/m tendencies; and the (2, n_cells) flux deposit, whose cell
// indices use r * (1/dz) and whose values carry the folded 1/dz, as in the
// Pallas kernel.
//
// The Pallas kernel built (c_pad, 128) hat-basis matrices to feed the MXU;
// here each thread interpolates its ray with a two-point read
// f[i] (1 - t) + f[i+1] t from tables in shared memory, i clamped to
// len - 2 so the upper end never reads past the table.
//
// What bounds it on the H100: it reads 11 f32 fields and one mask byte per
// ray (45 B) and writes 3 f32 (12 B): 57 B per ray per RHS, 57 MB at 1e6
// rays, about 17 us at 3.35 TB/s.  The per-ray arithmetic (~100 flops, one
// sinf, two rsqrtf, four divisions) is far below the compute roofline, so
// the kernel should be bound by memory.  The design reads every field once,
// coalesced, one ray per thread, keeps all intermediates in registers, and
// deposits through the shared cell walk of deposit.cuh with float64
// partials (the TPU kernel's cross-tile Kahan sum becomes a float64 second
// pass, bitwise reproducible).
#include "deposit.cuh"

namespace msgwam {

constexpr float kRotEarth = 7.2921e-5f;
constexpr int kMaxTable = kMaxCells + 1;   // centers: n_flux_cells + 1

// Clamped two-point linear interpolation at a hat coordinate q >= 0.
__device__ __forceinline__ float interp2(const float* f, int len, float q) {
  const int i = min(static_cast<int>(q), len - 2);
  const float t = q - static_cast<float>(i);
  return f[i] * (1.0f - t) + f[i + 1] * t;
}

__global__ void __launch_bounds__(kThreads)
rhs_fused_kernel(const float* __restrict__ params, float dt, float bvf,
                 float kappa, float f0, const float* __restrict__ du_dz,
                 const float* __restrict__ dv_dz,
                 const float* __restrict__ rhobar, int n_tab,
                 const float* __restrict__ dens_p, const float* __restrict__ r_p,
                 const float* __restrict__ dr_p, const float* __restrict__ k_p,
                 const float* __restrict__ l_p, const float* __restrict__ m_p,
                 const float* __restrict__ dm_p, const float* __restrict__ phi_p,
                 const float* __restrict__ dkk_p, const float* __restrict__ dll_p,
                 const float* __restrict__ area_p,
                 const unsigned char* __restrict__ act_p, int n,
                 float* __restrict__ dens_st, float* __restrict__ drr_st,
                 float* __restrict__ dmm_st, double* __restrict__ partials,
                 bool saturate_online, bool faithful) {
  __shared__ DepositTile tile;
  __shared__ float s_du[kMaxTable], s_dv[kMaxTable], s_rho[kMaxTable];
  const int n_flux = n_tab - 1;          // cells; also the shear table length
  for (int c = threadIdx.x; c < n_tab; c += kThreads) {
    s_rho[c] = rhobar[c];
    if (c < n_flux) {
      s_du[c] = du_dz[c];
      s_dv[c] = dv_dz[c];
    }
  }
  __syncthreads();

  const float g0c = params[0];
  const float dz = params[1];
  const float g0f = params[2];
  const float idz = 1.0f / dz;
  const float hi_c = g0c + (static_cast<float>(n_tab) - 1.0f) * dz;
  const float hi_f = g0f + (static_cast<float>(n_tab) - 2.0f) * dz;
  const int nzmax = n_flux - 1;

  __shared__ DepositAcc acc;
  acc.zero(n_flux);
  __syncthreads();
  const int n_tiles = (n + kThreads - 1) / kThreads;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int i = t * kThreads + threadIdx.x;
    bool live = false;
    int nlow = 0, nup = 0;
    float r_lo = 0.0f, r_up = 0.0f, fvk = 0.0f, fvl = 0.0f;
    if (i < n) {
      const float dens = dens_p[i], r = r_p[i], dr = dr_p[i];
      const float k = k_p[i], l = l_p[i], m = m_p[i], dm = dm_p[i];
      const float phi = phi_p[i];
      const bool act = act_p[i] != 0;

      // dispersion: one reciprocal + one rsqrt, as the Pallas kernel
      const float ff = 2.0f * kRotEarth * sinf(phi);
      const float kh2 = k * k + l * l;
      const float k2 = kh2 + m * m;
      const float ik2 = 1.0f / k2;
      const float om2 = (bvf * bvf * kh2 + ff * ff * m * m) * ik2;
      const float cgr = -m * (om2 - ff * ff) * rsqrtf(om2) * ik2;

      // flux deposit inputs (independent of the winds with hprop off)
      r_lo = r - 0.5f * dr;
      r_up = r + 0.5f * dr;
      live = cell_span(r_lo * idz, r_up * idz + 1.0f, nzmax, nlow, nup) && act;
      if (live) {
        const float pv = fabsf(dkk_p[i] * dll_p[i] * dm);
        const float fv = cgr * dens * idz;
        fvk = fv * k * pv;
        fvl = fv * l * pv;
      }

      // shears on the interior faces at r
      const float qf = (fminf(fmaxf(r, g0f), hi_f) - g0f) * idz;
      const float du = interp2(s_du, n_flux, qf);
      const float dv = interp2(s_dv, n_flux, qf);
      const float dmm = -(k * du + l * dv);

      float dst = 0.0f;
      if (saturate_online) {
        const float r_fin = r + cgr * dt;
        const float qr = (fminf(fmaxf(r_fin, g0c), hi_c) - g0c) * idz;
        const float rho = interp2(s_rho, n_tab, qr);
        const float m_fin = m + dmm * dt;
        const float dmm_fin = area_p[i] / dr;    // dr tendency = 0
        const float omh2 = (bvf * bvf * kh2 + f0 * f0 * m * m) * ik2;
        const float cap = kappa * kappa * 0.5f * rho * omh2 * rsqrtf(omh2) *
                          bvf * bvf / (m_fin * m_fin * (omh2 - f0 * f0));
        const float pvol = dkk_p[i] * dll_p[i] * dmm_fin;
        const float cap_applied = faithful ? cap : cap / pvol;
        if (cap < dens * pvol) dst = (cap_applied - dens) * (1.0f / dt);
      }
      dens_st[i] = act ? dst : 0.0f;
      drr_st[i] = act ? cgr : 0.0f;
      dmm_st[i] = act ? dmm : 0.0f;
    }
    deposit_stage(tile, live, nlow, nup, r_lo, r_up, fvk, fvl);
    __syncthreads();
    deposit_walk(tile, acc, g0c, dz);
    __syncthreads();
  }
  deposit_store(acc, partials, n_flux);
}

}  // namespace msgwam

extern "C" int msgwam_rhs_fused(
    const float* params, float dt, float bvf, float kappa, float f0,
    const float* du_dz, const float* dv_dz, const float* rhobar, int n_tab,
    const float* dens, const float* r, const float* dr, const float* k,
    const float* l, const float* m, const float* dm, const float* phi,
    const float* dkk, const float* dll, const float* area,
    const unsigned char* active, int n, float* dens_st, float* drr_st,
    float* dmm_st, float* flux, double* partials, int n_blocks,
    int saturate_online, int faithful, void* stream) {
  using namespace msgwam;
  if (n_tab < 3 || n_tab > kMaxTable || n_blocks < 1 || n_blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rhs_fused_kernel<<<n_blocks, kThreads, 0, s>>>(
      params, dt, bvf, kappa, f0, du_dz, dv_dz, rhobar, n_tab, dens, r, dr, k,
      l, m, dm, phi, dkk, dll, area, active, n, dens_st, drr_st, dmm_st,
      partials, saturate_online != 0, faithful != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_deposit_reduce(partials, n_blocks, n_tab - 1, flux, s));
}
