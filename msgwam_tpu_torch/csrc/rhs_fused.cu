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
// Pallas kernel.  The per-ray body is ray_physics.cuh, shared with K3-K5.
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
#include "ray_physics.cuh"

namespace msgwam {

constexpr int kMaxTable = kMaxCells + 1;   // centers: n_flux_cells + 1

__global__ void __launch_bounds__(kThreads)
rhs_fused_kernel(const float* __restrict__ params, float dt, float bvf,
                 float kappa, float f0, const float* __restrict__ du_dz,
                 const float* __restrict__ dv_dz,
                 const float* __restrict__ rhobar, int n_tab, RayFields f,
                 int n, float* __restrict__ dens_st, float* __restrict__ drr_st,
                 float* __restrict__ dmm_st, double* __restrict__ partials,
                 bool saturate_online, bool faithful) {
  __shared__ DepositTile tile;
  __shared__ float s_du[kMaxTable], s_dv[kMaxTable], s_rho[kMaxTable];
  const Geometry g(params[0], params[1], params[2], n_tab);
  for (int c = threadIdx.x; c < n_tab; c += kThreads) {
    s_rho[c] = rhobar[c];
    if (c < g.n_flux) {
      s_du[c] = du_dz[c];
      s_dv[c] = dv_dz[c];
    }
  }
  __syncthreads();

  __shared__ DepositAcc acc;
  acc.zero(g.n_flux);
  __syncthreads();
  const int n_tiles = (n + kThreads - 1) / kThreads;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int i = t * kThreads + threadIdx.x;
    RayTerms rt;
    if (i < n) {
      const Ray y = load_ray(f, i);
      rt = ray_terms(y, g, dt, bvf);
      const float du = interp2(s_du, g.n_flux, rt.qf);
      const float dv = interp2(s_dv, g.n_flux, rt.qf);
      const float rho = saturate_online ? interp2(s_rho, n_tab, rt.qr) : 0.0f;
      const Tendencies td = ray_tendencies(y, rt, du, dv, rho, dt, bvf, kappa,
                                           f0, saturate_online, faithful);
      dens_st[i] = td.dens;
      drr_st[i] = td.r;
      dmm_st[i] = td.m;
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
  const RayFields f{dens, r, dr, k, l, m, dm, phi, dkk, dll, area, active};
  rhs_fused_kernel<<<n_blocks, kThreads, 0, s>>>(
      params, dt, bvf, kappa, f0, du_dz, dv_dz, rhobar, n_tab, f, n, dens_st,
      drr_st, dmm_st, partials, saturate_online != 0, faithful != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_deposit_reduce(partials, n_blocks, n_tab - 1, flux, s));
}
