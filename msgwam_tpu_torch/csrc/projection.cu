// K1: ray -> grid flux deposit on Hopper.
//
// Replaces msgwam_tpu/ops/projection_pallas.py:_kernel (entry points
// _project_pallas / project_pallas), the projection_backend="pallas"
// deposit.  Same arithmetic as the Pallas kernel: cell indices from the
// *division* r/dz, faces rebuilt as g0 + c dz, weight
// |overlap| / dz * phase_vol, contracted with two value rows.
//
// What bounds it on the H100: per ray it reads 5 f32 fields and one mask
// byte (21 B); the output is (2, n_cells).  At 1e6 rays that is 21 MB, about
// 6 us at 3.35 TB/s.  The cell walk (deposit.cuh) gives each touched cell of
// a 256-ray tile up to 32 lanes, so a tile whose rays sit in a few cells
// costs a few short loops and a shuffle tree.  The design reads each field
// once, coalesced, keeps the block's float64 sums in shared memory across
// its tiles, and leaves one (blocks, 2, n_cells) float64 partial (at most
// 1.7 MB) for the second pass.  The TPU kernel summed across its sequential
// grid in plain f32; here the partials are float64, so the deposit is
// accurate to ~1e-7 of its maximum at any ray count.
#include "deposit.cuh"

namespace msgwam {

__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
               const float* __restrict__ r_low, const float* __restrict__ r_up,
               const float* __restrict__ phase_vol,
               const unsigned char* __restrict__ valid,
               const float* __restrict__ grid, int n, int n_cells,
               double* __restrict__ partials) {
  __shared__ DepositTile tile;
  const float g0 = grid[0];
  const float dz = grid[1] - grid[0];
  const int nzmax = n_cells - 1;
  __shared__ DepositAcc acc;
  acc.zero(n_cells);
  __syncthreads();
  const int n_tiles = (n + kThreads - 1) / kThreads;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int i = t * kThreads + threadIdx.x;
    bool live = false;
    int nlow = 0, nup = 0;
    float lo = 0.0f, hi = 0.0f, a0 = 0.0f, a1 = 0.0f;
    if (i < n) {
      lo = r_low[i];
      hi = r_up[i];
      live = cell_span(lo / dz, hi / dz + 1.0f, nzmax, nlow, nup) &&
             (valid == nullptr || valid[i] != 0);
      if (live) {
        const float s = phase_vol[i] / dz;
        a0 = v0[i] * s;
        a1 = v1[i] * s;
      }
    }
    deposit_stage(tile, live, nlow, nup, lo, hi, a0, a1);
    __syncthreads();
    deposit_walk(tile, acc, g0, dz);
    __syncthreads();
  }
  deposit_store(acc, partials, n_cells);
}

}  // namespace msgwam

extern "C" int msgwam_project(const float* v0, const float* v1,
                              const float* r_low, const float* r_up,
                              const float* phase_vol,
                              const unsigned char* valid, const float* grid,
                              int n, int n_cells, float* out,
                              double* partials, int n_blocks, void* stream) {
  using namespace msgwam;
  if (n_cells < 1 || n_cells > kMaxCells || n_blocks < 1 ||
      n_blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  project_kernel<<<n_blocks, kThreads, 0, s>>>(v0, v1, r_low, r_up, phase_vol,
                                               valid, grid, n, n_cells,
                                               partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_deposit_reduce(partials, n_blocks, n_cells,
                                                out, s));
}
