// Probe: does the H100 accept a cooperative launch with a thread-block
// cluster dimension, and what do cluster.sync() and grid.sync() cost?
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o sync_probe tools/cuda_sync_probe.cu && ./sync_probe
//
// For clusters of 8 and 16 blocks of 256 threads (8 KB and 44,800 B of
// dynamic shared memory) it prints the occupancy API's active clusters, the
// error of a cooperative cluster launch of up to 400 blocks, the cycles of
// one cluster.sync() and one grid.sync() (100 in a row, thread 0 of block
// 0), and a distributed-shared-memory read; then grid.sync() in plain
// cooperative launches of 391 and 528 blocks (the whole-run kernel's grids
// at 1e5 and 1e6 rays).
#include <cstdio>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void __launch_bounds__(256, 4) k(int* out, int iters) {
  extern __shared__ double dsm[];
  cg::cluster_group cl = cg::this_cluster();
  cg::grid_group grid = cg::this_grid();
  dsm[threadIdx.x] = blockIdx.x;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) cl.sync();
  long long t1 = clock64();
  double* remote = cl.map_shared_rank(dsm, (cl.block_rank() + 1) % cl.num_blocks());
  double v = remote[threadIdx.x];
  cl.sync();
  long long t2 = clock64();
  for (int i = 0; i < iters; ++i) grid.sync();
  long long t3 = clock64();
  if (threadIdx.x == 0) { out[blockIdx.x * 4] = (int)((t1 - t0) / iters); out[blockIdx.x * 4 + 1] = (int)v; out[blockIdx.x * 4 + 2] = (int)((t3 - t2) / iters); out[blockIdx.x*4+3] = cl.num_blocks(); }
}
int main() {
  int* out; cudaMalloc(&out, 4096 * 16);
  for (int cs : {8, 16}) {
    for (int smem : {8192, 44800}) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 46000);
      if (cs > 8) cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      cudaLaunchConfig_t cfg = {};
      int nclusters = 0;
      cudaLaunchAttribute attr[2];
      attr[0].id = cudaLaunchAttributeClusterDimension; attr[0].val.clusterDim.x = cs; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
      attr[1].id = cudaLaunchAttributeCooperative; attr[1].val.cooperative = 1;
      cfg.blockDim = dim3(256); cfg.dynamicSmemBytes = smem; cfg.attrs = attr; cfg.numAttrs = 1;
      cfg.gridDim = dim3(cs);
      cudaError_t e0 = cudaOccupancyMaxActiveClusters(&nclusters, (void*)k, &cfg);
      int grid = (nclusters * cs < 400 ? nclusters * cs : 400 / cs * cs);
      cfg.gridDim = dim3(grid); cfg.numAttrs = 2;
      cudaError_t e1 = cudaLaunchKernelEx(&cfg, k, out, 100);
      cudaError_t e2 = cudaDeviceSynchronize();
      int h[16]; cudaMemcpy(h, out, 64, cudaMemcpyDeviceToHost);
      printf("cluster %d smem %d: maxActiveClusters=%d (err %d) grid %d launch coop+cluster err %d (%s) sync err %d; cluster.sync cycles %d, dsmem read %d, grid.sync cycles %d, nblocks %d\n",
             cs, smem, nclusters, (int)e0, grid, (int)e1, cudaGetErrorString(e1), (int)e2, h[0], h[1], h[2], h[3]);
      cudaGetLastError();
    }
  }
  // plain cooperative launch grid.sync cost at 391 and 528 blocks
  for (int nb : {391, 528}) {
    void* args[] = {&out, nullptr};
    int iters = 100; args[1] = &iters;
    cudaError_t e = cudaLaunchCooperativeKernel((void*)k, dim3(nb), dim3(256), args, 8192, 0);
    cudaDeviceSynchronize();
    int h[16]; cudaMemcpy(h, out, 64, cudaMemcpyDeviceToHost);
    printf("coop %d: err %d, grid.sync cycles %d\n", nb, (int)e, h[2]);
    cudaGetLastError();
  }
  return 0;
}
