// What the persistent kernels size themselves by: the card's limits, and a
// probe of its two barriers that are wider than a block.
//
// The fused coarse subtree and the Chebyshev smooth (deep_cycle.cu,
// stencil.cu) are single cooperative launches whose passes are separated by
// grid-wide barriers, so their least time is a number of barriers times the
// barrier's latency.  tp_barrier_probe runs a kernel that does nothing but
// `iters` barriers, either cooperative_groups' grid.sync() over `blocks`
// co-resident blocks or cluster.sync() over one thread-block cluster of
// `blocks` blocks; timed from the host at two values of `iters`, the
// difference over the count is the latency of one barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace tp {

__global__ void grid_barrier_probe(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

__global__ void cluster_barrier_probe(int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cluster.sync();
}

}  // namespace tp

extern "C" {

// The number of SMs and the largest dynamic shared memory a block may opt in
// to, of CUDA device `device`.
int tp_device_limits(int device, int* sms, int* smem_optin) {
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                     device);
}

// kind 0: `iters` grid barriers over `blocks` blocks (cooperative launch);
// kind 1: `iters` cluster barriers in one cluster of `blocks` blocks (more
// than 8 need the non-portable cluster size).
int tp_barrier_probe(int kind, int blocks, int threads, int iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    void* args[] = {&iters};
    return (int)cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&tp::grid_barrier_probe), dim3(blocks),
        dim3(threads), args, 0, st);
  }
  if (blocks > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        tp::cluster_barrier_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, tp::cluster_barrier_probe, iters);
}

}  // extern "C"
