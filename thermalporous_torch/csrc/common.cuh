// Shared helpers of the thermalporous_torch CUDA kernels: grid extents and
// strides of a C-contiguous 2D/3D cell array, and the launch shape.
#pragma once

#include <cuda_runtime.h>

namespace tp {

constexpr int kThreads = 256;

// Extents of the cell grid (ext[2] = 1 in 2D) and row-major strides.  A
// field with leading channels is laid out as channel * n + cell.
struct Dims {
  long n;
  int dim;
  int ext[3];
  long stride[3];

  __device__ __forceinline__ void coords(long c, int idx[3]) const {
    idx[2] = (int)(c % ext[2]);
    long r = c / ext[2];
    idx[1] = (int)(r % ext[1]);
    idx[0] = (int)(r / ext[1]);
  }
};

inline Dims make_dims(int dim, int n0, int n1, int n2) {
  Dims d;
  d.dim = dim;
  d.ext[0] = n0;
  d.ext[1] = n1;
  d.ext[2] = dim == 3 ? n2 : 1;
  d.stride[2] = 1;
  d.stride[1] = d.ext[2];
  d.stride[0] = (long)d.ext[1] * d.ext[2];
  d.n = (long)n0 * d.stride[0];
  return d;
}

inline unsigned blocks_for(long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace tp
