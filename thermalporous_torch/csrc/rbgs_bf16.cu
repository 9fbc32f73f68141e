// The red-black stage 2 and half-sweep (rbgs.cuh) with bf16 coefficients
// (CPRConfig.pc_dtype), for float and double vectors: their own compilation
// unit, built in parallel with rbgs.cu.

#include "rbgs.cuh"

namespace tp {

template int stage2_typed<float, bf16>(int, const void*, const void*, const void*,
                                       const void*, void*, int, int, const Stage2Plan&,
                                       int, int, cudaStream_t);
template int stage2_typed<double, bf16>(int, const void*, const void*, const void*,
                                        const void*, void*, int, int, const Stage2Plan&,
                                        int, int, cudaStream_t);
template int half_typed<float, bf16>(const void*, const void*, const void*, const void*,
                                     void*, int, int, int, const Dims&, cudaStream_t);
template int half_typed<double, bf16>(const void*, const void*, const void*, const void*,
                                      void*, int, int, int, const Dims&, cudaStream_t);

}  // namespace tp
