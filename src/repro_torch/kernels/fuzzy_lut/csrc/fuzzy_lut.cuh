// Shared device code of the fuzzy-LUT kernels: the heap-tree descent and
// one LUT term of the gather-sum. Both kernel sources include it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Threads per block for every fuzzy-LUT kernel.
#define FUZZY_LUT_THREADS 256

// Depth-`depth` heap walk of one tree over one group of activations `xg`
// (generic pointer: global memory for a bank, shared memory for a stack).
// node <- 2*node + 1 + (xg[feat[node]] > thr[node]); a +inf threshold
// always goes left. Returns the leaf index node - (2^depth - 1).
__device__ __forceinline__ int fuzzy_tree_leaf(const float* xg,
                                               const int* __restrict__ feat,
                                               const float* __restrict__ thr,
                                               int depth) {
  int node = 0;
  for (int d = 0; d < depth; ++d) {
    const float val = xg[__ldg(feat + node)];
    node = 2 * node + 1 + (val > __ldg(thr + node) ? 1 : 0);
  }
  return node - ((1 << depth) - 1);
}

// One term of the gather-sum. f32 tables are read as they are; int8 codes
// are widened and scaled by the group's factor with an explicitly rounded
// multiply, so the compiler cannot fuse it with the running add: the term
// is bit-equal to the plain version's float(q) * s.
template <typename LutT>
__device__ __forceinline__ float fuzzy_lut_term(const LutT* p, float scale);

template <>
__device__ __forceinline__ float fuzzy_lut_term<float>(const float* p, float) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float fuzzy_lut_term<int8_t>(const int8_t* p,
                                                        float scale) {
  return __fmul_rn(static_cast<float>(__ldg(p)), scale);
}
