// Per-bank f32 fuzzy-LUT kernel: y[t, n] = sum_k lut[k, leaf_k(x[t, k]), n]
// (no bias) for one PegasusLinear bank.
//
// Replaces the Pallas kernel src/repro/kernels/fuzzy_lut/kernel.py
// fuzzy_lut_pallas. It is the one-layer case of the kernel in
// fuzzy_lut_f32.cuh, which holds the design notes: one warp per row, the
// row's activations in registers, the trees node-major in shared memory,
// the selected LUT rows read through L1 with every term of a column in
// flight before the ordered adds.

#define F32_KERNEL fuzzy_lut_f32_bank_kernel
#include "fuzzy_lut_f32.cuh"

extern "C" int fuzzy_lut_f32(const float* x, const int* feat, const float* thr,
                             const float* lut, float* y, int* leaves, int T,
                             F32Geom g, int grid, int threads, int smem,
                             void* stream) {
  return f32_launch(x, feat, thr, lut, nullptr, y, leaves, T, g, grid, threads,
                    smem, stream);
}
