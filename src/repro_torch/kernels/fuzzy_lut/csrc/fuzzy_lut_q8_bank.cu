// Per-bank int8 fuzzy-LUT kernel: y[t, n] = sum_k s_k * lut[k, leaf_k(x[t, k]), n]
// (no bias) for one PegasusLinear bank.
//
// Replaces the Pallas kernel src/repro/kernels/fuzzy_lut/quantized.py
// fuzzy_lut_q8_pallas. It is the one-layer case of the kernel in
// fuzzy_lut_q8.cuh, which holds the design notes: the bank's trees,
// scales and int8 LUT staged into shared memory by bulk async copies
// (column tiles when the LUT is wider than a ring slot), one warp per row.

#include "fuzzy_lut_q8.cuh"

extern "C" int fuzzy_lut_q8(const float* x, const int* feat, const float* thr,
                            const int8_t* lut, const float* scales, float* y,
                            int* leaves, const int* stages, int T, Q8Geom g,
                            int grid, int threads, int smem, void* stream) {
  return q8_launch<false>(x, feat, thr, lut, scales, nullptr, y, leaves,
                          stages, T, g, grid, threads, smem, stream);
}
