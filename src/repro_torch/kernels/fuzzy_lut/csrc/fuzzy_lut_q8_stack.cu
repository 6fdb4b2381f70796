// Stacked int8 fuzzy-LUT kernel: L fused PegasusLinear banks in one launch.
// Per layer l: tree descent, int8 LUT gather-sum (s_k * q, ascending k),
// + bias[l]; the output [rows, ks[l+1]*v] is the next layer's input, read
// in place as [rows, ks[l+1], v] groups. Returns y [T, n_out].
//
// Replaces the Pallas kernel src/repro/kernels/fuzzy_lut/quantized.py
// fuzzy_lut_stack_q8_pallas. The design notes are in fuzzy_lut_q8.cuh:
// each layer's operands staged into a two-slot shared-memory ring by bulk
// async copies while the previous layer computes, persistent blocks that
// walk the layers in their outer loop, one warp per row.

#include "fuzzy_lut_q8.cuh"

extern "C" int fuzzy_lut_stack_q8(const float* x, const int* feat,
                                  const float* thr, const int8_t* lut,
                                  const float* scales, const float* bias,
                                  float* y, int* leaves, const int* stages,
                                  int T, Q8Geom g, int grid, int threads,
                                  int smem, void* stream) {
  return q8_launch<true>(x, feat, thr, lut, scales, bias, y, leaves, stages,
                         T, g, grid, threads, smem, stream);
}
