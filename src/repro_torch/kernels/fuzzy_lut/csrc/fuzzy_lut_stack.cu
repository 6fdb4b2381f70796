// Stacked f32 fuzzy-LUT kernel: L fused PegasusLinear banks in one launch.
// Per layer l: tree descent, LUT gather-sum (ascending k), + bias[l]; the
// output [ks[l+1]*v] of a row is the next layer's input, read in place as
// [ks[l+1], v] groups. Returns y [T, n_out].
//
// Replaces the Pallas kernel src/repro/kernels/fuzzy_lut/kernel.py
// fuzzy_lut_stack_pallas. The design notes are in fuzzy_lut_f32.cuh: one
// warp per row for all L layers with the row in registers (output column
// n in lane n is the next layer's h[n]), every layer's trees copied
// node-major into shared memory at the start, one commit group per layer,
// so later layers' trees land while earlier layers compute.

#define F32_KERNEL fuzzy_lut_f32_stack_kernel
#include "fuzzy_lut_f32.cuh"

extern "C" int fuzzy_lut_stack_f32(const float* x, const int* feat,
                                   const float* thr, const float* lut,
                                   const float* bias, float* y, int* leaves,
                                   int T, F32Geom g, int grid, int threads,
                                   int smem, void* stream) {
  return f32_launch(x, feat, thr, lut, bias, y, leaves, T, g, grid, threads,
                    smem, stream);
}
