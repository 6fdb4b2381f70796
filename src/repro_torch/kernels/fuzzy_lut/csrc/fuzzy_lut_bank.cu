// Per-bank fuzzy-LUT kernel: tree descent + LUT gather-sum for one
// PegasusLinear bank, y[t, n] = sum_k lut[k, leaf_k(x[t, k]), n] (no bias).
//
// Replaces the Pallas kernel src/repro/kernels/fuzzy_lut/kernel.py
// fuzzy_lut_pallas (f32 LUT). The int8 instance (fuzzy_lut_q8_pallas) is
// fuzzy_lut_q8_bank.cu.
//
// What bounds it: bytes. Per row it reads K*v activations and writes N
// outputs; the work is K*d compares and K*N adds, far below the card's
// f32 rate. At the MLP-B banks (K <= 16, N <= 32, C = 64) the LUT is at
// most 128 KiB, so it stays in L2/L1 and the activation and output streams
// set the time; at serving batch sizes the launch itself dominates.
//
// Design: the TPU kernel fed its matrix unit with one-hot features and a
// one-hot x LUT matmul; here the gather-sum is the natural form, and the
// features arrive as int32 node ids. One block takes `rows` batch rows:
//   1. its threads walk the K trees of those rows (d steps each) and keep
//      the leaves in shared memory ([rows, K] ints),
//   2. each thread then owns (t, n) outputs, neighbouring threads taking
//      neighbouring n so the LUT row reads coalesce, and sums the K terms
//      in ascending k — the order of the plain version, so both give the
//      same bits.
// Ragged T and N edges are masked by the loop bounds, nothing is padded.

#include "fuzzy_lut.cuh"

template <typename LutT>
__global__ void __launch_bounds__(FUZZY_LUT_THREADS)
fuzzy_lut_bank_kernel(const float* __restrict__ x,      // [T, K, v]
                      const int* __restrict__ feat,     // [K, I]
                      const float* __restrict__ thr,    // [K, I]
                      const LutT* __restrict__ lut,     // [K, C, N]
                      const float* __restrict__ scales, // [K] (int8 only)
                      float* __restrict__ y,            // [T, N]
                      int* __restrict__ leaves,         // [T, K] or null
                      int T, int K, int v, int depth, int N, int rows) {
  extern __shared__ int s_leaf[];                       // [rows, K]
  const int n_internal = (1 << depth) - 1;
  const int C = n_internal + 1;
  const int t0 = blockIdx.x * rows;
  const int nrows = min(rows, T - t0);

  for (int i = threadIdx.x; i < nrows * K; i += blockDim.x) {
    const int t = i / K;
    const int k = i - t * K;
    const size_t row = static_cast<size_t>(t0 + t);
    const int leaf = fuzzy_tree_leaf(x + (row * K + k) * v,
                                     feat + static_cast<size_t>(k) * n_internal,
                                     thr + static_cast<size_t>(k) * n_internal,
                                     depth);
    s_leaf[i] = leaf;
    if (leaves != nullptr) leaves[row * K + k] = leaf;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nrows * N; i += blockDim.x) {
    const int t = i / N;
    const int n = i - t * N;
    const int* lt = s_leaf + t * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float s = scales != nullptr ? __ldg(scales + k) : 1.f;
      acc += fuzzy_lut_term<LutT>(
          lut + (static_cast<size_t>(k) * C + lt[k]) * N + n, s);
    }
    y[static_cast<size_t>(t0 + t) * N + n] = acc;
  }
}

template <typename LutT>
static int launch_bank(const float* x, const int* feat, const float* thr,
                       const LutT* lut, const float* scales, float* y,
                       int* leaves, int T, int K, int v, int depth, int N,
                       int rows, void* stream) {
  const int grid = (T + rows - 1) / rows;
  const size_t smem = static_cast<size_t>(rows) * K * sizeof(int);
  fuzzy_lut_bank_kernel<LutT>
      <<<grid, FUZZY_LUT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          x, feat, thr, lut, scales, y, leaves, T, K, v, depth, N, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fuzzy_lut_f32(const float* x, const int* feat, const float* thr,
                             const float* lut, float* y, int* leaves, int T,
                             int K, int v, int depth, int N, int rows,
                             void* stream) {
  return launch_bank<float>(x, feat, thr, lut, nullptr, y, leaves, T, K, v,
                            depth, N, rows, stream);
}
