// Stacked fuzzy-LUT kernel: L fused PegasusLinear banks in one launch.
// Per layer l: tree descent, LUT gather-sum, + bias[l], then the output
// [rows, N] is re-partitioned into the next layer's [rows, ks[l+1], v]
// groups. Returns y [T, n_out] with every bias applied.
//
// Replaces the Pallas kernel src/repro/kernels/fuzzy_lut/kernel.py
// fuzzy_lut_stack_pallas (f32 LUT stack). The int8 instance
// (fuzzy_lut_stack_q8_pallas) is fuzzy_lut_q8_stack.cu.
//
// What bounds it: bytes, and below them the launch. The function must read
// x [T, K0, v] and the operand stacks once and write y [T, n_out]; the work
// is sum_l ks[l]*(d compares + N_l adds) per row. For MLP-B at T = 4096
// that is ~0.85 MB in all, about a quarter of a microsecond of HBM time.
//
// Design: the TPU kernel kept the whole operand stack resident in VMEM.
// The f32 MLP-B stack is 512 KiB, more than a block's 227 KB of shared
// memory, so here the LUT is read through L1/L2 (it stays hot across
// blocks) and only the activations live on chip:
//   * a block takes `rows` batch rows and keeps their activations
//     h [rows, width] in shared memory across all L layers, where
//     width = max(K0*v, Nmax);
//   * the re-partition is only an index — group k of layer l+1 reads
//     h[t, k*v + f] — so no data moves between layers;
//   * each layer computes only what is used: groups k < ks[l] (padded
//     groups hold +inf thresholds and zero rows, so skipping them is
//     exact) and columns n < ks[l+1]*v (n_out on the last layer);
//   * the sum runs in ascending k, then + bias, as in the plain version.
// ks, L and n_out travel by value in StackGeom (at most MAX_L layers).

#include "fuzzy_lut.cuh"

#define MAX_L 16

struct StackGeom {
  int L;       // number of stacked layers (<= MAX_L)
  int k0;      // groups of the input x
  int kmax;    // padded group count of the operand stacks
  int nmax;    // padded output width of the operand stacks
  int n_out;   // true output width of the last layer
  int v;       // group width
  int depth;   // tree depth d, C = 2^d
  int width;   // shared activation row width, max(k0*v, nmax)
  int ks[MAX_L];
};

template <typename LutT>
__global__ void __launch_bounds__(FUZZY_LUT_THREADS)
fuzzy_lut_stack_kernel(const float* __restrict__ x,      // [T, K0, v]
                       const int* __restrict__ feat,     // [L, Kmax, I]
                       const float* __restrict__ thr,    // [L, Kmax, I]
                       const LutT* __restrict__ lut,     // [L, Kmax, C, Nmax]
                       const float* __restrict__ scales, // [L, Kmax] (int8)
                       const float* __restrict__ bias,   // [L, Nmax]
                       float* __restrict__ y,            // [T, n_out]
                       int* __restrict__ leaves,         // [L, T, Kmax] or null
                       int T, StackGeom g, int rows) {
  extern __shared__ float smem[];
  float* h = smem;                                        // [rows, width]
  int* s_leaf = reinterpret_cast<int*>(smem + rows * g.width);  // [rows, kmax]
  const int n_internal = (1 << g.depth) - 1;
  const int C = n_internal + 1;
  const int t0 = blockIdx.x * rows;
  const int nrows = min(rows, T - t0);

  const int in_w = g.k0 * g.v;
  for (int i = threadIdx.x; i < nrows * in_w; i += blockDim.x) {
    const int t = i / in_w;
    const int c = i - t * in_w;
    h[t * g.width + c] = x[static_cast<size_t>(t0 + t) * in_w + c];
  }
  __syncthreads();

  for (int l = 0; l < g.L; ++l) {
    const int K = g.ks[l];
    const bool last = (l + 1 == g.L);
    const int n_eff = last ? g.n_out : g.ks[l + 1] * g.v;
    const size_t lk = static_cast<size_t>(l) * g.kmax;
    const int* feat_l = feat + lk * n_internal;
    const float* thr_l = thr + lk * n_internal;
    const LutT* lut_l = lut + lk * C * g.nmax;

    for (int i = threadIdx.x; i < nrows * K; i += blockDim.x) {
      const int t = i / K;
      const int k = i - t * K;
      const int leaf = fuzzy_tree_leaf(h + t * g.width + k * g.v,
                                       feat_l + k * n_internal,
                                       thr_l + k * n_internal, g.depth);
      s_leaf[t * g.kmax + k] = leaf;
      if (leaves != nullptr)
        leaves[(static_cast<size_t>(l) * T + t0 + t) * g.kmax + k] = leaf;
    }
    __syncthreads();

    // Every read of h in this layer happened before the barrier above, so
    // the outputs may overwrite it in place.
    for (int i = threadIdx.x; i < nrows * n_eff; i += blockDim.x) {
      const int t = i / n_eff;
      const int n = i - t * n_eff;
      const int* lt = s_leaf + t * g.kmax;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const float s = scales != nullptr ? __ldg(scales + lk + k) : 1.f;
        acc += fuzzy_lut_term<LutT>(
            lut_l + (static_cast<size_t>(k) * C + lt[k]) * g.nmax + n, s);
      }
      acc += __ldg(bias + static_cast<size_t>(l) * g.nmax + n);
      if (last) {
        y[static_cast<size_t>(t0 + t) * g.n_out + n] = acc;
      } else {
        h[t * g.width + n] = acc;
      }
    }
    __syncthreads();
  }
}

template <typename LutT>
static int launch_stack(const float* x, const int* feat, const float* thr,
                        const LutT* lut, const float* scales, const float* bias,
                        float* y, int* leaves, int T, StackGeom g, int rows,
                        void* stream) {
  const int grid = (T + rows - 1) / rows;
  const size_t smem =
      static_cast<size_t>(rows) * (g.width + g.kmax) * sizeof(float);
  fuzzy_lut_stack_kernel<LutT>
      <<<grid, FUZZY_LUT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          x, feat, thr, lut, scales, bias, y, leaves, T, g, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fuzzy_lut_stack_f32(const float* x, const int* feat,
                                   const float* thr, const float* lut,
                                   const float* bias, float* y, int* leaves,
                                   int T, StackGeom g, int rows, void* stream) {
  return launch_stack<float>(x, feat, thr, lut, nullptr, bias, y, leaves, T, g,
                             rows, stream);
}
