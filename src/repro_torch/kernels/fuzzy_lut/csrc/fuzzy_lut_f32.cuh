// f32 fuzzy-LUT kernel for Hopper, shared by the per-bank entry
// (fuzzy_lut_bank.cu, one layer, no bias) and the stacked entry
// (fuzzy_lut_stack.cu, L layers with bias). Each source defines F32_KERNEL,
// the name of its __global__ entry, before it includes this header, so a
// device trace names the per-bank launches (fuzzy_lut_f32_bank_kernel) and
// the stacked ones (fuzzy_lut_f32_stack_kernel) apart over one body.
//
// Replaces the Pallas kernels src/repro/kernels/fuzzy_lut/kernel.py
// fuzzy_lut_pallas and fuzzy_lut_stack_pallas.
//
// What bounds it: latency and instruction issue. The bytes (activations
// in, outputs out, the trees once per block and the LUT rows the leaves
// select) are a fraction of a microsecond of HBM time at the MLP-B shapes;
// what costs is each tree's chain of d dependent compares, each output's K
// LUT terms, and the instructions around them (32 warps share an SM's four
// schedulers). The design keeps the compare chain on chip, puts every LUT
// term of a column in flight at once, and spends two instructions per term:
//   * One warp per row, for the whole launch. Lane k walks tree k; lane n
//     computes output column n (columns beyond 32 in chunks of 32). After
//     the prologue a block passes no barrier: the warp's own __syncwarp
//     and __shfl_sync are the only synchronisation.
//   * Activations in registers where a row fits a warp (every layer's
//     K*v <= 32, all of MLP-B): lane c holds h[c], the descent reads
//     h[k*v + f] by shuffle, and the output column n in lane n already is
//     the next layer's h[n], so the re-partition moves no data. Wider rows
//     keep a per-warp row in shared memory (a lone layer reads its input
//     row from global memory).
//   * Trees node-major in shared memory. The public layout is [K, I]. In
//     the prologue the block copies every layer's features and thresholds
//     as they lie, with coalesced 4-byte cp.async, while each warp loads
//     its row; then it transposes them, a warp per node row, into one
//     8-byte {feature, threshold} word per node at [I, kpad] (kpad =
//     groups rounded up to 16). Lane k's read of node node_k is then
//     conflict-free, and so is the transpose: its lanes read over k at one
//     node, I = 2^d - 1 words apart (odd), and write consecutive words.
//     (Copying element by element straight into [I, kpad] puts a warp's 32
//     writes kpad words apart, in one bank; staging layer by layer cost two
//     barriers and a transpose per layer.) Where the trees and the rows do
//     not fit the block's shared memory, the descent reads the [K, I]
//     layout through L1 instead (the launch planner, kernel.py: plan_f32,
//     decides).
//   * The LUT is never staged: only the rows the leaves select cross,
//     through L1 (ld.global.nc), one coalesced load per (k, 32 columns).
//     Lane k writes its group's LUT row k*C + leaf into a per-warp row in
//     shared memory (padded groups to row 0); the gather reads them as
//     int4 broadcasts, so each term is one address multiply-add and one
//     load, unpredicated. All F32_CHUNK loads of a column are issued before
//     the first add; the adds run acc + term in ascending k, then + bias:
//     the plain version's order, so the bits are equal. (A shuffle per
//     term, with its divergence check, made the gather five times slower
//     than the memory system's own round trip on the card.)
//   * Blocks of one warp per row, up to 32 rows; the launch sizes them so
//     that the MLP-B bucket-4096 batch fills the card in one wave (128
//     blocks of 32 rows on 132 SMs).
#pragma once

#ifndef F32_KERNEL
#error "define F32_KERNEL, the name of the entry's __global__ function, before the include"
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#define F32_MAX_L 16        // layers of a stack (kernel.py: _lib.MAX_L)
#define F32_MAX_THREADS 1024
#define F32_CHUNK 16        // LUT loads issued before the first add
#define F32_FULL 0xffffffffu

struct F32Geom {
  int L;        // layers (1 for a bank)
  int k0;       // groups of the input x
  int kmax;     // padded group count of the operand stacks
  int nmax;     // padded output width of the operand stacks
  int n_out;    // true output width of the last layer
  int v;        // group width
  int depth;    // tree depth d, C = 2^d
  int kpad;     // node-major tree row pitch in shared memory (0: trees through L1)
  int regs;     // 1: a row's activations in registers, lane c holding h[c]
  int width;    // per-warp activation row in shared memory, floats (0: none)
  int kstride;  // per-warp row of LUT row indices in shared memory, ints
                //   (the largest group count rounded up to F32_CHUNK)
  int ks[F32_MAX_L];
};

__device__ __forceinline__ void f32_cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

// The block copies the K trees [K, I] of one layer as they lie into `raw`
// (features, then thresholds). 16-byte copies measured no faster.
__device__ __forceinline__ void f32_copy_trees(int* raw, const int* feat_l,
                                               const float* thr_l, int K, int I) {
  for (int i = threadIdx.x; i < K * I; i += blockDim.x) {
    f32_cp4(raw + i, feat_l + i);
    f32_cp4(raw + K * I + i, thr_l + i);
  }
}

// The block transposes `raw` into node-major {feature, threshold} words
// [I, kpad] in `tree`: lane k walks tree k's nodes, a warp per node row.
// (A node loop outside the k loop compiled to some 40 dependent
// instructions per row.)
__device__ __forceinline__ void f32_transpose_trees(int2* tree, const int* raw,
                                                    int K, int I, int kpad) {
  const int nwarps = blockDim.x >> 5;
  for (int k = threadIdx.x & 31; k < K; k += 32) {
    const int* rf = raw + k * I;
    const int* rt = rf + K * I;
    int2* t = tree + k;
    for (int node = threadIdx.x >> 5; node < I; node += nwarps)
      t[node * kpad] = make_int2(rf[node], rt[node]);
  }
}

// Node `node` of tree k as {feature, threshold bits}: from the node-major
// words in shared memory, or from the [K, I] layout through L1.
template <bool kTrees>
__device__ __forceinline__ int2 f32_tree_word(const int2* tr, const int* feat_l,
                                              const float* thr_l, int node, int k,
                                              int I, int kpad) {
  if (kTrees) return tr[node * kpad + k];
  return make_int2(__ldg(feat_l + k * I + node),
                   __float_as_int(__ldg(thr_l + k * I + node)));
}

// The geometry is a __grid_constant__ parameter: g.ks[l] is then one
// indexed constant load (without it, indexing the by-value array at run
// time copies the geometry to local memory, and an unrolled select costs a
// chain of 16 predicated loads per read).
template <bool kTrees, bool kRegs>
__global__ void __launch_bounds__(F32_MAX_THREADS, 1)
F32_KERNEL(const float* __restrict__ x,      // [T, K0, v]
           const int* __restrict__ feat,     // [L, Kmax, I]
           const float* __restrict__ thr,    // [L, Kmax, I]
           const float* __restrict__ lut,    // [L, Kmax, C, Nmax]
           const float* __restrict__ bias,   // [L, Nmax] or null
           float* __restrict__ y,            // [T, n_out]
           int* __restrict__ leaves,         // [L, T, Kmax] or null
           int T, const __grid_constant__ F32Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = g.L;
  const int I = (1 << g.depth) - 1;
  const int C = I + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool active = row < T;
  const int in_w = g.k0 * g.v;

  // [L][I][kpad] tree words, their raw copies (L x 2*I*kpad ints), then
  // per warp h[width] and the LUT rows of its groups[kstride]
  int2* s_tree = reinterpret_cast<int2*>(smem);
  int* s_raw = reinterpret_cast<int*>(s_tree + L * I * g.kpad);
  float* h_s = reinterpret_cast<float*>(smem + (kTrees ? 16 * L * I * g.kpad : 0)) +
               warp * (g.width + g.kstride);
  int* s_row = reinterpret_cast<int*>(h_s + g.width);

  // the row first, so its load is in flight while the trees' copies issue
  float h = 0.f;            // kRegs: lane c holds h[c]
  const float* hr = h_s;    // else: the row in shared (or global) memory
  if (active) {
    const float* xr = x + static_cast<size_t>(row) * in_w;
    if (kRegs) {
      if (lane < in_w) h = xr[lane];
    } else if (g.width == 0) {
      hr = xr;
    } else {
      for (int c = lane; c < in_w; c += 32) h_s[c] = xr[c];
    }
  }

  // Every layer's trees. (Waiting for layer 0's alone, and for the others
  // behind a second barrier before layer 1, measured no faster: the copies
  // did not land sooner.)
  if (kTrees) {
    for (int l = 0; l < L; ++l) {
      const size_t lk = static_cast<size_t>(l) * g.kmax * I;
      f32_copy_trees(s_raw + 2 * l * I * g.kpad, feat + lk, thr + lk, g.ks[l], I);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int l = 0; l < L; ++l)
      f32_transpose_trees(s_tree + l * I * g.kpad, s_raw + 2 * l * I * g.kpad,
                          g.ks[l], I, g.kpad);
    __syncthreads();
  }
  if (!active) return;
  __syncwarp();

  for (int l = 0; l < L; ++l) {
    const int K = g.ks[l];
    const int kr = (K + F32_CHUNK - 1) / F32_CHUNK * F32_CHUNK;
    const bool last = l + 1 == L;
    const int n_eff = last ? g.n_out : g.ks[l + 1] * g.v;
    const size_t lk = static_cast<size_t>(l) * g.kmax;
    const int2* tr = s_tree + l * I * g.kpad;
    const int* feat_l = feat + lk * I;
    const float* thr_l = thr + lk * I;
    int* lv = leaves == nullptr ? nullptr
        : leaves + (static_cast<size_t>(l) * T + row) * g.kmax;

    // Descent: node <- 2*node + 1 + (h[k*v + feat] > thr); a +inf
    // threshold always goes left. s_row[k] <- k*C + leaf, padded groups
    // up to a multiple of F32_CHUNK <- 0.
    int leaf = 0;
    if (kRegs) {
      const int k = lane < K ? lane : 0;
      int node = 0;
      for (int d = 0; d < g.depth; ++d) {
        const int2 w = f32_tree_word<kTrees>(tr, feat_l, thr_l, node, k, I, g.kpad);
        const float val = __shfl_sync(F32_FULL, h, k * g.v + w.x);
        node = 2 * node + 1 + (val > __int_as_float(w.y) ? 1 : 0);
      }
      leaf = node - I;
      if (lane < kr) s_row[lane] = lane < K ? lane * C + leaf : 0;
      if (lv != nullptr && lane < K) lv[lane] = leaf;
    } else {
      for (int k = lane; k < kr; k += 32) {
        if (k >= K) {
          s_row[k] = 0;
          continue;
        }
        const float* xg = hr + k * g.v;
        int node = 0;
        for (int d = 0; d < g.depth; ++d) {
          const int2 w = f32_tree_word<kTrees>(tr, feat_l, thr_l, node, k, I, g.kpad);
          node = 2 * node + 1 + (xg[w.x] > __int_as_float(w.y) ? 1 : 0);
        }
        leaf = node - I;
        s_row[k] = k * C + leaf;
        if (lv != nullptr) lv[k] = leaf;
      }
    }
    __syncwarp();

    // Gather-sum: lane n sums column n0 + n over the K groups. Lanes past
    // the last column read it again and store nothing.
    const float* lut_l = lut + lk * C * g.nmax;
    const float* bias_l = bias == nullptr ? nullptr : bias + static_cast<size_t>(l) * g.nmax;
    for (int n0 = 0; n0 < n_eff; n0 += 32) {
      const int n = n0 + lane;
      const float* col = lut_l + min(n, n_eff - 1);
      const float b = bias_l != nullptr ? __ldg(bias_l + min(n, n_eff - 1)) : 0.f;
      float acc = 0.f;
      for (int k0 = 0; k0 < K; k0 += F32_CHUNK) {
        float term[F32_CHUNK];
#pragma unroll
        for (int j = 0; j < F32_CHUNK; j += 4) {
          const int4 r = *reinterpret_cast<const int4*>(s_row + k0 + j);
          term[j] = __ldg(col + static_cast<size_t>(r.x) * g.nmax);
          term[j + 1] = __ldg(col + static_cast<size_t>(r.y) * g.nmax);
          term[j + 2] = __ldg(col + static_cast<size_t>(r.z) * g.nmax);
          term[j + 3] = __ldg(col + static_cast<size_t>(r.w) * g.nmax);
        }
#pragma unroll
        for (int j = 0; j < F32_CHUNK; ++j)
          if (k0 + j < K) acc = acc + term[j];
      }
      if (bias_l != nullptr) acc = acc + b;
      if (last) {
        if (n < n_eff) y[static_cast<size_t>(row) * g.n_out + n] = acc;
      } else if (kRegs) {
        h = n < n_eff ? acc : 0.f;
      } else if (n < n_eff) {
        h_s[n] = acc;
      }
    }
    __syncwarp();
  }
}

// Launch one instance on `stream`; opts it into `smem` bytes of dynamic
// shared memory first (above 48 KB it is refused without the attribute).
template <bool kTrees, bool kRegs>
static int f32_launch_as(const float* x, const int* feat, const float* thr,
                         const float* lut, const float* bias, float* y,
                         int* leaves, int T, const F32Geom& g, int grid,
                         int threads, int smem, void* stream) {
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        F32_KERNEL<kTrees, kRegs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  F32_KERNEL<kTrees, kRegs>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, feat, thr, lut, bias, y, leaves, T, g);
  return static_cast<int>(cudaGetLastError());
}

static int f32_launch(const float* x, const int* feat, const float* thr,
                      const float* lut, const float* bias, float* y,
                      int* leaves, int T, const F32Geom& g, int grid,
                      int threads, int smem, void* stream) {
  if (g.kpad > 0) {
    return g.regs ? f32_launch_as<true, true>(x, feat, thr, lut, bias, y, leaves, T, g,
                                              grid, threads, smem, stream)
                  : f32_launch_as<true, false>(x, feat, thr, lut, bias, y, leaves, T, g,
                                               grid, threads, smem, stream);
  }
  return g.regs ? f32_launch_as<false, true>(x, feat, thr, lut, bias, y, leaves, T, g,
                                             grid, threads, smem, stream)
                : f32_launch_as<false, false>(x, feat, thr, lut, bias, y, leaves, T, g,
                                              grid, threads, smem, stream);
}
