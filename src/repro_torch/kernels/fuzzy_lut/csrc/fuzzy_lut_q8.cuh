// int8 fuzzy-LUT kernel for Hopper, shared by the per-bank entry
// (fuzzy_lut_q8_bank.cu, one layer, no bias) and the stacked entry
// (fuzzy_lut_q8_stack.cu, L layers with bias).
//
// Replaces the Pallas kernels src/repro/kernels/fuzzy_lut/quantized.py
// fuzzy_lut_q8_pallas and fuzzy_lut_stack_q8_pallas.
//
// What bounds it: latency. The bytes (activations in, outputs out, the
// int8 tables once) are a fraction of a microsecond of HBM time at the
// MLP-B shapes; what costs is each output's chain of dependent loads
// (leaf -> LUT byte -> scale) and each tree's chain of d dependent
// compares. The design keeps every link of those chains in shared memory
// and issues the independent links together:
//   * Operands in shared memory, loaded asynchronously. The launch planner
//     (quantized.py: plan_q8) cuts each layer into stages: its trees, then
//     its scales, bias and LUT (whole Nmax-wide rows, or column tiles),
//     and groups consecutive stages into fills of one slot of a two-slot
//     ring. Warp 0 stages a fill with 1-D bulk copies (cp.async.bulk ...
//     complete_tx) that complete on the slot's `full` mbarrier, or with a
//     cooperative copy where a part's address or size is not a multiple of
//     16 bytes. Fill f+1 is in flight while fill f computes; a slot is
//     refilled once every warp has arrived on its `empty` mbarrier. Trees
//     too wide for a slot, and a LUT that no bulk copy can stage (the
//     planner stages a LUT only by bulk copies), are read through L1
//     instead, with the same warp mapping. The stage table is in shared
//     memory too.
//   * Persistent and layer-outer. About one block per SM; each block owns
//     chunks of `rows` batch rows, keeps their activations h[rows, width]
//     and leaves in shared memory, and walks the stages (layers) in its
//     outer loop, so each layer's operands cross L2 once per block.
//   * One warp per row, lanes over trees then over output columns. Lane k
//     walks tree k from shared memory; lane n then issues the reads of
//     column n sixteen groups at a time (independent shared loads) before
//     summing them as acc + __fmul_rn(float(q), s_k) in ascending k, then
//     + bias: the plain version's order, so the bits are equal. A row
//     belongs to one warp for the whole launch, so __syncwarp is the only
//     barrier inside a layer.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define Q8_DESC 14     // ints per stage descriptor (quantized.py: Q8Stage)
#define Q8_BAR_BYTES 128
#define Q8_MAX_THREADS 1024
#define Q8_CHUNK 16    // LUT reads issued before the first add
#define Q8_WAIT_NS 2000000000ull  // a barrier wait this long traps (a lost copy)

// Stage flags and bulk-copy bits: quantized.py defines the same values.
#define Q8_DESCENT 1   // walk the trees of this stage's layer
#define Q8_TREES 2     // ... from the slot (else from global memory)
#define Q8_GATHER 4    // compute columns [n0, n0 + nt)
#define Q8_LUT 8       // LUT tile in the slot (else from global memory)
#define Q8_FULLROW 16  // the slot holds whole Nmax-wide LUT rows

#define Q8_B_FEAT 1
#define Q8_B_THR 2
#define Q8_B_SCALE 4
#define Q8_B_BIAS 8
#define Q8_B_LUT 16

struct Q8Geom {
  int L;           // layers (1 for a bank)
  int k0;          // groups of the input x
  int kmax;        // padded group count of the operand stacks
  int nmax;        // padded output width of the operand stacks
  int n_out;       // true output width of the last layer
  int v;           // group width
  int depth;       // tree depth d, C = 2^d
  int width;       // activation row width in shared memory (multiple of 4)
  int kstride;     // leaf row width in shared memory (kmax rounded up to 4)
  int rows;        // batch rows per chunk
  int nchunks;     // ceil(T / rows)
  int nstages;     // stage descriptors
  int nfills;      // ring fills per chunk, each a run of stages
  int slot_bytes;  // bytes of one ring slot
};

// Shared bytes of the stage table (descriptors, then fills), 16-aligned.
__device__ __forceinline__ int q8_table_bytes(const Q8Geom& g) {
  return (4 * (g.nstages * Q8_DESC + 2 * g.nfills) + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t q8_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void q8_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(q8_smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void q8_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(q8_smem(bar)) : "memory");
}

__device__ __forceinline__ void q8_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(q8_smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t q8_now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until the phase of parity `parity` of `bar` has completed. A copy
// that never lands traps after Q8_WAIT_NS, so the launch fails with an
// error the wrapper raises instead of hanging the card.
__device__ __forceinline__ void q8_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(q8_smem(bar)), "r"(parity) : "memory");
    if (done) return;
    const uint64_t now = q8_now_ns();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > Q8_WAIT_NS) {
      __trap();
    }
  }
}

// 1-D bulk copy global -> shared; completes `bytes` on `bar`. Both
// addresses and `bytes` are multiples of 16 (the planner checked).
__device__ __forceinline__ void q8_bulk(void* dst, const void* src,
                                        uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(q8_smem(dst)), "l"(src), "r"(bytes), "r"(q8_smem(bar))
      : "memory");
}

// One contiguous part of a stage, copied by the 32 lanes of warp 0: one
// bulk copy on `bar` when `bulk` (measured faster than pieces per lane),
// else loads and stores.
__device__ __forceinline__ void q8_copy(void* dst, const void* src,
                                        uint32_t bytes, bool bulk,
                                        uint64_t* bar, int lane) {
  if (bulk) {
    if (lane == 0 && bytes) q8_bulk(dst, src, bytes, bar);
    return;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | bytes;
  if ((a & 3) == 0) {
    const float* s = static_cast<const float*>(src);
    float* d = static_cast<float*>(dst);
    for (uint32_t i = lane; i < bytes / 4; i += 32) d[i] = s[i];
  } else {
    const int8_t* s = static_cast<const int8_t*>(src);
    int8_t* d = static_cast<int8_t*>(dst);
    for (uint32_t i = lane; i < bytes; i += 32) d[i] = s[i];
  }
}

// Warp 0 copies the parts of stage `d` into `slot`.
__device__ __forceinline__ void q8_copy_stage(
    const int* d, unsigned char* slot, uint64_t* bar,
    const int* __restrict__ feat, const float* __restrict__ thr,
    const int8_t* __restrict__ lut, const float* __restrict__ scales,
    const float* __restrict__ bias, const Q8Geom& g, int lane) {
  const int l = d[0], flags = d[1], n0 = d[2], nt = d[3], pitch = d[4];
  const int bulk = d[10];
  const int K = d[12];  // groups of layer l (a descriptor field: indexing a
                        // by-value array at run time would copy it to local memory)
  const int I = (1 << g.depth) - 1;
  const int C = I + 1;
  const size_t lk = static_cast<size_t>(l) * g.kmax;
  if (flags & Q8_TREES) {
    q8_copy(slot + d[5], feat + lk * I, 4u * K * I, bulk & Q8_B_FEAT, bar, lane);
    q8_copy(slot + d[6], thr + lk * I, 4u * K * I, bulk & Q8_B_THR, bar, lane);
  }
  if (flags & Q8_GATHER) {
    q8_copy(slot + d[7], scales + lk, 4u * K, bulk & Q8_B_SCALE, bar, lane);
    if (bias != nullptr)
      q8_copy(slot + d[8], bias + static_cast<size_t>(l) * g.nmax + n0,
              4u * nt, bulk & Q8_B_BIAS, bar, lane);
    if (flags & Q8_LUT) {
      const int8_t* src = lut + lk * C * g.nmax;
      if (flags & Q8_FULLROW) {
        q8_copy(slot + d[9], src, static_cast<uint32_t>(K) * C * g.nmax,
                bulk & Q8_B_LUT, bar, lane);
      } else {
        // K*C row segments of nt bytes, one per lane at a time
        for (int seg = lane; seg < K * C; seg += 32) {
          int8_t* dst = reinterpret_cast<int8_t*>(slot + d[9]) +
                        static_cast<size_t>(seg) * pitch;
          const int8_t* s = src + static_cast<size_t>(seg) * g.nmax + n0;
          if (bulk & Q8_B_LUT) {
            q8_bulk(dst, s, nt, bar);
          } else {
            for (int i = 0; i < nt; ++i) dst[i] = s[i];
          }
        }
      }
    }
  }
}

// Warp 0 fills `slot` with the stages of fill `f` (fills: [nfills, 2] of
// first stage and count): bulk copies count on `bar`'s transaction bytes,
// cooperative copies are released by each lane's arrival (the barrier
// counts 32 arrivals).
__device__ __forceinline__ void q8_issue(
    const int* stages, const int* fills, int f,
    unsigned char* slot, uint64_t* bar, const int* __restrict__ feat,
    const float* __restrict__ thr, const int8_t* __restrict__ lut,
    const float* __restrict__ scales, const float* __restrict__ bias,
    const Q8Geom& g, int lane) {
  // Generic-proxy reads and writes of this slot (acquired through the
  // empty barrier) come before the async proxy's writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  uint32_t tx = 0;
  for (int s = fills[2 * f]; s < fills[2 * f] + fills[2 * f + 1]; ++s) {
    const int* d = stages + s * Q8_DESC;
    q8_copy_stage(d, slot, bar, feat, thr, lut, scales, bias, g, lane);
    tx += static_cast<uint32_t>(d[11]);
  }
  if (lane == 0) {
    q8_arrive_tx(bar, tx);
  } else {
    q8_arrive(bar);
  }
}

// Walk trees [0, K) of one row, lane k taking tree k: node <- 2*node + 1 +
// (x[feat[node]] > thr[node]); a +inf threshold always goes left. lr[k]
// gets the leaf's LUT row offset (k*C + leaf) * lpitch when the layer's
// LUT is staged (lpitch > 0), else the leaf. kShared: trees in the slot.
template <bool kShared>
__device__ __forceinline__ void q8_descent(const int* feat_l, const float* thr_l,
                                           const float* hr, int* lr,
                                           int* leaves_row, int K, int depth,
                                           int v, int lpitch, int lane) {
  const int I = (1 << depth) - 1;
  for (int k = lane; k < K; k += 32) {
    const int* fk = feat_l + k * I;
    const float* tk = thr_l + k * I;
    const float* xg = hr + k * v;
    int node = 0;
    for (int dd = 0; dd < depth; ++dd) {
      const int f = kShared ? fk[node] : __ldg(fk + node);
      const float th = kShared ? tk[node] : __ldg(tk + node);
      node = 2 * node + 1 + (xg[f] > th ? 1 : 0);
    }
    const int leaf = node - I;
    lr[k] = lpitch > 0 ? (k * (I + 1) + leaf) * lpitch : leaf;
    if (leaves_row != nullptr) leaves_row[k] = leaf;
  }
}

// Sum_k s_k * q over the K groups of one output column, in ascending k.
// kShared: `col` is column n of the LUT in the slot and lr[k] the row
// offsets; else `col` is column n in global memory (rows `nmax` apart) and
// lr[k] the leaves. The reads of a chunk are issued before its adds.
template <bool kShared>
__device__ __forceinline__ float q8_column(const int8_t* col, const int* lr,
                                           const float* sc, int K, int C,
                                           int nmax) {
  float acc = 0.f;
  int k = 0;
  for (; k + Q8_CHUNK <= K; k += Q8_CHUNK) {
    int q[Q8_CHUNK];
    float s[Q8_CHUNK];
#pragma unroll
    for (int j = 0; j < Q8_CHUNK; j += 4) {
      const int4 o = *reinterpret_cast<const int4*>(lr + k + j);
      const float4 s4 = *reinterpret_cast<const float4*>(sc + k + j);
      const int oj[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[j + i] = kShared
            ? col[oj[i]]
            : __ldg(col + static_cast<size_t>((k + j + i) * C + oj[i]) * nmax);
      s[j] = s4.x; s[j + 1] = s4.y; s[j + 2] = s4.z; s[j + 3] = s4.w;
    }
#pragma unroll
    for (int j = 0; j < Q8_CHUNK; ++j)
      acc = acc + __fmul_rn(static_cast<float>(q[j]), s[j]);
  }
  for (; k < K; ++k) {
    const int q = kShared ? col[lr[k]]
                          : __ldg(col + static_cast<size_t>(k * C + lr[k]) * nmax);
    acc = acc + __fmul_rn(static_cast<float>(q), sc[k]);
  }
  return acc;
}

template <bool kStack>
__global__ void __launch_bounds__(Q8_MAX_THREADS, 1)
fuzzy_lut_q8_kernel(const float* __restrict__ x,        // [T, K0, v]
                    const int* __restrict__ feat,       // [L, Kmax, I]
                    const float* __restrict__ thr,      // [L, Kmax, I]
                    const int8_t* __restrict__ lut,     // [L, Kmax, C, Nmax]
                    const float* __restrict__ scales,   // [L, Kmax]
                    const float* __restrict__ bias,     // [L, Nmax] (stack)
                    float* __restrict__ y,              // [T, n_out]
                    int* __restrict__ leaves,           // [L, T, Kmax] or null
                    const int* stages,                  // [nstages, Q8_DESC],
                                                        // then fills [nfills, 2]
                    int T, Q8Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [2]
  uint64_t* empty = full + 2;                           // [2]
  // The stage table, read at every stage: in shared memory, since chains
  // of dependent reads from global memory were most of a launch's time.
  const int table_ints = g.nstages * Q8_DESC + 2 * g.nfills;
  int* s_table = reinterpret_cast<int*>(smem + Q8_BAR_BYTES);
  unsigned char* slots = smem + Q8_BAR_BYTES + q8_table_bytes(g);
  float* h = reinterpret_cast<float*>(slots + 2 * static_cast<size_t>(g.slot_bytes));
  int* s_leaf = reinterpret_cast<int*>(h + static_cast<size_t>(g.rows) * g.width);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int I = (1 << g.depth) - 1;
  const int C = I + 1;
  const int in_w = g.k0 * g.v;
  const float* bias_g = kStack ? bias : nullptr;

  for (int i = threadIdx.x; i < table_ints; i += blockDim.x) s_table[i] = stages[i];
  if (threadIdx.x == 0) {
    q8_bar_init(&full[0], 32);
    q8_bar_init(&full[1], 32);
    q8_bar_init(&empty[0], nwarps);
    q8_bar_init(&empty[1], nwarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stages = s_table;
  const int* fills = stages + g.nstages * Q8_DESC;

  const int my_chunks =
      blockIdx.x < g.nchunks ? (g.nchunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_chunks * g.nfills;
  if (warp == 0) {
    for (int s = 0; s < 2 && s < total; ++s)
      q8_issue(stages, fills, s % g.nfills, slots + s * g.slot_bytes, &full[s],
               feat, thr, lut, scales, bias_g, g, lane);
  }

  for (int gs = 0; gs < total; ++gs) {
    const int f = gs % g.nfills;
    const int t0 = (blockIdx.x + (gs / g.nfills) * gridDim.x) * g.rows;
    const int nrows = min(g.rows, T - t0);
    const int b = gs & 1;
    unsigned char* slot = slots + b * static_cast<size_t>(g.slot_bytes);

    if (f == 0) {  // a new chunk: its input rows into h
      for (int r = warp; r < nrows; r += nwarps) {
        const float* xr = x + static_cast<size_t>(t0 + r) * in_w;
        for (int c = lane; c < in_w; c += 32) h[r * g.width + c] = xr[c];
      }
      __syncwarp();
    }
    q8_wait(&full[b], (gs >> 1) & 1);

    for (int s = fills[2 * f]; s < fills[2 * f] + fills[2 * f + 1]; ++s) {
      const int* d = stages + s * Q8_DESC;
      const int l = d[0], flags = d[1], n0 = d[2], nt = d[3];
      const int K = d[12], lpitch = d[13];
      const bool last = (l + 1 == g.L);
      const size_t lk = static_cast<size_t>(l) * g.kmax;
      const float* sc = reinterpret_cast<const float*>(slot + d[7]);
      const float* bs = reinterpret_cast<const float*>(slot + d[8]);
      // column n of the slot's LUT rows, of the global LUT rows
      const int8_t* col_s = reinterpret_cast<const int8_t*>(slot + d[9]) -
                            ((flags & Q8_FULLROW) ? 0 : n0);
      const int8_t* col_g = lut + lk * C * g.nmax;

      for (int r = warp; r < nrows; r += nwarps) {
        float* hr = h + r * g.width;
        int* lr = s_leaf + r * g.kstride;
        if (flags & Q8_DESCENT) {
          int* lv = leaves == nullptr ? nullptr
              : leaves + (static_cast<size_t>(l) * T + t0 + r) * g.kmax;
          if (flags & Q8_TREES) {
            q8_descent<true>(reinterpret_cast<const int*>(slot + d[5]),
                             reinterpret_cast<const float*>(slot + d[6]), hr, lr,
                             lv, K, g.depth, g.v, lpitch, lane);
          } else {
            q8_descent<false>(feat + lk * I, thr + lk * I, hr, lr, lv, K,
                              g.depth, g.v, lpitch, lane);
          }
          __syncwarp();
        }
        if (flags & Q8_GATHER) {
          for (int n = n0 + lane; n < n0 + nt; n += 32) {
            float acc = (flags & Q8_LUT)
                ? q8_column<true>(col_s + n, lr, sc, K, C, g.nmax)
                : q8_column<false>(col_g + n, lr, sc, K, C, g.nmax);
            if (bias_g != nullptr) acc = acc + bs[n - n0];
            if (last) {
              y[static_cast<size_t>(t0 + r) * g.n_out + n] = acc;
            } else {
              hr[n] = acc;
            }
          }
          __syncwarp();
        }
      }
    }

    // Release the slot; warp 0 refills it with fill gs + 2 once every
    // warp has let go of it.
    if (lane == 0) q8_arrive(&empty[b]);
    if (warp == 0 && gs + 2 < total) {
      q8_wait(&empty[b], (gs >> 1) & 1);
      q8_issue(stages, fills, (gs + 2) % g.nfills, slot, &full[b], feat, thr,
               lut, scales, bias_g, g, lane);
    }
  }
}

// Launch on `stream`; opts the kernel into `smem` bytes of dynamic shared
// memory first (above 48 KB it is refused without the attribute).
template <bool kStack>
static int q8_launch(const float* x, const int* feat, const float* thr,
                     const int8_t* lut, const float* scales, const float* bias,
                     float* y, int* leaves, const int* stages, int T,
                     const Q8Geom& g, int grid, int threads, int smem,
                     void* stream) {
  static int opted_in = 0;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fuzzy_lut_q8_kernel<kStack>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  fuzzy_lut_q8_kernel<kStack>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, feat, thr, lut, scales, bias, y, leaves, stages, T, g);
  return static_cast<int>(cudaGetLastError());
}
