// Masked-softmax tile kernels of block-sparse attention for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (distributed_sddmm_tpu_torch/ops/_build.py and ops/cuda_kernels.py).
//
// What they replace. The JAX package's Pallas epilogue behind
// distributed_sddmm_tpu/ops/pallas_kernels.py::_attn_call:
//   attn_stats  (op="attn_reduce", _make_attn_reduce_body l.419 and
//                _make_attn_reduce_body_single l.445): per row, the masked
//                max m and d = sum_{gate != 0} exp(z - m); a row with no
//                unmasked slot gives m = ATTN_NEG, d = 0
//   attn_norm   (op="attn_norm", _make_attn_norm_body l.465):
//                p = exp(z - m[r]) / d[r] where gate != 0 and d[r] > 0,
//                else exactly 0
// The TPU versions select each lane's row with a one-hot [bm, W] mask
// because the TPU cannot gather; here each slot's row comes from the
// tile's CSR (row_ptr for the reduction, rows[k] for the map).
//
// Design. attn_stats: one warp per tile row. Lanes stride over the row's
// slots and keep a running (max, rescaled sum) pair, d <- d*exp(m_old -
// m_new) + exp(z - m_new); the warp merges the lanes' pairs by shuffle
// with the same rule (ops/kernels.py::attn_merge_stats). The stats are
// partial per tile: the strategy merges tiles (and, later, the c axis)
// before attn_norm, so the two kernels stay apart. attn_norm: one thread
// per slot, exp on the select-guarded argument so a masked slot's
// z - ATTN_NEG never makes an inf. Both run in f32 in either precision
// mode (the JAX kernels read f32 chunk values whatever the precision),
// with the accurate expf and IEEE division: no fast-math.
//
// Bound on this card. Both move bytes and do a handful of operations per
// slot: attn_stats reads row_ptr, gate and logits (8 B a slot) and writes
// m and d; attn_norm reads rows, gate and logits and writes p (16 B a
// slot) plus one gather of m and d per slot, which the row order keeps in
// L1/L2. A warp per row idles most lanes on rows shorter than 32 slots
// and serialises a heavy row (a bigbird global token) on one warp;
// splitting heavy rows is the banked launch's work (ROADMAP B.6).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr float kAttnNeg = -1e30f;  // ops/kernels.py::ATTN_NEG

// Online-softmax merge of the pair (m2, d2) into (m, d).
__device__ __forceinline__ void merge(float& m, float& d, float m2, float d2) {
  const float mn = fmaxf(m, m2);
  d = d * expf(m - mn) + d2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(kThreads)
attn_stats_kernel(const int* __restrict__ row_ptr,
                  const float* __restrict__ gate,
                  const float* __restrict__ logits, float* __restrict__ m_out,
                  float* __restrict__ d_out, int n_rows) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // warp-uniform: one warp, one row

  float m = kAttnNeg;
  float d = 0.f;
  const int end = row_ptr[row + 1];
  for (int k = row_ptr[row] + lane; k < end; k += kWarp) {
    if (gate[k] != 0.f) {
      const float z = logits[k];
      if (z > m) {
        d = d * expf(m - z) + 1.f;
        m = z;
      } else {
        d += expf(z - m);
      }
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float d2 = __shfl_xor_sync(0xffffffffu, d, o);
    merge(m, d, m2, d2);
  }
  if (lane == 0) {
    m_out[row] = m;
    d_out[row] = d;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_norm_kernel(const int* __restrict__ rows, const float* __restrict__ gate,
                 const float* __restrict__ logits,
                 const float* __restrict__ m, const float* __restrict__ d,
                 float* __restrict__ p, int cap) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= cap) return;
  const int r = rows[k];
  const float dr = d[r];
  const bool ok = gate[k] != 0.f && dr > 0.f;
  const float e = expf(ok ? logits[k] - m[r] : 0.f);
  p[k] = ok ? e / dr : 0.f;
}

int blocks_for(int n, int per_block) {
  return n > 0 ? (n + per_block - 1) / per_block : 1;
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() right after the launch.

extern "C" int attn_stats_tile(const int* row_ptr, const float* gate,
                               const float* logits, float* m, float* d,
                               int n_rows, void* stream) {
  attn_stats_kernel<<<blocks_for(n_rows, kWarpsPerBlock), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      row_ptr, gate, logits, m, d, n_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int attn_norm_tile(const int* rows, const float* gate,
                              const float* logits, const float* m,
                              const float* d, float* p, int cap,
                              void* stream) {
  attn_norm_kernel<<<blocks_for(cap, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rows, gate, logits, m, d, p, cap);
  return static_cast<int>(cudaGetLastError());
}
