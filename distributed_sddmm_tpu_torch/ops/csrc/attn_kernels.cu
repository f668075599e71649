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
// and, with a row list, the short and mid band launches of the banked
// stats (distributed_sddmm_tpu/codegen/kernel.py l.171).
// The TPU versions select each lane's row with a one-hot [bm, W] mask
// because the TPU cannot gather; here each slot's row comes from the
// tile's CSR (row_ptr for the reduction, rows[k] for the map).
//
// Design. attn_stats: the stats walk of tile_common.cuh
// (stats_walk_kernel), a group of kStatLanes lanes a tile row (or listed
// row), a max pass and then a sum-of-exp pass over the row's slots, each
// ending in a shuffle reduction over the group. The stats are partial per
// tile: the strategy merges tiles (and, later, the c axis) before
// attn_norm, so the two kernels stay apart. attn_norm: one thread per
// slot, exp on the select-guarded argument so a masked slot's
// z - ATTN_NEG never makes an inf; it never looks at row lengths, so the
// banked kernel launches it once over the whole tile. Both run in f32 in
// either precision mode (the JAX kernels read f32 chunk values whatever
// the precision), with the accurate expf and IEEE division: no fast-math.
//
// Bound on this card. Both move bytes and do a handful of operations per
// slot: attn_stats reads row_ptr, gate and logits (8 B a slot) and writes
// m and d; attn_norm reads rows, gate and logits and writes p (16 B a
// slot) plus one gather of m and d per slot, which the row order keeps in
// L1/L2. A warp a row, one 4-byte load a slot and an online rescale (two
// expf a merge step) made attn_stats bound by instructions at 45% of its
// byte bound (PERF.md, section 6); the stats walk loads 16 bytes a lane
// and spends one expf a live slot. A heavy row (a bigbird global token)
// would still serialise on one group; the banked launch splits such rows
// (banked_kernels.cu).

#include "tile_common.cuh"

namespace {

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

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() right after the launch.

extern "C" int attn_stats_tile(const int* row_ptr, const int* row_ids,
                               const float* gate, const float* logits,
                               float* m, float* d, int n_rows, void* stream) {
  const Walk w{row_ptr, row_ids, nullptr, nullptr, nullptr, n_rows, 0, 0, 0};
  return launch_stats<kStatLanes>(w, gate, logits, m, d, stream);
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
