// Heavy-row kernels of the banked launches for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (ops/_build.py, ops/cuda_kernels.py).
//
// What they replace. The heavy band of the JAX package's BankedPallasKernel
// (distributed_sddmm_tpu/codegen/kernel.py: sddmm_tile_t l.117,
// spmm_tile_t l.131, fused_tile_t l.145, attn_stats_tile_t l.171), which
// launches the Pallas tile kernels once per row band; the short and mid
// bands run tile_kernels.cu and attn_kernels.cu with a row list.
//
// Why. A row-owned kernel gives a row of n nonzeros to one lane group: a
// bigbird global token (a row of every column) or a Graph500 R-mat hub
// then walks thousands of slots alone while the rest of the card idles.
// Here each heavy row is cut into segments of at most `split` slots
// (codegen/banded.py) and:
//   split pass 1 (sddmm_split / spmm_split / fused_split): one lane group
//     per segment, the same walk as the generic kernel (tile_common.cuh):
//     A of the segment's row loaded once (SDDMM, fused), mid[k] written for
//     its slots (SDDMM, fused), its f32 partial output row written to row
//     s of a workspace [n_seg, R] (SpMM, fused). SDDMM needs this pass
//     only: mid is per slot.
//   split pass 2 (split_reduce): per heavy row, its segments' partial rows
//     summed in segment order, the output row written once.
//   attn_stats_split: per segment, the masked (max, sum-of-exp) pair of
//     the stats walk (tile_common.cuh); attn_stats_merge: per heavy row,
//     its segments' pairs merged in segment order by the attn_merge_stats
//     rule (max of the maxima, each denominator rescaled into it),
//     (ATTN_NEG, 0) for a row with none.
// One owner per output slot, row or segment; no atomics; every sum in a
// fixed order, so two launches agree bit for bit. Splitting re-associates
// an output row's sum, so on normal data the result differs from the
// generic kernel's in the last bits; on integer data it is identical. bf16
// rounding stays at the TPU kernel's points (operands, and each scatter
// contribution before it is added); workspace and sums are f32.
//
// Bound on this card. Pass 1 moves what the generic kernel moves for the
// same slots (indices, values, mid, one gathered B row a slot) plus the
// workspace, n_seg * R * 4 bytes written and read back once by pass 2,
// which is small beside the gathered rows (split >= 32 slots a segment).

#include "tile_common.cuh"

namespace {

constexpr int kReduceThreads = 128;

__global__ void __launch_bounds__(kReduceThreads)
split_reduce_kernel(const int* __restrict__ seg_ptr,
                    const int* __restrict__ rows,
                    const float* __restrict__ work, float* __restrict__ out,
                    int n_rows, int R) {
  const int i = blockIdx.x;
  const int f = blockIdx.y * kReduceThreads + threadIdx.x;
  if (i >= n_rows || f >= R) return;
  float acc = 0.f;
  const int end = seg_ptr[i + 1];
  for (int s = seg_ptr[i]; s < end; ++s) {
    acc += work[static_cast<size_t>(s) * R + f];
  }
  out[static_cast<size_t>(rows[i]) * R + f] = acc;
}

__global__ void __launch_bounds__(kThreads)
attn_merge_kernel(const int* __restrict__ seg_ptr,
                  const int* __restrict__ rows, const float* __restrict__ wm,
                  const float* __restrict__ wd, float* __restrict__ m_out,
                  float* __restrict__ d_out, int n_rows) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  const int beg = seg_ptr[i];
  const int end = seg_ptr[i + 1];
  float m = kAttnNeg;
  for (int s = beg; s < end; ++s) m = fmaxf(m, wm[s]);
  float d = 0.f;  // exp(ATTN_NEG - ATTN_NEG) * 0 = 0 for an empty pair
  for (int s = beg; s < end; ++s) {
    d = __fadd_rn(d, __fmul_rn(wd[s], expf(wm[s] - m)));
  }
  m_out[rows[i]] = m;
  d_out[rows[i]] = d;
}

template <int OP>
int dispatch_split(const int* row_ptr, const int* seg_row, const int* seg_beg,
                   const int* seg_end, const int* cols, const float* sv,
                   const void* A, const void* B, float* work, float* mid,
                   int n_seg, int frame_rows, int cap, int zero_pads, int R,
                   int bf16, int vec, void* stream) {
  const Walk w{row_ptr, nullptr, seg_row, seg_beg, seg_end,
               n_seg,   frame_rows, cap, zero_pads};
  return launch_walk<OP>(w, cols, sv, A, B, work, mid, R, bf16, vec, stream);
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() right after the launch.

extern "C" int sddmm_split(const int* row_ptr, const int* seg_row,
                           const int* seg_beg, const int* seg_end,
                           const int* cols, const float* sv, const void* A,
                           const void* B, float* mid, int n_seg,
                           int frame_rows, int cap, int zero_pads, int R,
                           int bf16, int vec, void* stream) {
  return dispatch_split<kSddmm>(row_ptr, seg_row, seg_beg, seg_end, cols, sv,
                                A, B, nullptr, mid, n_seg, frame_rows, cap,
                                zero_pads, R, bf16, vec, stream);
}

extern "C" int spmm_split(const int* seg_row, const int* seg_beg,
                          const int* seg_end, const int* cols, const float* sv,
                          const void* B, float* work, int n_seg, int R,
                          int bf16, int vec, void* stream) {
  return dispatch_split<kSpmm>(nullptr, seg_row, seg_beg, seg_end, cols, sv,
                               nullptr, B, work, nullptr, n_seg, 0, 0, 0, R,
                               bf16, vec, stream);
}

extern "C" int fused_split(const int* row_ptr, const int* seg_row,
                           const int* seg_beg, const int* seg_end,
                           const int* cols, const float* sv, const void* A,
                           const void* B, float* work, float* mid, int n_seg,
                           int frame_rows, int cap, int zero_pads, int R,
                           int bf16, int vec, void* stream) {
  return dispatch_split<kFused>(row_ptr, seg_row, seg_beg, seg_end, cols, sv,
                                A, B, work, mid, n_seg, frame_rows, cap,
                                zero_pads, R, bf16, vec, stream);
}

extern "C" int split_reduce(const int* seg_ptr, const int* rows,
                            const float* work, float* out, int n_rows, int R,
                            void* stream) {
  const dim3 grid(n_rows > 0 ? n_rows : 1, blocks_for(R, kReduceThreads));
  split_reduce_kernel<<<grid, kReduceThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      seg_ptr, rows, work, out, n_rows, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int attn_stats_split(const int* seg_beg, const int* seg_end,
                                const float* gate, const float* logits,
                                float* wm, float* wd, int n_seg,
                                void* stream) {
  const Walk w{nullptr, nullptr, nullptr, seg_beg, seg_end, n_seg, 0, 0, 0};
  return launch_stats<kStatLanes>(w, gate, logits, wm, wd, stream);
}

extern "C" int attn_stats_merge(const int* seg_ptr, const int* rows,
                                const float* wm, const float* wd, float* m,
                                float* d, int n_rows, void* stream) {
  attn_merge_kernel<<<blocks_for(n_rows, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      seg_ptr, rows, wm, wd, m, d, n_rows);
  return static_cast<int>(cudaGetLastError());
}
