// Row-owned SDDMM, SpMM and fused SDDMM->SpMM tile kernels for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (distributed_sddmm_tpu_torch/ops/_build.py and ops/cuda_kernels.py).
//
// What they replace. The JAX package's Pallas kernels behind
// distributed_sddmm_tpu/ops/pallas_kernels.py::_tile_call:
//   fused  (op="fused", _make_fused_body l.305): mid[k] = sv[k]*<A[r_k],B[c_k]>,
//          out[r] = sum_{k: r_k = r} mid[k]*B[c_k]
//   sddmm  (op="sddmm", _make_sddmm_body l.327): mid only
//   spmm   (op="spmm",  _make_spmm_body  l.341): out[r] = sum sv[k]*B[c_k]
// and, with a row list, the short and mid band launches of the banked
// kernel (distributed_sddmm_tpu/codegen/kernel.py l.117, 131, 145).
// The TPU versions recast the row gathers and the row scatter as one-hot
// matmuls because the TPU has no vector gather. Hopper has native gathers,
// so these kernels compute the same function directly.
//
// Layout. A tile's nonzeros are stored in CSR order (row-sorted, pads at
// the tail) with a per-tile row_ptr; dense operands are row-major [rows, R]
// in float32, or bfloat16 in the bf16 precision mode. Pad slots get
// mid = 0.
//
// Design. One group of G = R/16 lanes owns one output row
// (tile_common.cuh, dot_walk_kernel, one walk for the three ops): no
// atomics, every sum in a fixed order. A null row_ids walks every tile row
// (item i, row i); a band's row list walks only its rows (item i, row
// row_ids[i]), so the bands of a banked launch write disjoint rows of one
// output and only the launch with zero_pads set touches the pad slots.
// Index chunks come one slot a lane and go out by shuffle; a batch of B
// rows is gathered into registers (L1-cached) while the next batch's rows
// are prefetched into L2; the SDDMM and fused reduce a batch's dot
// products together; the SpMM and fused scale each row into the output
// row the group keeps in registers.
//
// Bound on this card. Every kernel moves far more bytes than it computes:
// two flops per gathered element of B[c] (four in fused). The compulsory
// traffic (indices, values and mid, A and the output once, B once) bounds
// it from below, but when B does not fit in the 50 MB L2 each nonzero
// gathers a whole B row from HBM (nnz * R * 4 bytes, half in bf16), which
// is the practical floor. At under one flop a byte the tensor cores
// (wgmma) have nothing to win; what the walk buys is bytes in flight
// and fewer instructions per nonzero. Heavy rows are split by
// banked_kernels.cu.

#include "tile_common.cuh"

namespace {

template <int OP>
int dispatch(const int* row_ptr, const int* row_ids, const int* cols,
             const float* sv, const void* A, const void* B, float* out,
             float* mid, int n_rows, int frame_rows, int cap, int zero_pads,
             int R, int bf16, int vec, void* stream) {
  const Walk w{row_ptr, row_ids, nullptr, nullptr, nullptr,
               n_rows,  frame_rows, cap, zero_pads};
  return launch_walk<OP>(w, cols, sv, A, B, out, mid, R, bf16, vec, stream);
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() right after the launch.
// row_ids: null for every tile row (n_rows = frame_rows), else the n_rows
// listed rows.

extern "C" int sddmm_tile(const int* row_ptr, const int* row_ids,
                          const int* cols, const float* sv, const void* A,
                          const void* B, float* mid, int n_rows,
                          int frame_rows, int cap, int zero_pads, int R,
                          int bf16, int vec, void* stream) {
  return dispatch<kSddmm>(row_ptr, row_ids, cols, sv, A, B, nullptr, mid,
                          n_rows, frame_rows, cap, zero_pads, R, bf16, vec,
                          stream);
}

extern "C" int spmm_tile(const int* row_ptr, const int* row_ids,
                         const int* cols, const float* sv, const void* B,
                         float* out, int n_rows, int R, int bf16, int vec,
                         void* stream) {
  return dispatch<kSpmm>(row_ptr, row_ids, cols, sv, nullptr, B, out, nullptr,
                         n_rows, 0, 0, 0, R, bf16, vec, stream);
}

extern "C" int fused_tile(const int* row_ptr, const int* row_ids,
                          const int* cols, const float* sv, const void* A,
                          const void* B, float* out, float* mid, int n_rows,
                          int frame_rows, int cap, int zero_pads, int R,
                          int bf16, int vec, void* stream) {
  return dispatch<kFused>(row_ptr, row_ids, cols, sv, A, B, out, mid, n_rows,
                          frame_rows, cap, zero_pads, R, bf16, vec, stream);
}

extern "C" const char* tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
