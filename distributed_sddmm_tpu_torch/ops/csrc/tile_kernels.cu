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
// The TPU versions recast the row gathers and the row scatter as one-hot
// matmuls because the TPU has no vector gather. Hopper has native gathers,
// so these kernels compute the same function directly.
//
// Layout. A tile's nonzeros are stored in CSR order (row-sorted, pads at
// the tail) with a per-tile row_ptr; dense operands are row-major [rows, R]
// in float32, or bfloat16 in the bf16 precision mode.
//
// Design. One warp owns one output row: it loads A[r] once into registers,
// walks the row's nonzeros, gathers B[c] (lanes stride over R, 16-byte
// float4 loads when R % 4 == 0, scalar loads otherwise), reduces the dot
// product with __shfl_xor_sync and keeps the output row in registers until
// it writes it once. No atomics: every sum runs in a fixed order, so the
// results are the same from run to run. Features beyond one register slab
// (128 for R <= 128, else 512) go to blockIdx.y; the dot product always
// runs over all of R in slab order, so every slab sees the same mid.
//
// Rounding points of the bf16 mode follow the TPU kernel: A and B are
// bf16, products accumulate in f32, each scatter contribution
// (B[c]*mid or B[c]*sv) is rounded to bf16 before it is added to the f32
// output (pallas_kernels.py l.190, 218, 235, 258, 317, 357); mid and the
// output are f32. Pad slots get mid = 0.
//
// Bound on this card. Every kernel moves far more bytes than it computes:
// two flops per gathered element of B[c]. The compulsory traffic (indices,
// values and mid, A and the output once, B once) bounds it from below, but
// when B does not fit in the 50 MB L2 each nonzero gathers a whole B row
// from HBM (nnz * R * 4 bytes), which is what these simple kernels pay.
// Staging B rows in shared memory, cp.async/TMA prefetch of the next
// rows, and splitting heavy rows are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

enum Op { kSddmm = 0, kSpmm = 1, kFused = 2 };

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Scatter contribution at the operand type's rounding point.
template <typename T>
__device__ __forceinline__ float round_contrib(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Feature index of element (v, e) of a lane's slab registers. VEC: four
// consecutive features per vector (one 16-byte load); scalar: neighbouring
// lanes on neighbouring features.
template <bool VEC>
__device__ __forceinline__ int feat(int base, int v, int e, int lane) {
  if constexpr (VEC) {
    return base + (v * kWarp + lane) * 4 + e;
  } else {
    return base + (v * 4 + e) * kWarp + lane;
  }
}

template <bool VEC, int NV, typename T>
__device__ __forceinline__ void gather(const T* __restrict__ row, int base,
                                       int R, int lane, float x[NV][4]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if constexpr (VEC) {
      const int f = feat<true>(base, v, 0, lane);
      if (f < R) {
        load4(row + f, x[v]);
      } else {
        x[v][0] = x[v][1] = x[v][2] = x[v][3] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = feat<false>(base, v, e, lane);
        x[v][e] = f < R ? load1(row + f) : 0.f;
      }
    }
  }
}

template <bool VEC, int NV>
__device__ __forceinline__ void store(float* __restrict__ row, int base,
                                      int R, int lane, const float x[NV][4]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if constexpr (VEC) {
      const int f = feat<true>(base, v, 0, lane);
      if (f < R) {
        *reinterpret_cast<float4*>(row + f) =
            make_float4(x[v][0], x[v][1], x[v][2], x[v][3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = feat<false>(base, v, e, lane);
        if (f < R) row[f] = x[v][e];
      }
    }
  }
}

template <int NV>
__device__ __forceinline__ float dot_part(const float a[NV][4],
                                          const float b[NV][4], float part) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part = fmaf(a[v][e], b[v][e], part);
  }
  return part;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int OP, bool VEC, int NV, typename T>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
            const float* __restrict__ sv, const T* __restrict__ A,
            const T* __restrict__ B, float* __restrict__ out,
            float* __restrict__ mid, int n_rows, int cap, int R, int n_slabs) {
  constexpr int kSlab = kWarp * 4 * NV;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int slab = blockIdx.y;
  const int base = slab * kSlab;

  if constexpr (OP != kSpmm) {
    if (slab == 0) {  // pad slots at the tile's tail get mid = 0
      const int stride = gridDim.x * blockDim.x;
      for (int k = row_ptr[n_rows] + blockIdx.x * blockDim.x + threadIdx.x;
           k < cap; k += stride) {
        mid[k] = 0.f;
      }
    }
  }
  if (row >= n_rows) return;  // warp-uniform: one warp, one row

  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  const T* a_row = OP != kSpmm ? A + static_cast<size_t>(row) * R : nullptr;
  float a[NV][4];
  if constexpr (OP != kSpmm) gather<VEC, NV>(a_row, base, R, lane, a);
  float acc[NV][4] = {};

  for (int k = beg; k < end; ++k) {
    const T* b_row = B + static_cast<size_t>(cols[k]) * R;
    const float s = sv[k];
    float b[NV][4];
    gather<VEC, NV>(b_row, base, R, lane, b);
    float w = s;  // weight of B[c] in the output row
    if constexpr (OP != kSpmm) {
      float part = 0.f;
      for (int s2 = 0; s2 < n_slabs; ++s2) {
        if (s2 == slab) {
          part = dot_part<NV>(a, b, part);
        } else {
          float a2[NV][4], b2[NV][4];
          gather<VEC, NV>(a_row, s2 * kSlab, R, lane, a2);
          gather<VEC, NV>(b_row, s2 * kSlab, R, lane, b2);
          part = dot_part<NV>(a2, b2, part);
        }
      }
      w = __fmul_rn(warp_sum(part), s);
      if (slab == 0 && lane == 0) mid[k] = w;
    }
    if constexpr (OP != kSddmm) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[v][e] += round_contrib<T>(__fmul_rn(b[v][e], w));
        }
      }
    }
  }
  if constexpr (OP != kSddmm) {
    store<VEC, NV>(out + static_cast<size_t>(row) * R, base, R, lane, acc);
  }
}

template <int OP, int NV, typename T>
void launch_nv(dim3 grid, cudaStream_t stream, bool vec, const int* row_ptr,
               const int* cols, const float* sv, const void* A, const void* B,
               float* out, float* mid, int n_rows, int cap, int R,
               int n_slabs) {
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  if (vec) {
    tile_kernel<OP, true, NV, T><<<grid, kThreads, 0, stream>>>(
        row_ptr, cols, sv, a, b, out, mid, n_rows, cap, R, n_slabs);
  } else {
    tile_kernel<OP, false, NV, T><<<grid, kThreads, 0, stream>>>(
        row_ptr, cols, sv, a, b, out, mid, n_rows, cap, R, n_slabs);
  }
}

template <int OP, typename T>
int launch(const int* row_ptr, const int* cols, const float* sv,
           const void* A, const void* B, float* out, float* mid, int n_rows,
           int cap, int R, int vec, void* stream) {
  const int nv = R <= kWarp * 4 ? 1 : 4;
  const int slab = kWarp * 4 * nv;
  const int n_slabs = (R + slab - 1) / slab;
  const int blocks = n_rows > 0 ? (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock : 1;
  const dim3 grid(blocks, OP == kSddmm ? 1 : n_slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv == 1) {
    launch_nv<OP, 1, T>(grid, s, vec != 0, row_ptr, cols, sv, A, B, out, mid,
                        n_rows, cap, R, n_slabs);
  } else {
    launch_nv<OP, 4, T>(grid, s, vec != 0, row_ptr, cols, sv, A, B, out, mid,
                        n_rows, cap, R, n_slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int OP>
int dispatch(const int* row_ptr, const int* cols, const float* sv,
             const void* A, const void* B, float* out, float* mid, int n_rows,
             int cap, int R, int bf16, int vec, void* stream) {
  if (bf16) {
    return launch<OP, __nv_bfloat16>(row_ptr, cols, sv, A, B, out, mid,
                                     n_rows, cap, R, vec, stream);
  }
  return launch<OP, float>(row_ptr, cols, sv, A, B, out, mid, n_rows, cap, R,
                           vec, stream);
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() right after the launch.

extern "C" int sddmm_tile(const int* row_ptr, const int* cols, const float* sv,
                          const void* A, const void* B, float* mid, int n_rows,
                          int cap, int R, int bf16, int vec, void* stream) {
  return dispatch<kSddmm>(row_ptr, cols, sv, A, B, nullptr, mid, n_rows, cap,
                          R, bf16, vec, stream);
}

extern "C" int spmm_tile(const int* row_ptr, const int* cols, const float* sv,
                         const void* B, float* out, int n_rows, int R, int bf16,
                         int vec, void* stream) {
  return dispatch<kSpmm>(row_ptr, cols, sv, nullptr, B, out, nullptr, n_rows,
                         0, R, bf16, vec, stream);
}

extern "C" int fused_tile(const int* row_ptr, const int* cols, const float* sv,
                          const void* A, const void* B, float* out, float* mid,
                          int n_rows, int cap, int R, int bf16, int vec,
                          void* stream) {
  return dispatch<kFused>(row_ptr, cols, sv, A, B, out, mid, n_rows, cap, R,
                          bf16, vec, stream);
}

extern "C" const char* tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
