// Device code shared by tile_kernels.cu, attn_kernels.cu and
// banked_kernels.cu: operand loads at the bf16 rounding points, the
// warp-per-row walk of the SDDMM / SpMM / fused tile kernels, its launch,
// and the masked-softmax row statistics of one warp.
//
// Everything sits in an anonymous namespace: each source compiles its own
// copy, so no kernel symbol is shared between the objects of the library.
//
// The walk. One warp walks one "item": a whole tile row (the generic
// kernel, warp w -> row w), a row of a band's row list (warp w -> row
// row_ids[w]), or one segment of a heavy row (warp w -> slots
// seg_beg[w]..seg_end[w] of row seg_row[w], its partial output written to
// row w of a workspace). It loads A[row] once, gathers B[c] for each slot
// (lanes stride over R, 16-byte loads when R % 4 == 0), reduces the dot
// product with __shfl_xor_sync and keeps the output row in registers until
// it writes it once. Features beyond one register slab (128 for R <= 128,
// else 512) go to blockIdx.y; the dot product always runs over all of R
// in slab order, so every slab sees the same mid. No atomics, and every
// sum runs in a fixed order, so two launches agree bit for bit.
//
// bf16 mode: A and B are bf16, products accumulate in f32, each scatter
// contribution (B[c]*mid or B[c]*sv) is rounded to bf16 before it is
// added to the f32 output, as the TPU kernel rounds
// (distributed_sddmm_tpu/ops/pallas_kernels.py l.190, 218, 235, 258, 317,
// 357); mid and the output are f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr float kAttnNeg = -1e30f;  // ops/kernels.py::ATTN_NEG

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

// What one launch of walk_kernel walks. Exactly one of three item kinds:
// seg_beg set: segments (seg_row, seg_beg, seg_end), output row = item;
// row_ids set: the listed rows; neither: rows 0..n_items-1. The launch
// with zero_pads set also zeroes mid's pad slots [row_ptr[frame_rows], cap).
struct Walk {
  const int* row_ptr;
  const int* row_ids;
  const int* seg_row;
  const int* seg_beg;
  const int* seg_end;
  int n_items;
  int frame_rows;
  int cap;
  int zero_pads;
};

template <int OP, bool VEC, int NV, typename T>
__global__ void __launch_bounds__(kThreads)
walk_kernel(Walk w, const int* __restrict__ cols, const float* __restrict__ sv,
            const T* __restrict__ A, const T* __restrict__ B,
            float* __restrict__ out, float* __restrict__ mid, int R,
            int n_slabs) {
  constexpr int kSlab = kWarp * 4 * NV;
  const int lane = threadIdx.x % kWarp;
  const int item = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int slab = blockIdx.y;
  const int base = slab * kSlab;

  if constexpr (OP != kSpmm) {
    if (w.zero_pads && slab == 0) {
      const int stride = gridDim.x * blockDim.x;
      for (int k = w.row_ptr[w.frame_rows] + blockIdx.x * blockDim.x + threadIdx.x;
           k < w.cap; k += stride) {
        mid[k] = 0.f;
      }
    }
  }
  if (item >= w.n_items) return;  // warp-uniform: one warp, one item

  int row, beg, end, out_row;
  if (w.seg_beg != nullptr) {
    row = w.seg_row[item];
    beg = w.seg_beg[item];
    end = w.seg_end[item];
    out_row = item;
  } else {
    row = w.row_ids != nullptr ? w.row_ids[item] : item;
    beg = w.row_ptr[row];
    end = w.row_ptr[row + 1];
    out_row = row;
  }
  const T* a_row = OP != kSpmm ? A + static_cast<size_t>(row) * R : nullptr;
  float a[NV][4];
  if constexpr (OP != kSpmm) gather<VEC, NV>(a_row, base, R, lane, a);
  float acc[NV][4] = {};

  for (int k = beg; k < end; ++k) {
    const T* b_row = B + static_cast<size_t>(cols[k]) * R;
    const float s = sv[k];
    float b[NV][4];
    gather<VEC, NV>(b_row, base, R, lane, b);
    float wk = s;  // weight of B[c] in the output row
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
      wk = __fmul_rn(warp_sum(part), s);
      if (slab == 0 && lane == 0) mid[k] = wk;
    }
    if constexpr (OP != kSddmm) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[v][e] += round_contrib<T>(__fmul_rn(b[v][e], wk));
        }
      }
    }
  }
  if constexpr (OP != kSddmm) {
    store<VEC, NV>(out + static_cast<size_t>(out_row) * R, base, R, lane, acc);
  }
}

template <int OP, int NV, typename T>
void launch_nv(dim3 grid, cudaStream_t stream, bool vec, const Walk& w,
               const int* cols, const float* sv, const void* A, const void* B,
               float* out, float* mid, int R, int n_slabs) {
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  if (vec) {
    walk_kernel<OP, true, NV, T><<<grid, kThreads, 0, stream>>>(
        w, cols, sv, a, b, out, mid, R, n_slabs);
  } else {
    walk_kernel<OP, false, NV, T><<<grid, kThreads, 0, stream>>>(
        w, cols, sv, a, b, out, mid, R, n_slabs);
  }
}

// Launch one walk on `stream`; returns cudaGetLastError().
template <int OP>
int launch_walk(const Walk& w, const int* cols, const float* sv, const void* A,
                const void* B, float* out, float* mid, int R, int bf16,
                int vec, void* stream) {
  const int nv = R <= kWarp * 4 ? 1 : 4;
  const int slab = kWarp * 4 * nv;
  const int n_slabs = (R + slab - 1) / slab;
  const int blocks =
      w.n_items > 0 ? (w.n_items + kWarpsPerBlock - 1) / kWarpsPerBlock : 1;
  const dim3 grid(blocks, OP == kSddmm ? 1 : n_slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (nv == 1) {
      launch_nv<OP, 1, __nv_bfloat16>(grid, s, vec != 0, w, cols, sv, A, B, out,
                                      mid, R, n_slabs);
    } else {
      launch_nv<OP, 4, __nv_bfloat16>(grid, s, vec != 0, w, cols, sv, A, B, out,
                                      mid, R, n_slabs);
    }
  } else if (nv == 1) {
    launch_nv<OP, 1, float>(grid, s, vec != 0, w, cols, sv, A, B, out, mid, R,
                            n_slabs);
  } else {
    launch_nv<OP, 4, float>(grid, s, vec != 0, w, cols, sv, A, B, out, mid, R,
                            n_slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

// Online-softmax merge of the pair (m2, d2) into (m, d).
__device__ __forceinline__ void merge(float& m, float& d, float m2, float d2) {
  const float mn = fmaxf(m, m2);
  d = d * expf(m - mn) + d2 * expf(m2 - mn);
  m = mn;
}

// Masked max and sum-of-exp of slots [beg, end) by one warp: lanes stride
// over the slots keeping a running (max, rescaled sum) pair, then merge by
// shuffle. Every lane returns the warp's pair; (ATTN_NEG, 0) when no slot
// has gate != 0.
__device__ __forceinline__ void warp_row_stats(const float* __restrict__ gate,
                                               const float* __restrict__ logits,
                                               int beg, int end, int lane,
                                               float& m, float& d) {
  m = kAttnNeg;
  d = 0.f;
  for (int k = beg + lane; k < end; k += kWarp) {
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
}

inline int blocks_for(int n, int per_block) {
  return n > 0 ? (n + per_block - 1) / per_block : 1;
}

}  // namespace
