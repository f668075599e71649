// Device code shared by tile_kernels.cu, attn_kernels.cu and
// banked_kernels.cu: operand loads at the bf16 rounding points, the one
// walk of the SDDMM / SpMM / fused tile kernels and its launch, and the
// walk of the masked-softmax row statistics.
//
// Everything sits in an anonymous namespace: each source compiles its own
// copy, so no kernel symbol is shared between the objects of the library.
//
// What a walk walks. An "item" is a whole tile row (the generic kernel,
// item i -> row i), a row of a band's row list (item i -> row
// row_ids[i]), or one segment of a heavy row (item i -> slots
// seg_beg[i]..seg_end[i] of row seg_row[i], its partial output written to
// row i of a workspace). One owner per output row, segment and slot, no
// atomics, and every sum runs in a fixed order, so two launches agree bit
// for bit.
//
// The tile walk (dot_walk_kernel<OP>, OP = SDDMM, SpMM or fused). Walked
// one slot after another, each nonzero would be one serial chain a warp
// (index load, one B row, for a dot a 5-step shuffle reduction, one
// store). Instead:
//  * Lanes sized to the row: a group of G lanes walks one item, each lane
//    holding 16 features of a row for a dot (four 16-byte f32 loads or two
//    of bf16; G = R/16) and one 16-byte load's for the SpMM (G = R/4 in
//    f32, R/8 in bf16), up to a warp, and a warp walks 32/G items at once;
//    a short row no longer holds a whole warp. The scalar path (R % 4 !=
//    0, bf16 with R % 8 != 0, unaligned operands) gives each item the
//    warp, one feature a lane per load.
//  * Index loads leave the chain: a group loads G slots' cols and sv with
//    one load a lane, a chunk ahead, and hands them out with __shfl_sync.
//  * Several B rows in flight: a batch is U slots of each group's item
//    (kDotBatchRegs or kSpmmBatchRegs registers of raw row data a lane, U
//    at most G), so a warp has U*32/G rows of loads in flight, L1-cached
//    (a window mask's neighbouring rows share most columns); the SDDMM
//    and fused prefetch the next batch's rows into L2 (no register) before
//    this batch is used.
//    Two deeper pipelines were tried on the card for the dot walk and lost
//    (PERF.md, section 6): a register double buffer (up to 199 registers a
//    thread) and a cp.async ring in shared memory, which takes the L1's
//    capacity from the window's reuse (window:64 SDDMM 7.0-9.5 ms against
//    4.7).
//  * SDDMM and fused: a lane's U partial dots are reduced together over
//    its group (reduce-scatter over the low lane bits, U-1 shuffles, then
//    log2(G/U) butterfly steps), leaving each lane one slot's dot; mid is
//    written with one store a batch for the warp's 32/G items.
//  * SpMM and fused: each slot's weight (sv for SpMM, the slot's dot for
//    fused) is broadcast by one shuffle and the slot's row scaled into the
//    item's output row, which the group keeps in registers and writes
//    once. Each output feature is summed over the item's slots in slot
//    order by one lane, acc += round(b * w) with no FMA, so the SpMM gives
//    the same bits as a walk of one slot after another.
// R above one slab (512 features) takes more slabs in blockIdx.y; a dot
// is over the whole row, over the slabs in order, so every slab sees the
// same mid. Tensor cores are not used: each gathered B element feeds 2
// flops (SDDMM, SpMM) or 4 (fused), at most one flop a byte, far below
// what wgmma needs to pay.
//
// The stats walk (stats_walk_kernel): per item, m = max z over the slots
// with gate != 0 and d = sum of exp(z - m) over them; (ATTN_NEG, 0) for
// an item with none. A group of kStatLanes lanes takes one item, in two
// passes over its slots: a shuffle max with no exp, then one expf a live
// slot (the second read comes from L1) and a shuffle sum. gate and logits
// come in 16-byte loads where both are 16-byte aligned (a scalar head and
// tail around each item's aligned run). An online rescale of (m, d) would
// cost two expf a merge step on the critical path; the two passes need
// none.
//
// bf16 mode: A and B are bf16, products accumulate in f32, each scatter
// contribution (B[c]*mid or B[c]*sv) is rounded to bf16 before it is
// added to the f32 output, as the TPU kernel rounds
// (distributed_sddmm_tpu/ops/pallas_kernels.py l.190, 218, 235, 258, 317,
// 357); mid and the output are f32. The stats are f32 in both modes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAttnNeg = -1e30f;  // ops/kernels.py::ATTN_NEG

enum Op { kSddmm = 0, kSpmm = 1, kFused = 2 };

inline int blocks_for(int n, int per_block) {
  return n > 0 ? (n + per_block - 1) / per_block : 1;
}

// Scatter contribution at the operand type's rounding point. In bf16,
// x rounded to bf16 and widened back: converting the pair (0, x) puts
// bf16(x) in the high half and zeros in the low half, which is the f32
// value itself (one instruction, where a conversion and a shift take two).
template <typename T>
__device__ __forceinline__ float round_contrib(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(0.f, x);
    return __uint_as_float(*reinterpret_cast<const unsigned*>(&h));
  } else {
    return x;
  }
}

// What one launch of a walk walks. Exactly one of three item kinds:
// seg_beg set: segments (seg_row, seg_beg, seg_end), output row = item
// (the stats walk reads no seg_row); row_ids set: the listed rows;
// neither: rows 0..n_items-1. The SDDMM or fused launch with zero_pads set
// also zeroes mid's pad slots [row_ptr[frame_rows], cap).
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

__device__ __forceinline__ void walk_item(const Walk& w, int item, int& row,
                                          int& beg, int& end, int& out_row) {
  if (w.seg_beg != nullptr) {
    row = w.seg_row != nullptr ? w.seg_row[item] : 0;
    beg = w.seg_beg[item];
    end = w.seg_end[item];
    out_row = item;
  } else {
    row = w.row_ids != nullptr ? w.row_ids[item] : item;
    beg = w.row_ptr[row];
    end = w.row_ptr[row + 1];
    out_row = row;
  }
}

// ------------------------------------------------------------ tile walk

// Raw register form of one load: E features of type T.
template <typename T, int E>
struct RawOf;
template <>
struct RawOf<float, 4> {
  using type = float4;
};
template <>
struct RawOf<float, 1> {
  using type = float;
};
template <>
struct RawOf<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct RawOf<__nv_bfloat16, 1> {
  using type = unsigned short;
};

__device__ __forceinline__ void load_raw(const float* p, float4& r) {
  r = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void load_raw(const float* p, float& r) {
  r = __ldg(p);
}
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, uint4& r) {
  r = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p,
                                         unsigned short& r) {
  r = __ldg(reinterpret_cast<const unsigned short*>(p));
}

// bf16 to f32 is exact: the 16 bits become the float's high half (the
// lower address holds the low half of a 32-bit word).
__device__ __forceinline__ float bf_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const float4& r, float x[4]) {
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}
__device__ __forceinline__ void unpack(float r, float x[1]) { x[0] = r; }
__device__ __forceinline__ void unpack(const uint4& r, float x[8]) {
  x[0] = bf_lo(r.x);
  x[1] = bf_hi(r.x);
  x[2] = bf_lo(r.y);
  x[3] = bf_hi(r.y);
  x[4] = bf_lo(r.z);
  x[5] = bf_hi(r.z);
  x[6] = bf_lo(r.w);
  x[7] = bf_hi(r.w);
}
__device__ __forceinline__ void unpack(unsigned short r, float x[1]) {
  x[0] = __uint_as_float(static_cast<unsigned>(r) << 16);
}

// Raw row registers a lane gives one batch. SDDMM and fused: 32, with the
// L2 prefetch of the next batch, PR 4's choice on the card (their A
// fragment and dot partials take the rest). SpMM: 32 (8 slots a batch at
// R = 128) and no prefetch, chosen on the card by bench/kernel_ab.py
// against 16 and 64 registers with and without it (PERF.md, section 6):
// the prefetch cost up to 28% on the L1-resident window tile.
constexpr int kDotBatchRegs = 32;
constexpr int kSpmmBatchRegs = 32;

// One launch's lane layout: a group of G lanes walks one item; lane gl of
// the group holds features base + (v*G + gl)*E + e (v < NV, e < E) of the
// item's A row, of each gathered B row and of its output row.
template <typename T, int G_, int E_, int NV_, int BATCH_REGS>
struct DotLayout {
  using Elem = T;
  using Raw = typename RawOf<T, E_>::type;
  static constexpr int G = G_;
  static constexpr int E = E_;
  static constexpr int NV = NV_;
  static constexpr int NG = kWarp / G;      // items a warp walks at once
  static constexpr int SLAB = G * E * NV;   // features a group covers
  static constexpr int RAW_REGS = NV * ((static_cast<int>(sizeof(Raw)) + 3) / 4);
  // Slots a group takes per batch: BATCH_REGS registers of raw row data a
  // lane, and at most G (one index chunk holds G slots; the dot's
  // reduce-scatter leaves one of U dots a lane).
  static constexpr int U = G < BATCH_REGS / RAW_REGS ? G : BATCH_REGS / RAW_REGS;
  static_assert(U >= 1 && G % U == 0, "a batch divides an index chunk");
};

constexpr int kMaxSlab = 512;

template <class L>
__device__ __forceinline__ void load_frag(const typename L::Elem* row, bool ok,
                                          int base, int R, int gl,
                                          typename L::Raw r[L::NV]) {
#pragma unroll
  for (int v = 0; v < L::NV; ++v) {
    const int f = base + (v * L::G + gl) * L::E;
    if (ok && f < R) {
      load_raw(row + f, r[v]);
    } else {
      r[v] = typename L::Raw{};
    }
  }
}

template <class L>
__device__ __forceinline__ void unpack_frag(const typename L::Raw r[L::NV],
                                            float x[L::NV][L::E]) {
#pragma unroll
  for (int v = 0; v < L::NV; ++v) unpack(r[v], x[v]);
}

template <class L>
__device__ __forceinline__ void store_frag(float* __restrict__ row, int base,
                                           int R, int gl,
                                           const float x[L::NV][L::E]) {
#pragma unroll
  for (int v = 0; v < L::NV; ++v) {
    const int f = base + (v * L::G + gl) * L::E;
    if (f >= R) continue;
    if constexpr (L::E == 1) {
      row[f] = x[v][0];
    } else {
#pragma unroll
      for (int q = 0; q < L::E; q += 4) {
        *reinterpret_cast<float4*>(row + f + q) =
            make_float4(x[v][q], x[v][q + 1], x[v][q + 2], x[v][q + 3]);
      }
    }
  }
}

template <class L>
__device__ __forceinline__ float dot_acc(const float a[L::NV][L::E],
                                         const float b[L::NV][L::E], float p) {
#pragma unroll
  for (int v = 0; v < L::NV; ++v) {
#pragma unroll
    for (int e = 0; e < L::E; ++e) p = fmaf(a[v][e], b[v][e], p);
  }
  return p;
}

// The lane's partial dot over all slabs in order (R > one slab): its own
// slab from registers, the others gathered again (L1/L2).
template <class L>
__device__ float dot_slabs(const float a[L::NV][L::E],
                           const float x[L::NV][L::E],
                           const typename L::Elem* a_row,
                           const typename L::Elem* b_row, bool ok, int R,
                           int gl, int slab, int n_slabs) {
  float p = 0.f;
  for (int s2 = 0; s2 < n_slabs; ++s2) {
    if (s2 == slab) {
      p = dot_acc<L>(a, x, p);
    } else {
      typename L::Raw ra[L::NV], rb[L::NV];
      float a2[L::NV][L::E], b2[L::NV][L::E];
      load_frag<L>(a_row, true, s2 * L::SLAB, R, gl, ra);
      load_frag<L>(b_row, ok, s2 * L::SLAB, R, gl, rb);
      unpack_frag<L>(ra, a2);
      unpack_frag<L>(rb, b2);
      p = dot_acc<L>(a2, b2, p);
    }
  }
  return p;
}

// Sum each of the U partials over the group's G lanes. Reduce-scatter over
// lane bits below U (a lane keeps the half of its values its bit selects
// and adds its partner's), then a butterfly over the bits from U to G. The
// lane ends with the full dot of the batch's slot gl & (U-1); the G/U
// lanes holding one slot agree bit for bit (each add is commutative).
template <class L>
__device__ __forceinline__ float group_dot(float p[L::U], int gl) {
#pragma unroll
  for (int s = L::U / 2; s >= 1; s /= 2) {
    const bool hi = (gl & s) != 0;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = hi ? p[i] : p[i + s];
      const float keep = hi ? p[i + s] : p[i];
      p[i] = keep + __shfl_xor_sync(kFull, send, s);
    }
  }
  float d = p[0];
#pragma unroll
  for (int o = L::U; o < L::G; o <<= 1) d += __shfl_xor_sync(kFull, d, o);
  return d;
}

// G slots' indices and values of a group's item, one per lane (-1 and 0
// past the end).
struct Chunk {
  int col;
  float s;
};

__device__ __forceinline__ Chunk load_chunk(const int* __restrict__ cols,
                                            const float* __restrict__ sv,
                                            int k, int end) {
  Chunk c{-1, 0.f};
  if (k < end) {
    c.col = __ldg(cols + k);
    c.s = __ldg(sv + k);
  }
  return c;
}

// One batch in registers: the raw B rows of the group's U slots, their
// columns, and (SDDMM, fused) sv of the slot whose dot the lane ends up
// holding.
template <class L>
struct Batch {
  typename L::Raw b[L::U][L::NV];
  int c[L::U];
  float s;
};

// acc += round(row * w), feature by feature: no FMA, so each output
// feature's sum takes the same steps as a walk of one slot at a time.
template <class L>
__device__ __forceinline__ void scale_add(const typename L::Raw r[L::NV], float w,
                                          float acc[L::NV][L::E]) {
  float x[L::NV][L::E];
  unpack_frag<L>(r, x);
#pragma unroll
  for (int v = 0; v < L::NV; ++v) {
#pragma unroll
    for (int e = 0; e < L::E; ++e) {
      acc[v][e] += round_contrib<typename L::Elem>(__fmul_rn(x[v][e], w));
    }
  }
}

// The dot products of one batch (slots k0..k0+U-1 of the group's item),
// mid at its slots and, for fused, the item's output row.
template <int OP, class L>
__device__ __forceinline__ void consume_batch(
    const Batch<L>& bt, int k0, int end, int g, int gl, int slab, int n_slabs,
    const float a[L::NV][L::E], const typename L::Elem* a_row,
    const typename L::Elem* __restrict__ B, int R, float* __restrict__ mid,
    float acc[L::NV][L::E]) {
  float p[L::U];
#pragma unroll
  for (int u = 0; u < L::U; ++u) {
    float x[L::NV][L::E];
    unpack_frag<L>(bt.b[u], x);
    if constexpr (L::SLAB < kMaxSlab) {
      p[u] = dot_acc<L>(a, x, 0.f);
    } else if (n_slabs == 1) {
      p[u] = dot_acc<L>(a, x, 0.f);
    } else {
      const int c = bt.c[u];
      p[u] = dot_slabs<L>(a, x, a_row, B + static_cast<size_t>(c < 0 ? 0 : c) * R,
                          c >= 0, R, gl, slab, n_slabs);
    }
  }
  const float wk = __fmul_rn(group_dot<L>(p, gl), bt.s);
  const int k = k0 + (gl & (L::U - 1));
  if (slab == 0 && gl < L::U && k < end) mid[k] = wk;
  if constexpr (OP == kFused) {
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      scale_add<L>(bt.b[u], __shfl_sync(kFull, wk, g * L::G + u), acc);
    }
  }
}

// Ask L2 for the 128-byte line at p (no register, no wait): the next
// batch's rows start on their way from HBM while this batch is used.
// One batch ahead: two or four batches ahead read 5-33% slower at full
// size on the card (PERF.md, section 6).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <int OP, class L>
__global__ void __launch_bounds__(kThreads)
dot_walk_kernel(Walk w, const int* __restrict__ cols,
                const float* __restrict__ sv,
                const typename L::Elem* __restrict__ A,
                const typename L::Elem* __restrict__ B,
                float* __restrict__ out, float* __restrict__ mid, int R,
                int n_slabs) {
  constexpr int kPerChunk = L::G / L::U;  // batches per index chunk
  constexpr bool kDot = OP != kSpmm;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / L::G;
  const int gl = lane % L::G;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int item = warp * L::NG + g;
  const int slab = blockIdx.y;
  const int base = slab * L::SLAB;

  if (kDot && w.zero_pads && slab == 0) {
    const int stride = gridDim.x * blockDim.x;
    for (int k = w.row_ptr[w.frame_rows] + blockIdx.x * blockDim.x + threadIdx.x;
         k < w.cap; k += stride) {
      mid[k] = 0.f;
    }
  }
  if (warp * L::NG >= w.n_items) return;  // warp-uniform: no item here

  // A group past the last item walks an empty range and writes nothing.
  int row = 0, beg = 0, end = 0, out_row = 0;
  if (item < w.n_items) walk_item(w, item, row, beg, end, out_row);
  const typename L::Elem* a_row = kDot ? A + static_cast<size_t>(row) * R : nullptr;
  float a[L::NV][L::E] = {};
  if constexpr (kDot) {
    typename L::Raw r[L::NV];
    load_frag<L>(a_row, item < w.n_items, base, R, gl, r);
    unpack_frag<L>(r, a);
  }
  float acc[L::NV][L::E] = {};

  // The warp walks as many batches as its longest item needs; `ch` is the
  // index chunk of the batch being gathered, `nxt` the one after it.
  const int nb = __reduce_max_sync(kFull, (end - beg + L::U - 1) / L::U);
  Chunk ch = load_chunk(cols, sv, beg + gl, end);
  Chunk nxt = load_chunk(cols, sv, beg + L::G + gl, end);
  auto advance = [&](int i) {  // about to gather batch i > 0
    if (i % kPerChunk == 0) {
      ch = nxt;
      nxt = load_chunk(cols, sv, beg + (i / kPerChunk + 1) * L::G + gl, end);
    }
  };

  // Each batch: the group's U rows gathered into registers (L1-cached
  // loads), for a dot the next batch's rows prefetched into L2 (lane gl
  // takes line gl % kLines of the next batch's slot gl / kLines), then the
  // batch used.
  constexpr int kLineElems = 128 / static_cast<int>(sizeof(typename L::Elem));
  constexpr int kLines = (L::SLAB + kLineElems - 1) / kLineElems;  // a row's
  static_assert(L::U * kLines <= L::G, "one prefetch a lane covers a batch");
  for (int i = 0; i < nb; ++i) {
    if (i > 0) advance(i);
    Batch<L> bt;
    const int j0 = g * L::G + (i % kPerChunk) * L::U;
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const int c = __shfl_sync(kFull, ch.col, j0 + u);
      bt.c[u] = c;
      load_frag<L>(B + static_cast<size_t>(c < 0 ? 0 : c) * R, c >= 0, base, R,
                   gl, bt.b[u]);
    }
    if (kDot && i + 1 < nb) {
      const Chunk& next = (i + 1) % kPerChunk == 0 ? nxt : ch;
      const int q = gl < L::U * kLines ? gl : 0;
      const int c = __shfl_sync(
          kFull, next.col, g * L::G + ((i + 1) % kPerChunk) * L::U + q / kLines);
      const int f = base + (q % kLines) * kLineElems;
      if (gl < L::U * kLines && c >= 0 && f < R) {
        prefetch_l2(B + static_cast<size_t>(c) * R + f);
      }
    }
    if constexpr (kDot) {
      bt.s = __shfl_sync(kFull, ch.s, j0 + (gl & (L::U - 1)));
      consume_batch<OP, L>(bt, beg + i * L::U, end, g, gl, slab, n_slabs, a,
                           a_row, B, R, mid, acc);
    } else {
#pragma unroll
      for (int u = 0; u < L::U; ++u) {
        scale_add<L>(bt.b[u], __shfl_sync(kFull, ch.s, j0 + u), acc);
      }
    }
  }

  if constexpr (OP != kSddmm) {
    if (item < w.n_items) {
      store_frag<L>(out + static_cast<size_t>(out_row) * R, base, R, gl, acc);
    }
  }
}

template <int OP, typename T, int G, int E, int NV>
void launch_dot(int n_items, cudaStream_t stream, const Walk& w,
                const int* cols, const float* sv, const void* A,
                const void* B, float* out, float* mid, int R) {
  using L = DotLayout<T, G, E, NV, OP == kSpmm ? kSpmmBatchRegs : kDotBatchRegs>;
  const int n_slabs = (R + L::SLAB - 1) / L::SLAB;
  const dim3 grid(blocks_for(n_items, kWarpsPerBlock * L::NG),
                  OP == kSddmm ? 1 : n_slabs);
  dot_walk_kernel<OP, L><<<grid, kThreads, 0, stream>>>(
      w, cols, sv, static_cast<const T*>(A), static_cast<const T*>(B), out,
      mid, R, n_slabs);
}

// Lanes per item from R and the type. Vector path: F features a lane, G =
// R/F lanes from 4 up to the warp, and above 32*F features a warp's slabs
// of 512 (16 features a lane; more slabs in blockIdx.y). SDDMM and fused:
// F = 16, so a dot is reduced over few lanes. SpMM: F = one 16-byte load
// (4 features in f32, 8 in bf16), so a row takes as many lanes as it can
// and a warp walks fewer rows to the longest one's end: with F = 16 the
// SpMM read up to 28% slower than the parent on the Graph500 bands and
// the headline tile (PERF.md, section 6). Scalar path: one feature a lane
// per load.
template <int OP, typename T>
void launch_dot_type(cudaStream_t stream, bool vec, const Walk& w,
                     const int* cols, const float* sv, const void* A,
                     const void* B, float* out, float* mid, int R) {
  constexpr int E = std::is_same<T, float>::value ? 4 : 8;
  constexpr int NV = 16 / E;
  constexpr int NVF = OP == kSpmm ? 1 : NV;  // loads a lane, below a slab
  constexpr int F = NVF * E;
  const int n = w.n_items;
  if (vec && R <= 4 * F) {
    launch_dot<OP, T, 4, E, NVF>(n, stream, w, cols, sv, A, B, out, mid, R);
  } else if (vec && R <= 8 * F) {
    launch_dot<OP, T, 8, E, NVF>(n, stream, w, cols, sv, A, B, out, mid, R);
  } else if (vec && R <= 16 * F) {
    launch_dot<OP, T, 16, E, NVF>(n, stream, w, cols, sv, A, B, out, mid, R);
  } else if (vec && R <= 32 * F) {
    launch_dot<OP, T, 32, E, NVF>(n, stream, w, cols, sv, A, B, out, mid, R);
  } else if (vec) {
    launch_dot<OP, T, 32, E, NV>(n, stream, w, cols, sv, A, B, out, mid, R);
  } else if (R <= 128) {
    launch_dot<OP, T, 32, 1, 4>(n, stream, w, cols, sv, A, B, out, mid, R);
  } else {
    launch_dot<OP, T, 32, 1, 16>(n, stream, w, cols, sv, A, B, out, mid, R);
  }
}

// Launch one walk on `stream`; returns cudaGetLastError(). vec: R % 4 == 0
// and 16-byte aligned operands (bf16 loads 16 bytes, so also R % 8 == 0).
template <int OP>
int launch_walk(const Walk& w, const int* cols, const float* sv, const void* A,
                const void* B, float* out, float* mid, int R, int bf16,
                int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_dot_type<OP, __nv_bfloat16>(s, vec != 0 && R % 8 == 0, w, cols, sv,
                                       A, B, out, mid, R);
  } else {
    launch_dot_type<OP, float>(s, vec != 0, w, cols, sv, A, B, out, mid, R);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- stats walk

// Lanes an item of the stats walk: chosen on the card by
// bench/kernel_ab.py (PERF.md, section 6).
constexpr int kStatLanes = 16;

// f(gate[k], logits[k]) for the slots [beg, end) that lane gl of a group of
// GL lanes takes. VEC: gate and logits are 16-byte aligned, and the
// item's aligned run goes in 16-byte loads (lane gl takes every GL-th
// quad), its head and tail (at most 3 slots each) one slot a lane.
template <int GL, bool VEC, class F>
__device__ __forceinline__ void for_each_slot(const float* __restrict__ gate,
                                              const float* __restrict__ logits,
                                              int beg, int end, int gl, F f) {
  static_assert(GL >= 4, "head and tail take a lane a slot");
  if constexpr (VEC) {
    const int a = min((beg + 3) & ~3, end);
    const int b = max(end & ~3, a);
    if (gl < a - beg) f(__ldg(gate + beg + gl), __ldg(logits + beg + gl));
    if (gl < end - b) f(__ldg(gate + b + gl), __ldg(logits + b + gl));
#pragma unroll 4
    for (int k = a + 4 * gl; k < b; k += 4 * GL) {
      const float4 g4 = __ldg(reinterpret_cast<const float4*>(gate + k));
      const float4 z4 = __ldg(reinterpret_cast<const float4*>(logits + k));
      f(g4.x, z4.x);
      f(g4.y, z4.y);
      f(g4.z, z4.z);
      f(g4.w, z4.w);
    }
  } else {
#pragma unroll 4
    for (int k = beg + gl; k < end; k += GL) f(__ldg(gate + k), __ldg(logits + k));
  }
}

template <int GL, bool VEC>
__global__ void __launch_bounds__(kThreads)
stats_walk_kernel(Walk w, const float* __restrict__ gate,
                  const float* __restrict__ logits, float* __restrict__ m_out,
                  float* __restrict__ d_out) {
  constexpr int kItems = kWarp / GL;  // items a warp takes at once
  const int lane = threadIdx.x % kWarp;
  const int gl = lane % GL;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int item = warp * kItems + lane / GL;
  if (warp * kItems >= w.n_items) return;  // warp-uniform: no item here

  // A group past the last item walks an empty range and writes nothing.
  int row = 0, beg = 0, end = 0, out_row = 0;
  if (item < w.n_items) walk_item(w, item, row, beg, end, out_row);
  float m = kAttnNeg;
  for_each_slot<GL, VEC>(gate, logits, beg, end, gl, [&](float g, float z) {
    m = fmaxf(m, g != 0.f ? z : kAttnNeg);
  });
#pragma unroll
  for (int o = GL / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  float d = 0.f;
  for_each_slot<GL, VEC>(gate, logits, beg, end, gl, [&](float g, float z) {
    const float e = expf(z - m);  // discarded where masked, inf or not
    d += g != 0.f ? e : 0.f;
  });
#pragma unroll
  for (int o = GL / 2; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
  if (item < w.n_items && gl == 0) {
    m_out[out_row] = m;
    d_out[out_row] = d;
  }
}

// Launch the stats walk, GL lanes an item, on `stream`; returns
// cudaGetLastError().
template <int GL>
int launch_stats(const Walk& w, const float* gate, const float* logits,
                 float* m, float* d, void* stream) {
  const bool vec = ((reinterpret_cast<std::uintptr_t>(gate) |
                     reinterpret_cast<std::uintptr_t>(logits)) & 15) == 0;
  const int grid = blocks_for(w.n_items, kWarpsPerBlock * (kWarp / GL));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    stats_walk_kernel<GL, true><<<grid, kThreads, 0, s>>>(w, gate, logits, m, d);
  } else {
    stats_walk_kernel<GL, false><<<grid, kThreads, 0, s>>>(w, gate, logits, m, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
