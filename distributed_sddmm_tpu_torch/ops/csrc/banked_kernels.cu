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
//     summed, the output row written once.
//   attn_stats_split: per segment, the masked (max, sum-of-exp) pair of
//     the stats walk (tile_common.cuh); attn_stats_merge: per heavy row,
//     its segments' pairs merged by the attn_merge_stats rule (max of the
//     maxima, each denominator rescaled into it), (ATTN_NEG, 0) for a row
//     with none.
// Pass 2 spreads a long row's segments over the warps of a block and over
// several blocks (see "split pass 2" below). One owner per output slot,
// row or segment; the only atomic is pass 2's per-row counter, which picks
// the block that adds a row's chunk partials, never their order; every
// sum runs in an order fixed by the data's shape, so two launches agree
// bit for bit. Splitting re-associates
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

// ----------------------------------------------------------- split pass 2
//
// split_reduce and attn_stats_merge walk the band's unit table
// (codegen/banded.py::reduce_units): units [0, n_short) are whole rows of
// at most chunk/4 segments, taken a warp each, kRedWarps to a block; the
// units after them are chunks of at most `chunk` segments of the longer
// rows, a block each. Inside a block every worker (a warp, or a lane of
// it) takes a contiguous run of the chunk's segments in order, with
// kRedUnroll loads in flight, and the workers' partials are combined in
// worker order through shared memory. A row of one chunk is written by
// its block. A row of several writes each chunk's partial to a scratch
// row (the wrapper's `partial`, one row a chunk unit); the block that
// finds, by the row's counter, that it finished last combines the row's
// chunk partials the same way, in chunk order, writes the row and puts
// the counter back to 0, so the next launch finds every counter at 0.
// The counter picks which block sums, never the order of the sum: two
// launches agree bit for bit. The merge, 8 bytes a segment, takes a row
// of up to kMergeRowSegs segments in one block, whatever its chunks. The
// longest serial chain is a worker's run (at most chunk/4 segments; the
// last block's workers take n/(kRedWarps*chunk) chunk partials each of a
// row of n segments), where the kernels before walked each row's
// segments on one chain (a hub row of 505 segments on Graph500 log_m=20,
// 512 on a bigbird 2**16 global row).
//
// Chosen on an H100 by bench/kernel_ab.py (PERF.md, section 6): 8 warps
// a block and chunk = 128 against 4 warps and chunk 16-256 (4 warps and
// chunk 64 read 4% less on Graph500 log_m=20 and 50% more on log_m=16).
//
// Bound on this card: split_reduce moves the workspace once (n_seg * R *
// 4 bytes) and writes the heavy rows; the merge moves 8 bytes a segment,
// far below a launch, so its time is the launch and the chain of
// dependent steps (load, exp, shuffles, fence, counter) one block takes.

constexpr int kRedWarps = 8;
constexpr int kRedThreads = kRedWarps * kWarp;
constexpr int kRedUnroll = 8;
// A heavy row of at most this many segments is merged by one block of
// the merge kernel (8 bytes a segment: at most kMergeRowSegs / kRedThreads
// pairs a thread), so it pays no counter and no second round of loads.
constexpr int kMergeRowSegs = 1024;

// The unit table of a heavy band and its per-row counters.
struct Units {
  const int* seg_ptr;   // [n_rows + 1]: band row i's segments
  const int* rows;      // [n_rows]: the tile row of band row i
  const int* unit_row;  // [n_units]: band row of the unit
  const int* unit_beg;  // [n_units]: its segments [unit_beg, unit_end)
  const int* unit_end;
  int* counters;        // [n_rows], 0 between launches
  int n_short;
  int n_units;
  int chunk;
};

inline int unit_blocks(const Units& u) {
  return (u.n_short + kRedWarps - 1) / kRedWarps + (u.n_units - u.n_short);
}

// Start of worker k's run when n items are cut into K contiguous runs.
__device__ __forceinline__ int run_at(int beg, int n, int k, int K) {
  return beg + static_cast<int>(static_cast<long long>(n) * k / K);
}

// Called by the whole block after it wrote its chunk's partial: true in
// the block that finished the row's last chunk (the counter is then back
// at 0). Release: each writer fences before the barrier; acquire: the
// last block fences after the counter, and reads partials with ld.cg.
__device__ __forceinline__ bool last_of_row(int* counter, int n_chunks) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == n_chunks - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <bool VEC>
struct RedVec {
  using T = float;
  static constexpr int W = 1;
};
template <>
struct RedVec<true> {
  using T = float4;
  static constexpr int W = 4;
};

__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ float4 shfl(const float4& v, int src) {
  return make_float4(shfl(v.x, src), shfl(v.y, src), shfl(v.z, src),
                     shfl(v.w, src));
}
template <bool CG, class T>
__device__ __forceinline__ T load_red(const T* p) {
  if constexpr (CG) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

// Lanes that cover one row's vectors (fc of them): up to a warp, a power
// of two; a warp then takes kWarp / lanes runs side by side.
__device__ __forceinline__ int red_lanes(int fc) {
  int g = 1;
  while (g < fc && g < kWarp) g <<= 1;
  return g;
}

// Sum of rows [b, e) of src (fc vectors a row) at vector v, in row order,
// kRedUnroll rows in flight: a batch issues its loads unconditionally (a
// row past e reloads row e-1) before its adds, and only the adds of rows
// below e are taken, so no load waits on a branch or on an add.
template <bool CG, class T>
__device__ __forceinline__ T run_sum(const T* __restrict__ src, int fc, int v,
                                     int b, int e) {
  T acc{};
  for (int s = b; s < e; s += kRedUnroll) {
    T r[kRedUnroll];
#pragma unroll
    for (int j = 0; j < kRedUnroll; ++j) {
      r[j] = load_red<CG>(src + static_cast<size_t>(min(s + j, e - 1)) * fc + v);
    }
#pragma unroll
    for (int j = 0; j < kRedUnroll; ++j) {
      if (s + j < e) vadd(acc, r[j]);
    }
  }
  return acc;
}

// The whole block: dst[0:R] = the sum of rows [beg, end) of src (R floats
// a row). Worker k = (warp, run) takes the k-th contiguous run; the
// partials meet in shared memory, laid out [thread][W], and are added in
// worker order, a thread a feature, one slab of lanes * W features at a
// time.
template <bool VEC, bool CG>
__device__ void block_sum(const float* __restrict__ src, int beg, int end,
                          int R, float* __restrict__ dst) {
  using T = typename RedVec<VEC>::T;
  constexpr int W = RedVec<VEC>::W;
  __shared__ __align__(16) float part[kRedThreads * 4];
  const int fc = R / W;
  const int G = red_lanes(fc);
  const int P = kWarp / G;
  const int lane = threadIdx.x % kWarp;
  const int K = kRedWarps * P;
  const int k = threadIdx.x / kWarp * P + lane / G;
  const int n = end - beg;
  const int b = run_at(beg, n, k, K), e = run_at(beg, n, k + 1, K);
  const T* s = reinterpret_cast<const T*>(src);
  for (int v0 = 0; v0 < fc; v0 += G) {
    const int v = v0 + lane % G;
    const T acc = v < fc ? run_sum<CG>(s, fc, v, b, e) : T{};
    *reinterpret_cast<T*>(part + threadIdx.x * W) = acc;
    __syncthreads();
    const int t = threadIdx.x;
    if (t < G * W && v0 * W + t < R) {
      float sum = 0.f;
      for (int q = 0; q < K; ++q) sum += part[q * G * W + t];
      dst[v0 * W + t] = sum;
    }
    __syncthreads();
  }
}

// One warp: out row = the sum of rows [beg, end) of work, its P runs side
// by side, added in run order by shuffles.
template <bool VEC>
__device__ void warp_sum(const float* __restrict__ work, int beg, int end,
                         int R, float* __restrict__ dst) {
  using T = typename RedVec<VEC>::T;
  constexpr int W = RedVec<VEC>::W;
  const int fc = R / W;
  const int G = red_lanes(fc);
  const int P = kWarp / G;
  const int lane = threadIdx.x % kWarp;
  const int gl = lane % G, p = lane / G;
  const int n = end - beg;
  const int b = run_at(beg, n, p, P), e = run_at(beg, n, p + 1, P);
  const T* s = reinterpret_cast<const T*>(work);
  for (int v0 = 0; v0 < fc; v0 += G) {
    const int v = v0 + gl;
    const T acc = v < fc ? run_sum<false>(s, fc, v, b, e) : T{};
    T sum = acc;
    for (int j = 1; j < P; ++j) {
      const T o = shfl(acc, gl + j * G);
      vadd(sum, o);
    }
    if (p == 0 && v < fc) reinterpret_cast<T*>(dst)[v] = sum;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kRedThreads)
split_reduce_kernel(Units u, const float* __restrict__ work,
                    float* __restrict__ out, float* __restrict__ partial,
                    int R) {
  const int packed = (u.n_short + kRedWarps - 1) / kRedWarps;
  if (static_cast<int>(blockIdx.x) < packed) {
    const int w = blockIdx.x * kRedWarps + threadIdx.x / kWarp;
    if (w >= u.n_short) return;
    const int i = u.unit_row[w];
    warp_sum<VEC>(work, u.unit_beg[w], u.unit_end[w], R,
                  out + static_cast<size_t>(u.rows[i]) * R);
    return;
  }
  const int c = static_cast<int>(blockIdx.x) - packed + u.n_short;
  if (c >= u.n_units) return;
  const int i = u.unit_row[c];
  const int beg = u.unit_beg[c];
  const int rb = u.seg_ptr[i];
  const int n_chunks = (u.seg_ptr[i + 1] - rb + u.chunk - 1) / u.chunk;
  float* row_out = out + static_cast<size_t>(u.rows[i]) * R;
  if (n_chunks == 1) {
    block_sum<VEC, false>(work, beg, u.unit_end[c], R, row_out);
    return;
  }
  block_sum<VEC, false>(work, beg, u.unit_end[c], R,
                        partial + static_cast<size_t>(c - u.n_short) * R);
  if (!last_of_row(u.counters + i, n_chunks)) return;
  const int first = c - u.n_short - (beg - rb) / u.chunk;
  block_sum<VEC, true>(partial, first, first + n_chunks, R, row_out);
}

// (m, d) of the pairs [b, e) of (pm, pd): m the max, d the sum of
// pd * exp(pm - m) in order; (ATTN_NEG, 0) for none.
template <bool CG>
__device__ __forceinline__ void run_merge(const float* __restrict__ pm,
                                          const float* __restrict__ pd, int b,
                                          int e, float& m, float& d) {
  m = kAttnNeg;
  for (int s = b; s < e; ++s) m = fmaxf(m, load_red<CG>(pm + s));
  d = 0.f;
  for (int s = b; s < e; ++s) {
    d = __fadd_rn(d, __fmul_rn(load_red<CG>(pd + s),
                               expf(load_red<CG>(pm + s) - m)));
  }
}

// The warp's pairs merged, the same in every lane: a butterfly max, each
// d rescaled into it, a butterfly sum (lanes j and j^o add the same two
// values, so all lanes end on the same bits).
__device__ __forceinline__ void warp_merge(float& m, float& d) {
  float M = m;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
  d = __fmul_rn(d, expf(m - M));
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) d = __fadd_rn(d, __shfl_xor_sync(kFull, d, o));
  m = M;
}

// The whole block: the merged (m, d) of the pairs [beg, end), thread k
// taking the k-th contiguous run, warps merged in warp order; the result
// is written by thread 0.
template <bool CG>
__device__ void block_merge(const float* __restrict__ pm,
                            const float* __restrict__ pd, int beg, int end,
                            float* m_dst, float* d_dst) {
  __shared__ float wm_s[kRedWarps], wd_s[kRedWarps];
  const int n = end - beg;
  float m, d;
  run_merge<CG>(pm, pd, run_at(beg, n, threadIdx.x, kRedThreads),
                run_at(beg, n, threadIdx.x + 1, kRedThreads), m, d);
  warp_merge(m, d);
  if (threadIdx.x % kWarp == 0) {
    wm_s[threadIdx.x / kWarp] = m;
    wd_s[threadIdx.x / kWarp] = d;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = kAttnNeg;
    for (int w = 0; w < kRedWarps; ++w) M = fmaxf(M, wm_s[w]);
    float D = 0.f;
    for (int w = 0; w < kRedWarps; ++w) {
      D = __fadd_rn(D, __fmul_rn(wd_s[w], expf(wm_s[w] - M)));
    }
    *m_dst = M;
    *d_dst = D;
  }
}

__global__ void __launch_bounds__(kRedThreads)
attn_merge_kernel(Units u, const float* __restrict__ wm,
                  const float* __restrict__ wd, float* __restrict__ m_out,
                  float* __restrict__ d_out, float* __restrict__ partial) {
  const int packed = (u.n_short + kRedWarps - 1) / kRedWarps;
  if (static_cast<int>(blockIdx.x) < packed) {
    const int w = blockIdx.x * kRedWarps + threadIdx.x / kWarp;
    if (w >= u.n_short) return;
    const int beg = u.unit_beg[w];
    const int n = u.unit_end[w] - beg;
    const int lane = threadIdx.x % kWarp;
    float m, d;
    run_merge<false>(wm, wd, run_at(beg, n, lane, kWarp),
                     run_at(beg, n, lane + 1, kWarp), m, d);
    warp_merge(m, d);
    if (lane == 0) {
      const int r = u.rows[u.unit_row[w]];
      m_out[r] = m;
      d_out[r] = d;
    }
    return;
  }
  const int c = static_cast<int>(blockIdx.x) - packed + u.n_short;
  if (c >= u.n_units) return;
  const int i = u.unit_row[c];
  const int beg = u.unit_beg[c];
  const int rb = u.seg_ptr[i];
  const int n = u.seg_ptr[i + 1] - rb;
  const int n_chunks = (n + u.chunk - 1) / u.chunk;
  const int r = u.rows[i];
  if (n_chunks == 1 || n <= kMergeRowSegs) {
    // The row's first block merges it all; its other blocks leave.
    if (beg == rb) block_merge<false>(wm, wd, rb, rb + n, m_out + r, d_out + r);
    return;
  }
  // partial: the chunk units' m, then their d.
  const int n_part = u.n_units - u.n_short;
  const int k = c - u.n_short;
  block_merge<false>(wm, wd, beg, u.unit_end[c], partial + k,
                     partial + n_part + k);
  if (!last_of_row(u.counters + i, n_chunks)) return;
  const int first = k - (beg - rb) / u.chunk;
  block_merge<true>(partial, partial + n_part, first, first + n_chunks,
                    m_out + r, d_out + r);
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
                            const int* unit_row, const int* unit_beg,
                            const int* unit_end, int* counters,
                            const float* work, float* out, float* partial,
                            int n_short, int n_units, int chunk, int R, int vec,
                            void* stream) {
  const Units u{seg_ptr, rows,     unit_row, unit_beg, unit_end,
                counters, n_short, n_units,  chunk};
  const int grid = unit_blocks(u) > 0 ? unit_blocks(u) : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    split_reduce_kernel<true><<<grid, kRedThreads, 0, s>>>(u, work, out, partial, R);
  } else {
    split_reduce_kernel<false><<<grid, kRedThreads, 0, s>>>(u, work, out, partial, R);
  }
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
                                const int* unit_row, const int* unit_beg,
                                const int* unit_end, int* counters,
                                const float* wm, const float* wd, float* m,
                                float* d, float* partial, int n_short,
                                int n_units, int chunk, void* stream) {
  const Units u{seg_ptr, rows,     unit_row, unit_beg, unit_end,
                counters, n_short, n_units,  chunk};
  const int grid = unit_blocks(u) > 0 ? unit_blocks(u) : 1;
  attn_merge_kernel<<<grid, kRedThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, wm, wd, m, d, partial);
  return static_cast<int>(cudaGetLastError());
}
