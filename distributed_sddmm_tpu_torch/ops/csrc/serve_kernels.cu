// Per-request serving kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (distributed_sddmm_tpu_torch/ops/_build.py
// and ops/serve_kernels.py).
//
// What they replace. No TPU kernel: the JAX package's per-request serving
// programs are jnp code under jax.jit (distributed_sddmm_tpu/serve/
// workloads.py), and reach no Pallas kernel:
//   fold_in_solve  ALSFoldInTopK.build_program l.317-326: the masked rows
//                  B[idx]*mask, gram = rows^T rows + lam*I, rhs = rows^T
//                  (ratings*mask), and _chol_solve (l.92): Cholesky, then
//                  forward and back substitution
//   score_rows     out[i][j] = sum_r Q[i][r] * T[t_j][r]: the ALS scores
//                  x . B[j] of every item (l.329) and the GAT node scores
//                  X[node] . w (GATNodeScore, l.921-923)
//   window_score   AttentionTokenScore.build_program l.617-686: the +-w
//                  neighbourhood's logits / sqrt(R), masked max, exp,
//                  denominator and the weighted head values, with the
//                  per-request window:p / topk:p keep rule of dynamic mode
// On the card torch ops cannot stand in for them: cuBLAS picks its kernel,
// and so its summation order, from the shapes, the batch count included,
// and torch's CUDA reductions pick their split from the number of outputs,
// so a request's bits would depend on its neighbours in the batch.
//
// Design. Every output has one accumulator, summed in a fixed order
// (ascending r, l, k or neighbour), each product and each sum rounded
// apart (__fmul_rn, __fadd_rn: no contraction into fma), which is the
// order and rounding of the plain versions in ops/serve_kernels.py. The
// tiling, the grid and the load path may follow the shapes (and the
// alignment of T), but no output's chain does: it depends on R, L and
// the window alone, never on the batch size, a request's slot in the
// batch or padding, so a request's reply bits do not depend on what else
// was batched or padded.
//   fold_in_solve: one block a request (fold_in_launch in
//     ops/serve_kernels.py). The masked rows, the Gram (rows of an odd
//     count of 16-byte words against bank conflicts), rhs and L's diagonal
//     sit in shared memory (102,656 bytes at R = 128, L = 64; the wrapper
//     raises when they do not fit).
//     - The rows come in 16-byte loads, all of a thread's at once; the
//       Gram in 4 x 4 register tiles of the lower triangle, over 16 warps:
//       each loaded row value feeds four products, each entry is still one
//       accumulator over ascending l.
//     - Left-looking Cholesky in place, by the warps of the R row owners
//       and one helper warp after them (the other warps leave), on a
//       barrier of their own, one a column. The owner of row i is fixed
//       across columns: it keeps s_i = sum_{k<i} L[i][k]^2 in a register,
//       adding L[i][k]^2 (ascending k) as it writes L[i][k], and publishes
//       it; at column j the helper turns s_j into diag[j] = sqrt(G[j][j] -
//       s_j), once, while the owners of rows i > j run their dots, which
//       then wait for it (a flag: diag starts at kUnset).
//     - The dots sum_{k<j} L[i][k] L[j][k] read 16 bytes at a time, the
//       next eight terms loaded before this eight's adds, so only the
//       __fadd_rn latency is on the chain.
//     - The helper warp runs the forward substitution L y = rhs one column
//       behind the factor and then the back substitution L^T x = y: lane l
//       keeps rows l, l + 32, ... of v (then y, then x) in registers, the
//       owner of row j divides and __shfl_sync broadcasts y_j (x_j); row j
//       - 1 is loaded a step ahead in the back substitution.
//   score_rows: a persistent grid of warps (score_launch in
//     ops/serve_kernels.py picks the shape from n_i, n_j and R). A warp
//     takes tiles of kScoreItems outputs j, one a lane, and walks each in
//     R chunks of RC features, ascending, through a ring of kScoreStages
//     shared-memory stages of its own: 16-byte cp.async copies of the T
//     rows (gathered through tidx) of the chunks ahead are in flight while
//     this chunk is summed, and a lane's accumulators stay in registers
//     from chunk to chunk. Stage rows are padded to RC + 4 floats (an odd
//     number of 16-byte words), so a lane's 16-byte reads of its own row
//     hit distinct banks. The queries are staged once a block, interleaved
//     as [group][r][kQ], so two broadcast 16-byte reads give a lane the
//     kQ queries of feature r (one query alone is a group of 1, so that
//     the GAT head does no padded work); more than kQ queries take groups,
//     one after another (each group re-reads the tile's rows). Shared
//     memory no longer grows with R but for the queries: at the GAT head
//     (R = 512) many warps run at once, and a small n_j gets wide chunks
//     and one-warp blocks so that more SMs share it.
//   window_score: a block a token slot (window_launch in
//     ops/serve_kernels.py: round32(2W) threads, at most 1024, W = 2w + 1),
//     padded slots too. The neighbour rows, clamped into the context, are
//     one range of K's rows that holds the query row too: each distinct
//     row of it comes into shared memory once (a slot at the context's
//     edge, as every padded slot is, needs fewer), with the head, in R
//     chunks of RC features (64; 32 where R <= 32 or 64 does not fit; 4
//     for the widest windows), through a ring of kWinStages stages:
//     16-byte cp.async copies through L1 (4-byte where R % 4 or the
//     alignment of K or head forbid), consecutive threads on consecutive
//     words of a row, the chunks ahead in flight while this one is summed.
//     Stage rows are padded to an odd count of 16-byte words, so the chain
//     threads' 16-byte reads of their own rows hit distinct banks. The 2W
//     chains run on their own threads where 2W <= 1024 (else a thread
//     takes chains tid, tid + 1024, ...): chain o < W sums dot_o = sum_r
//     q[r] kn_o[r], chain W + o hv_o = sum_r kn_o[r] head[r], each in
//     ascending r, its sum kept between chunks. Then a thread a neighbour
//     keeps it or not (topk:p by counting: a value is kept when fewer than
//     p values exceed it, so every tie at the threshold is kept, as the JAX
//     sort-and-threshold rule keeps it), the block takes the max of the
//     kept logits (exact in any order), and each neighbour's e_o =
//     exp(z_o - m) and e_o hv_o; thread 0 sums the denominator and thread
//     1 the weighted values, each in neighbour order, and thread 0 divides
//     and masks.
//
// Bound on this card. fold_in_solve is a chain of about 3R dependent
// steps (R Cholesky columns, each ending in __fdiv_rn and __fsqrt_rn, and
// R steps of each substitution, each an __fdiv_rn) over data that fits in
// shared memory: latency, not bytes or flops, bounds it (its bytes, L rows
// a request, and its ~R^3/3 flops take well under a microsecond;
// bench/csrc/step_latency.cu times those steps). score_rows moves T once
// (N * R * 4 bytes: 512 MiB at the full ALS cell) at 2 flops a T element
// a query: bytes. window_score gathers at most 2w + 1 rows of K and the
// head a token, a few microseconds of bytes even for a full batch; at the
// batches a 100 Hz stream makes (a few tokens) its time is one block's
// chain: the token id, one copy round trip, R dependent adds, then W
// steps each of the keep count, the max and the final sums
// (bench/kernel_ab.py's latency floor counts the R + W adds and the
// division).

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldThreads = 512;  // fold_in_solve: threads a block
constexpr int kScoreItems = 32;    // score_rows: outputs a warp tile, one a lane
constexpr int kQ = 8;              // score_rows: queries a group (a lone query: 1)
constexpr int kScoreStages = 3;    // score_rows: ring stages a warp
constexpr int kWinStages = 3;      // window_score: ring stages
constexpr int kWinMaxThreads = 1024;  // window_score: threads a block, at most
constexpr float kAttnNeg = -1e30f;  // ops/kernels.py ATTN_NEG

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// The same through L1 (.ca): rows that many blocks of an SM read (the
// window scorer's head, the rows around a padded slot's token 0) are
// fetched from L2 once.
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier of the block's first n threads (n a multiple of 32), on
// barrier 1: __syncthreads is barrier 0.
__device__ __forceinline__ void sync_first(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// sum_{k<n} a[k] * b[k] in ascending k, one accumulator, over 16-byte
// aligned rows: 16-byte loads, those of the next eight terms issued
// before this eight's adds, so that only the __fadd_rn latency is on the
// chain. The loads may read up to eight floats past a[n] and b[n]
// (fold_in_solve's rows are padded, and its shared memory runs on).
__device__ __forceinline__ float chain_dot(const float* a, const float* b, int n) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float t = 0.f;
  float4 a0 = a4[0], a1 = a4[1], b0 = b4[0], b1 = b4[1];
  int k = 0;
  for (; k + 8 <= n; k += 8) {
    const float4 na0 = a4[k / 4 + 2], na1 = a4[k / 4 + 3];
    const float4 nb0 = b4[k / 4 + 2], nb1 = b4[k / 4 + 3];
    t = __fadd_rn(t, __fmul_rn(a0.x, b0.x));
    t = __fadd_rn(t, __fmul_rn(a0.y, b0.y));
    t = __fadd_rn(t, __fmul_rn(a0.z, b0.z));
    t = __fadd_rn(t, __fmul_rn(a0.w, b0.w));
    t = __fadd_rn(t, __fmul_rn(a1.x, b1.x));
    t = __fadd_rn(t, __fmul_rn(a1.y, b1.y));
    t = __fadd_rn(t, __fmul_rn(a1.z, b1.z));
    t = __fadd_rn(t, __fmul_rn(a1.w, b1.w));
    a0 = na0, a1 = na1, b0 = nb0, b1 = nb1;
  }
  const float pa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float pb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (k + u < n) t = __fadd_rn(t, __fmul_rn(pa[u], pb[u]));
  return t;
}

// One step of the forward substitution in a warp, lane l holding rows l +
// 32 m of v in vr[m]: y_j = v_j / d_j (its owner divides, __shfl_sync
// broadcasts it, and it takes row j's place in vr), then column j of L
// (final) off every row below j.
template <int kRows>
__device__ __forceinline__ void forward_step(float (&vr)[kRows], const float* G, int ld,
                                             float dj, int j, int R, int lane) {
  const int mj = j / kWarp, owner = j - mj * kWarp;
  float vj = vr[0];
#pragma unroll
  for (int m = 1; m < kRows; ++m)
    if (m == mj) vj = vr[m];
  float col[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int r = lane + kWarp * m;
    col[m] = r > j && r < R ? G[r * ld + j] : 0.f;
  }
  const float yj = __shfl_sync(kFull, __fdiv_rn(vj, dj), owner);
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int r = lane + kWarp * m;
    if (r == j) vr[m] = yj;
    if (r > j && r < R) vr[m] = __fsub_rn(vr[m], __fmul_rn(col[m], yj));
  }
}

// The value of diag[j] before the helper warp has published it (a square
// root is never negative but for -0).
constexpr float kUnset = -1.f;

template <int kRows>
__global__ void __launch_bounds__(kFoldThreads)
fold_in_solve_kernel(const float* __restrict__ B, const int* __restrict__ idx,
                     const float* __restrict__ ratings, const float* __restrict__ mask,
                     float lam, float* __restrict__ x, int L, int R, int n_b, bool vec) {
  extern __shared__ float smem[];
  // The layout of ops/serve_kernels.py::fold_in_smem_bytes.
  const int ld = (R + 7) / 8 * 8 + 4;           // G's row: an odd count of 16-byte words
  const int ldr = (R + 3) / 4 * 4, r4 = ldr, l4 = (L + 3) / 4 * 4;
  float* G = smem;                              // [R][ld]: the Gram, then L below the diagonal
  float* rows = G + R * ld;                     // [L][ldr]: the masked rows
  float* diag = rows + L * ldr;                 // [R]: L's diagonal
  float* v = diag + r4;                         // [R]: rhs
  float* sd = v + r4;                           // [R]: s_i, as its row's owner last wrote it
  float* mk = sd + r4;                          // [L]: the mask
  float* wt = mk + l4;                          // [L]: ratings * mask
  int* id = reinterpret_cast<int*>(wt + l4);    // [L]: the clamped row ids
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int helper = (R + kWarp - 1) / kWarp;   // the warp after the rows' owners
  const size_t req = blockIdx.x;

  for (int l = tid; l < L; l += nt) {
    const float m = mask[req * L + l];
    mk[l] = m;
    wt[l] = __fmul_rn(ratings[req * L + l], m);
    id[l] = min(max(idx[req * L + l], 0), n_b - 1);  // a gather clamps, as XLA's does
  }
  for (int r = tid; r < R; r += nt) diag[r] = kUnset;
  __syncthreads();
  if (vec) {
    const int q = R / 4;
#pragma unroll 8
    for (int e = tid; e < L * q; e += nt) {
      const int l = e / q, c = 4 * (e - l * q);
      const float4 b = *reinterpret_cast<const float4*>(B + static_cast<size_t>(id[l]) * R + c);
      const float m = mk[l];
      *reinterpret_cast<float4*>(rows + l * ldr + c) =
          make_float4(__fmul_rn(b.x, m), __fmul_rn(b.y, m), __fmul_rn(b.z, m), __fmul_rn(b.w, m));
    }
  } else {
#pragma unroll 8
    for (int e = tid; e < L * R; e += nt) {
      const int l = e / R, c = e - l * R;
      rows[l * ldr + c] = __fmul_rn(B[static_cast<size_t>(id[l]) * R + c], mk[l]);
    }
  }
  __syncthreads();
  // Lower triangle (with the diagonal) of rows^T rows + lam I in 4 x 4
  // tiles (bi >= bj, tile t = bi (bi + 1) / 2 + bj), and rhs.
  const int nb = (R + 3) / 4;
  for (int t = tid; t < nb * (nb + 1) / 2; t += nt) {
    int bi = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (bi * (bi + 1) / 2 > t) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
    const int i0 = 4 * bi, j0 = 4 * (t - bi * (bi + 1) / 2);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
    for (int l = 0; l < L; ++l) {
      const float4 fi = *reinterpret_cast<const float4*>(rows + l * ldr + i0);
      const float4 fj = *reinterpret_cast<const float4*>(rows + l * ldr + j0);
      const float ri[4] = {fi.x, fi.y, fi.z, fi.w}, rj[4] = {fj.x, fj.y, fj.z, fj.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = __fadd_rn(acc[a][c], __fmul_rn(ri[a], rj[c]));
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + a, j = j0 + c;
        if (i < R && j <= i) G[i * ld + j] = i == j ? __fadd_rn(acc[a][c], lam) : acc[a][c];
      }
  }
  for (int i = tid; i < R; i += nt) {
    float acc = 0.f;
#pragma unroll 4
    for (int l = 0; l < L; ++l) acc = __fadd_rn(acc, __fmul_rn(rows[l * ldr + i], wt[l]));
    v[i] = acc;
  }
  __syncthreads();
  // The factor needs the rows' owners and the helper warp alone: the other
  // warps leave, and the rest synchronise on a barrier of their own.
  if (warp > helper) return;
  const int n_sync = (helper + 1) * kWarp;

  // Cholesky, left-looking: column j reads only columns < j (final), and
  // the Gram's diagonal stays untouched (L's is in diag). Thread i < R
  // owns row i; the helper warp publishes each diagonal and runs the
  // forward substitution L y = rhs one column behind, lane l holding rows
  // l + 32 m of v (then y) in vr[m].
  const int i = tid;
  float s = 0.f;  // sum_{k<i} L[i][k]^2 so far, ascending k
  float vr[kRows];
  if (warp == helper) {
#pragma unroll
    for (int m = 0; m < kRows; ++m) vr[m] = lane + kWarp * m < R ? v[lane + kWarp * m] : 0.f;
    if (lane == 0) diag[0] = __fsqrt_rn(__fsub_rn(G[0], 0.f));
  }
  sync_first(n_sync);
  for (int j = 0; j < R; ++j) {
    if (i > j && i < R) {
      const float gij = G[i * ld + j];
      const float t = chain_dot(G + i * ld, G + j * ld, j);
      float dj;
      while ((dj = *static_cast<volatile float*>(diag + j)) == kUnset) {
      }
      const float lij = __fdiv_rn(__fsub_rn(gij, t), dj);
      G[i * ld + j] = lij;
      s = __fadd_rn(s, __fmul_rn(lij, lij));
      sd[i] = s;
    } else if (warp == helper && j > 0) {
      // diag[j]: s_j is final since column j - 1; then y_{j-1}, and column
      // j - 1 off the rows below it (ascending columns).
      if (lane == 0) diag[j] = __fsqrt_rn(__fsub_rn(G[j * ld + j], sd[j]));
      forward_step<kRows>(vr, G, ld, diag[j - 1], j - 1, R, lane);
    }
    sync_first(n_sync);
  }
  if (warp != helper) return;
  forward_step<kRows>(vr, G, ld, diag[R - 1], R - 1, R, lane);

  // Back substitution L^T x = y, columns in descending order: x_j is final
  // once every row k > j has been subtracted from y[j]. Row j's entries
  // and diag[j] are loaded a step ahead.
  float g[kRows];
  auto load_row = [&](int j) {
#pragma unroll
    for (int m = 0; m < kRows; ++m)
      g[m] = j >= 0 && lane + kWarp * m < R ? G[j * ld + lane + kWarp * m] : 0.f;
    return j >= 0 ? diag[j] : 1.f;
  };
  float dj = load_row(R - 1);
#pragma unroll
  for (int m = kRows - 1; m >= 0; --m) {
    for (int jj = min(kWarp, R - kWarp * m) - 1; jj >= 0; --jj) {
      const int j = kWarp * m + jj;
      float gj[kRows];
#pragma unroll
      for (int m2 = 0; m2 < kRows; ++m2) gj[m2] = g[m2];
      const float d = dj;
      dj = load_row(j - 1);
      const float xj = __shfl_sync(kFull, __fdiv_rn(vr[m], d), jj);
      if (lane == jj) vr[m] = xj;
#pragma unroll
      for (int m2 = 0; m2 <= m; ++m2)
        if (lane + kWarp * m2 < j) vr[m2] = __fsub_rn(vr[m2], __fmul_rn(gj[m2], xj));
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    if (lane + kWarp * m < R) x[req * R + lane + kWarp * m] = vr[m];
}

// acc[a] += q[rr][a] * t[rr] for the first n (<= 4) features rr of a
// 16-byte word t of a stage row, in ascending rr: q holds kG queries a
// feature.
template <int kG>
__device__ __forceinline__ void score_quad(float (&acc)[kG], const float* t, const float* q,
                                           int n) {
  const float4 tv = *reinterpret_cast<const float4*>(t);
  const float t4[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    if (rr < n) {
      float qv[kG];
      if constexpr (kG == 1) {
        qv[0] = q[rr];
      } else {
#pragma unroll
        for (int a = 0; a < kG; a += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(q + rr * kG + a);
          qv[a] = q4.x, qv[a + 1] = q4.y, qv[a + 2] = q4.z, qv[a + 3] = q4.w;
        }
      }
#pragma unroll
      for (int a = 0; a < kG; ++a) acc[a] = __fadd_rn(acc[a], __fmul_rn(qv[a], t4[rr]));
    }
  }
}

// One warp-tile unit of score_rows: tile k of the warp, query group g, R
// chunk c, in that order of nesting.
struct ScoreUnit {
  int tile, g, c;
};

template <int RC, bool Vec, int kG>
__global__ void score_rows_kernel(const float* __restrict__ Q, const float* __restrict__ T,
                                  const int* __restrict__ tidx, float* __restrict__ out,
                                  int n_i, int n_j, int R, int ld_out, int n_t) {
  extern __shared__ __align__(16) float score_smem[];
  constexpr int kLd = RC + 4;                  // a stage row: an odd count of 16-byte words
  constexpr int kStage = kScoreItems * kLd;    // floats a stage
  constexpr int kPer = Vec ? RC / 4 : RC;      // copies a row chunk
  static_assert((kLd / 4) % 2 == 1, "stage rows must be an odd number of 16-byte words");
  const int n_groups = (n_i + kG - 1) / kG;
  float* qs = score_smem;                      // [group][R][kG], zero past n_i
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* ring = score_smem + (n_groups * R * kG + 3) / 4 * 4 + warp * kScoreStages * kStage;

  // Q[q][r] to qs[q / kG][r][q % kG], the loads of a thread all issued
  // before its stores; the padded queries are 0.
#pragma unroll 8
  for (int e = threadIdx.x; e < n_i * R; e += blockDim.x) {
    const int q = e / R, r = e - q * R;
    qs[((q / kG) * R + r) * kG + q % kG] = Q[e];
  }
  for (int e = n_i * R + threadIdx.x; e < n_groups * kG * R; e += blockDim.x) {
    const int q = e / R, r = e - q * R;
    qs[((q / kG) * R + r) * kG + q % kG] = 0.f;
  }
  __syncthreads();

  const int n_warps = gridDim.x * (blockDim.x / kWarp);
  const int gw = blockIdx.x * (blockDim.x / kWarp) + warp;
  const int n_tiles = (n_j + kScoreItems - 1) / kScoreItems;
  const int n_chunks = (R + RC - 1) / RC;
  const int per_tile = n_groups * n_chunks;
  const int my_tiles = gw < n_tiles ? (n_tiles - gw + n_warps - 1) / n_warps : 0;
  const int n_units = my_tiles * per_tile;
  auto unit = [&](int u) {
    const int k = u / per_tile, rem = u - k * per_tile;
    return ScoreUnit{gw + k * n_warps, rem / n_chunks, rem - (rem / n_chunks) * n_chunks};
  };
  // Copy unit u's T rows into its stage; commit a group (empty past the
  // last unit), so that group u is unit u's.
  auto load = [&](int u) {
    if (u < n_units) {
      const ScoreUnit w = unit(u);
      const int j0 = w.tile * kScoreItems, c0 = w.c * RC, rc = min(RC, R - c0);
      const int jl = j0 + lane;
      const int tl = jl < n_j ? (tidx ? min(max(tidx[jl], 0), n_t - 1) : jl) : 0;
      float* st = ring + (u % kScoreStages) * kStage;
#pragma unroll 4
      for (int e = lane; e < kScoreItems * kPer; e += kWarp) {
        const int it = e / kPer, q = e - it * kPer;
        const int t = __shfl_sync(kFull, tl, it);
        const int off = Vec ? 4 * q : q;
        if (j0 + it < n_j && off < rc) {
          const float* src = T + static_cast<size_t>(t) * R + c0 + off;
          if (Vec)
            cp_async16(st + it * kLd + off, src);
          else
            cp_async4(st + it * kLd + off, src);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int u = 0; u < kScoreStages - 1; ++u) load(u);
  float acc[kG] = {};
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<kScoreStages - 2>();
    __syncwarp();  // every lane's copies of unit u landed; unit u - 1 is read
    load(u + kScoreStages - 1);
    const ScoreUnit w = unit(u);
    const int c0 = w.c * RC, rc = min(RC, R - c0);
    if (w.c == 0) {
#pragma unroll
      for (int a = 0; a < kG; ++a) acc[a] = 0.f;
    }
    const float* row = ring + (u % kScoreStages) * kStage + lane * kLd;
    const float* q = qs + (static_cast<size_t>(w.g) * R + c0) * kG;
    if (rc == RC) {
#pragma unroll
      for (int r = 0; r < RC; r += 4) score_quad(acc, row + r, q + r * kG, 4);
    } else {
      for (int r = 0; r < rc; r += 4) score_quad(acc, row + r, q + r * kG, rc - r);
    }
    if (w.c == n_chunks - 1) {
      const int j = w.tile * kScoreItems + lane;
      if (j < n_j) {
#pragma unroll
        for (int a = 0; a < kG; ++a) {
          const int i = w.g * kG + a;
          if (i < n_i) out[static_cast<size_t>(i) * ld_out + j] = acc[a];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// acc += a[r] * b[r] for the first n (<= 4) features r of a 16-byte
// word of two stage rows, in ascending r.
__device__ __forceinline__ float window_quad(float acc, const float* a, const float* b, int n) {
  const float4 av = *reinterpret_cast<const float4*>(a);
  const float4 bv = *reinterpret_cast<const float4*>(b);
  const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < n) acc = __fadd_rn(acc, __fmul_rn(a4[u], b4[u]));
  return acc;
}

// One token slot a block (the design above). A stage holds W + 1 rows of
// kLd floats: rows 0 .. hi - lo K's rows lo .. hi (neighbour o's row is
// clamp(tok + o - w) - lo, the query's clamp(tok) - lo), row W the head.
template <int RC, bool Vec>
__global__ void __launch_bounds__(kWinMaxThreads)
window_score_kernel(const float* __restrict__ K, const float* __restrict__ head,
                    const int* __restrict__ tokens, const float* __restrict__ mask,
                    const int* __restrict__ kind, const int* __restrict__ param,
                    float* __restrict__ out, int L, int R, int w, int n_valid, int ctx_cap,
                    float inv_sqrt_r) {
  extern __shared__ __align__(16) float win_smem[];
  // A stage row: an odd count of 16-byte words (one at RC 4).
  constexpr int kLd = RC == 4 ? 4 : RC + 4;
  constexpr int kPer = Vec ? RC / 4 : RC;  // copies a row chunk
  static_assert((kLd / 4) % 2 == 1, "stage rows must be an odd number of 16-byte words");
  // The layout of ops/serve_kernels.py::window_smem_bytes.
  const int W = 2 * w + 1, stage = (W + 1) * kLd;
  float* z = win_smem + kWinStages * stage;  // [W] dot_o, then the logits, then e_o
  float* val = z + W;                        // [W] hv_o, then e_o hv_o
  float* red = val + W;                      // [32] the warps' maxima, then the final sums
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = blockIdx.x, b = g / L;
  // The slot's scalars first: every copy address waits on tok.
  const int tok = tokens[g];
  // kind 0: window:p keeps |offset| <= p; kind 1: topk:p; no kind: the
  // static window, every offset.
  const int kd = kind ? kind[b] : 0;
  const int p = param ? param[b] : w;
  const float mk = mask[g];
  const int n_chunks = (R + RC - 1) / RC;
  auto clamp_row = [&](int n) { return min(max(n, 0), ctx_cap - 1); };
  const int lo = clamp_row(tok - w), n_rows = clamp_row(tok + w) - lo + 1;
  const int sq = clamp_row(tok) - lo;

  // Copy chunk c of the n_rows rows and the head into its stage; commit a
  // group (empty past the last chunk), so that group c is chunk c's.
  auto load = [&](int c) {
    if (c < n_chunks) {
      const int c0 = c * RC, rc = min(RC, R - c0);
      float* st = win_smem + (c % kWinStages) * stage;
      for (int i = tid; i < (n_rows + 1) * kPer; i += nt) {
        const int s = i / kPer, q = i - s * kPer;
        const int off = Vec ? 4 * q : q;
        if (off < rc) {
          const bool kr = s < n_rows;
          const float* src = (kr ? K + static_cast<size_t>(lo + s) * R : head) + c0 + off;
          float* dst = st + (kr ? s : W) * kLd + off;
          if (Vec)
            cp_async16_ca(dst, src);
          else
            cp_async4(dst, src);
        }
      }
    }
    cp_async_commit();
  };

  // Chain j < W: dot_j = sum_r q[r] kn_j[r] into z[j]; chain W + o: hv_o =
  // sum_r kn_o[r] head[r] into val[o] (each product's operands in that
  // order). Thread tid takes chains tid, tid + nt, ...; a chain's sum
  // stays in its shared-memory slot between chunks.
#pragma unroll
  for (int c = 0; c < kWinStages - 1; ++c) load(c);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kWinStages - 2>();
    __syncthreads();  // every thread's copies of chunk c landed; chunk c - 1 is read
    load(c + kWinStages - 1);
    const float* st = win_smem + (c % kWinStages) * stage;
    const int rc = min(RC, R - c * RC);
    for (int j = tid; j < 2 * W; j += nt) {
      const int o = j < W ? j : j - W;
      const int sn = clamp_row(tok + o - w) - lo;
      const float* a = st + (j < W ? sq : sn) * kLd;
      const float* bb = st + (j < W ? sn : W) * kLd;
      float acc = c == 0 ? 0.f : z[j];
      if (rc == RC) {
#pragma unroll
        for (int r = 0; r < RC; r += 4) acc = window_quad(acc, a + r, bb + r, 4);
      } else {
        for (int r = 0; r < rc; r += 4) acc = window_quad(acc, a + r, bb + r, rc - r);
      }
      z[j] = acc;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  auto valid = [&](int o) { return tok + o - w >= 0 && tok + o - w < n_valid; };
  for (int o = tid; o < W; o += nt) z[o] = valid(o) ? __fmul_rn(z[o], inv_sqrt_r) : kAttnNeg;
  __syncthreads();
  // Bit k of kept: this thread's k-th neighbour (o = tid + k nt) is kept.
  unsigned kept = 0;
  float m = kAttnNeg;
  for (int o = tid, k = 0; o < W; o += nt, ++k) {
    const float zo = z[o];
    bool keep;
    if (kd == 1) {
      const int pk = min(max(p, 1), W);
      int gt = 0;
      for (int u = 0; u < W; ++u) gt += z[u] > zo;
      keep = valid(o) && gt < pk;
    } else {
      keep = valid(o) && abs(o - w) <= p;
    }
    kept |= static_cast<unsigned>(keep) << k;
    m = fmaxf(m, keep ? zo : kAttnNeg);
  }
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
  if (tid % kWarp == 0) red[tid / kWarp] = m;
  __syncthreads();
  m = kAttnNeg;
  for (int u = 0; u < nt / kWarp; ++u) m = fmaxf(m, red[u]);
  for (int o = tid, k = 0; o < W; o += nt, ++k) {
    const float eo = (kept >> k & 1u) ? expf(__fsub_rn(z[o], m)) : 0.f;
    z[o] = eo;
    val[o] = __fmul_rn(eo, val[o]);
  }
  __syncthreads();
  if (tid < 2) {
    // Thread 0: d = sum_o e_o; thread 1: num = sum_o e_o hv_o.
    const float* t = tid == 0 ? z : val;
    float sum = 0.f;
    for (int u = 0; u < W; ++u) sum = __fadd_rn(sum, t[u]);
    red[tid] = sum;
  }
  __syncthreads();
  if (tid == 0) {
    const float d = red[0];
    out[g] = __fmul_rn(__fdiv_rn(red[1], d > 0.f ? d : 1.f), mk);
  }
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns the first CUDA error of its set-up or launch
// (0 when there is none).

extern "C" int fold_in_solve(const float* B, const int* idx, const float* ratings,
                             const float* mask, float lam, float* x, int b, int L,
                             int R, int n_b, int threads, int smem_bytes, void* stream) {
  // Rows a lane in the substitutions: R <= 128 takes 4, R <= 256 8.
  const int rows = R <= 4 * kWarp ? 4 : 8;
  if (R > 8 * kWarp || threads < ((R + kWarp - 1) / kWarp + 1) * kWarp || threads % kWarp != 0 ||
      threads > kFoldThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = rows == 4 ? fold_in_solve_kernel<4> : fold_in_solve_kernel<8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  kernel<<<b, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(B, idx, ratings, mask,
                                                                       lam, x, L, R, n_b, vec);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int RC, bool Vec, int kG>
int launch_score(const float* Q, const float* T, const int* tidx, float* out, int n_i,
                 int n_j, int R, int ld_out, int n_t, int blocks, int threads,
                 int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      score_rows_kernel<RC, Vec, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  score_rows_kernel<RC, Vec, kG><<<blocks, threads, smem_bytes, stream>>>(
      Q, T, tidx, out, n_i, n_j, R, ld_out, n_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks, threads, rchunk (32 or 128) and smem_bytes: the launch shape of
// ops/serve_kernels.py::score_launch. T's rows come in 16-byte copies
// where R % 4 == 0 and T is 16-byte aligned, else in 4-byte copies.
extern "C" int score_rows(const float* Q, const float* T, const int* tidx, float* out,
                          int n_i, int n_j, int R, int ld_out, int n_t, int blocks,
                          int threads, int rchunk, int smem_bytes, void* stream) {
  if (blocks < 1 || threads < kWarp || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(T) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(Q, T, tidx, out, n_i, n_j, R, ld_out, n_t, blocks, threads, smem_bytes, s);
  };
  // One query (the GAT head, a batch of one) takes groups of 1, else kQ.
  if (n_i == 1) {
    if (rchunk == 32)
      return vec ? args(launch_score<32, true, 1>) : args(launch_score<32, false, 1>);
    if (rchunk == 128)
      return vec ? args(launch_score<128, true, 1>) : args(launch_score<128, false, 1>);
  } else {
    if (rchunk == 32)
      return vec ? args(launch_score<32, true, kQ>) : args(launch_score<32, false, kQ>);
    if (rchunk == 128)
      return vec ? args(launch_score<128, true, kQ>) : args(launch_score<128, false, kQ>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory a launch takes unasked

template <int RC, bool Vec>
int launch_window(const float* K, const float* head, const int* tokens, const float* mask,
                  const int* kind, const int* param, float* out, int n_tokens, int L, int R,
                  int w, int n_valid, int ctx_cap, float inv_sqrt_r, int threads,
                  int smem_bytes, cudaStream_t stream) {
  const auto kernel = window_score_kernel<RC, Vec>;
  if (smem_bytes > kSmemDefault) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_tokens, threads, smem_bytes, stream>>>(K, head, tokens, mask, kind, param, out, L,
                                                    R, w, n_valid, ctx_cap, inv_sqrt_r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// threads, rchunk (64, 32 or 4) and smem_bytes: the launch shape of
// ops/serve_kernels.py::window_launch, a block a token slot. The rows come
// in 16-byte copies where R % 4 == 0 and K and head are 16-byte aligned,
// else in 4-byte copies.
extern "C" int window_score(const float* K, const float* head, const int* tokens,
                            const float* mask, const int* kind, const int* param,
                            float* out, int n_tokens, int L, int R, int w, int n_valid,
                            int ctx_cap, float inv_sqrt_r, int threads, int rchunk,
                            int smem_bytes, void* stream) {
  const int W = 2 * w + 1;
  // A thread takes chains tid, tid + threads, ... and at most 32 neighbours
  // (a bit each of the keep mask).
  if (n_tokens < 1 || w < 0 || threads < (2 * W < kWinMaxThreads ? 2 * W : kWinMaxThreads) ||
      threads % kWarp != 0 || threads > kWinMaxThreads || W > kWarp * threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(K) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(head) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(K, head, tokens, mask, kind, param, out, n_tokens, L, R, w, n_valid, ctx_cap,
                  inv_sqrt_r, threads, smem_bytes, s);
  };
  if (rchunk == 64)
    return vec ? args(launch_window<64, true>) : args(launch_window<64, false>);
  if (rchunk == 32)
    return vec ? args(launch_window<32, true>) : args(launch_window<32, false>);
  if (rchunk == 4)
    return vec ? args(launch_window<4, true>) : args(launch_window<4, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}
