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
// code path depends on R, L and the window alone, never on the batch
// size, a request's slot in the batch or a pointer's alignment, so a
// request's reply bits do not depend on what else was batched or padded.
//   fold_in_solve: one block a request. The masked rows, the Gram (rows
//     padded to R + 1 floats against bank conflicts), rhs and the
//     diagonal sit in shared memory (99,840 bytes at R = 128, L = 64; the
//     wrapper raises when they do not fit). Left-looking Cholesky in
//     place: at column j each thread owns rows i >= j and computes the
//     diagonal itself (the same sum, the same bits), so one barrier a
//     column; forward and back substitution column by column, a barrier a
//     step.
//   score_rows: a block of kItems outputs j; the block stages its T rows
//     through shared memory (coalesced loads, rows padded to R + 1) and
//     keeps the n_i query rows in shared memory, so each T row is read
//     once a call; a thread keeps up to kQ accumulators, one an output.
//   window_score: a warp a (request, token); lane o takes neighbours o,
//     o + 32, ...; the topk threshold is found by counting (a value is
//     kept when fewer than p values exceed it: every tie at the threshold
//     is kept, as the JAX sort-and-threshold rule keeps it); the max is
//     exact in any order; lane 0 sums the denominator and the weighted
//     values in neighbour order.
//
// Bound on this card. fold_in_solve is a chain of R dependent steps
// (R barriers for the factor, 2R for the substitutions) over data that
// fits in shared memory: latency, not bytes or flops, bounds it (its
// bytes, L rows a request, and its ~R^3/3 flops take well under a
// microsecond). score_rows moves T once (N * R * 4 bytes: 512 MiB at the
// full ALS cell) at 2 flops a T element a query: bytes. window_score
// gathers (2w + 2) rows of K a token: bytes, and tiny.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kItems = 64;      // score_rows: outputs a block
constexpr int kQ = 8;           // score_rows: accumulators a thread
constexpr int kWinWarps = 4;    // window_score: tokens a block
constexpr float kAttnNeg = -1e30f;  // ops/kernels.py ATTN_NEG

__global__ void fold_in_solve_kernel(const float* __restrict__ B,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ ratings,
                                     const float* __restrict__ mask, float lam,
                                     float* __restrict__ x, int L, int R, int n_b) {
  extern __shared__ float smem[];
  const int ld = R + 1;
  float* G = smem;              // [R][ld]: the Gram, then L below the diagonal
  float* rows = G + R * ld;     // [L][R]: the masked rows, then y
  float* diag = rows + L * R;   // [R]: L's diagonal
  float* v = diag + R;          // [R]: rhs, then forward substitution's carry
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t req = blockIdx.x;
  const int* id = idx + req * L;
  const float* rt = ratings + req * L;
  const float* mk = mask + req * L;

  for (int e = tid; e < L * R; e += nt) {
    const int l = e / R, r = e - l * R;
    const int row = min(max(id[l], 0), n_b - 1);  // a gather clamps, as XLA's does
    rows[e] = __fmul_rn(B[static_cast<size_t>(row) * R + r], mk[l]);
  }
  __syncthreads();
  // Lower triangle (with the diagonal) of rows^T rows + lam I, and rhs.
  for (int e = tid; e < R * R; e += nt) {
    const int i = e / R, j = e - i * R;
    if (j > i) continue;
    float acc = 0.f;
    for (int l = 0; l < L; ++l)
      acc = __fadd_rn(acc, __fmul_rn(rows[l * R + i], rows[l * R + j]));
    G[i * ld + j] = i == j ? __fadd_rn(acc, lam) : acc;
  }
  for (int i = tid; i < R; i += nt) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l)
      acc = __fadd_rn(acc, __fmul_rn(rows[l * R + i], __fmul_rn(rt[l], mk[l])));
    v[i] = acc;
  }
  __syncthreads();

  // Cholesky, left-looking: column j reads only columns < j (final) and
  // the Gram's diagonal, which stays untouched (L's is in diag).
  for (int j = 0; j < R; ++j) {
    for (int i = j + tid; i < R; i += nt) {
      float s = 0.f;
      for (int k = 0; k < j; ++k)
        s = __fadd_rn(s, __fmul_rn(G[j * ld + k], G[j * ld + k]));
      const float d = __fsqrt_rn(__fsub_rn(G[j * ld + j], s));
      if (i == j) {
        diag[j] = d;
        continue;
      }
      float t = 0.f;
      for (int k = 0; k < j; ++k)
        t = __fadd_rn(t, __fmul_rn(G[i * ld + k], G[j * ld + k]));
      G[i * ld + j] = __fdiv_rn(__fsub_rn(G[i * ld + j], t), d);
    }
    __syncthreads();
  }
  // Forward substitution L y = rhs, column by column: y_j is final once
  // every column k < j has been subtracted from v[j].
  float* y = rows;
  for (int j = 0; j < R; ++j) {
    const float yj = __fdiv_rn(v[j], diag[j]);
    for (int i = j + 1 + tid; i < R; i += nt)
      v[i] = __fsub_rn(v[i], __fmul_rn(G[i * ld + j], yj));
    if (tid == 0) y[j] = yj;
    __syncthreads();
  }
  // Back substitution L^T x = y, columns in descending order.
  for (int j = R - 1; j >= 0; --j) {
    const float xj = __fdiv_rn(y[j], diag[j]);
    for (int i = tid; i < j; i += nt)
      y[i] = __fsub_rn(y[i], __fmul_rn(G[j * ld + i], xj));
    if (tid == 0) x[req * R + j] = xj;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kItems)
score_rows_kernel(const float* __restrict__ Q, const float* __restrict__ T,
                  const int* __restrict__ tidx, float* __restrict__ out,
                  int n_i, int n_j, int R, int ld_out, int n_t) {
  extern __shared__ float smem[];
  const int ldt = R + 1;
  float* tile = smem;                // [kItems][ldt]
  float* q = tile + kItems * ldt;    // [n_i][R]
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kItems;
  const int n_here = min(kItems, n_j - j0);
  for (int e = tid; e < n_i * R; e += kItems) q[e] = Q[e];
  for (int e = tid; e < n_here * R; e += kItems) {
    const int it = e / R, r = e - it * R;
    const int t = tidx ? min(max(tidx[j0 + it], 0), n_t - 1) : j0 + it;
    tile[it * ldt + r] = T[static_cast<size_t>(t) * R + r];
  }
  __syncthreads();
  if (tid >= n_here) return;
  const float* row = tile + tid * ldt;
  for (int i0 = 0; i0 < n_i; i0 += kQ) {
    const int nq = min(kQ, n_i - i0);
    float acc[kQ];
#pragma unroll
    for (int a = 0; a < kQ; ++a) acc[a] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float tv = row[r];
#pragma unroll
      for (int a = 0; a < kQ; ++a)
        if (a < nq) acc[a] = __fadd_rn(acc[a], __fmul_rn(q[(i0 + a) * R + r], tv));
    }
    for (int a = 0; a < nq; ++a)
      out[static_cast<size_t>(i0 + a) * ld_out + j0 + tid] = acc[a];
  }
}

__global__ void __launch_bounds__(kWinWarps * kWarp)
window_score_kernel(const float* __restrict__ K, const float* __restrict__ head,
                    const int* __restrict__ tokens, const float* __restrict__ mask,
                    const int* __restrict__ kind, const int* __restrict__ param,
                    float* __restrict__ out, int n_tokens, int L, int R, int w,
                    int n_valid, int ctx_cap, float inv_sqrt_r) {
  extern __shared__ float smem[];
  const int W = 2 * w + 1;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* z = smem + warp * 4 * W;   // logits (ATTN_NEG where not valid)
  float* val = z + W;               // <kn, head>
  float* keep = val + W;            // 1 where the mask keeps the neighbour
  float* e = keep + W;              // masked exp
  const int g = blockIdx.x * kWinWarps + warp;
  if (g >= n_tokens) return;
  const int b = g / L;
  const int tok = tokens[g];
  // kind 0: window:p keeps |offset| <= p; kind 1: topk:p; no kind: the
  // static window, every offset.
  const int kd = kind ? kind[b] : 0;
  const int p = param ? param[b] : w;
  const float* qr = K + static_cast<size_t>(min(max(tok, 0), ctx_cap - 1)) * R;
  for (int o = lane; o < W; o += kWarp) {
    const int n = tok + o - w;
    const bool ok = n >= 0 && n < n_valid;
    const int nc = min(max(n, 0), ctx_cap - 1);
    const float* kr = K + static_cast<size_t>(nc) * R;
    float dot = 0.f, hv = 0.f;
    for (int r = 0; r < R; ++r) {
      dot = __fadd_rn(dot, __fmul_rn(qr[r], kr[r]));
      hv = __fadd_rn(hv, __fmul_rn(kr[r], head[r]));
    }
    z[o] = ok ? __fmul_rn(dot, inv_sqrt_r) : kAttnNeg;
    val[o] = hv;
  }
  __syncwarp();
  const int pk = min(max(p, 1), W);
  float m = kAttnNeg;
  for (int o = lane; o < W; o += kWarp) {
    const int n = tok + o - w;
    bool ok = n >= 0 && n < n_valid;
    if (kd == 1) {
      int gt = 0;
      for (int u = 0; u < W; ++u) gt += z[u] > z[o];
      ok = ok && gt < pk;
    } else {
      ok = ok && abs(o - w) <= p;
    }
    keep[o] = ok ? 1.f : 0.f;
    m = fmaxf(m, ok ? z[o] : kAttnNeg);
  }
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
  for (int o = lane; o < W; o += kWarp)
    e[o] = keep[o] != 0.f ? expf(__fsub_rn(z[o], m)) : 0.f;
  __syncwarp();
  if (lane == 0) {
    float d = 0.f, num = 0.f;
    for (int o = 0; o < W; ++o) {
      d = __fadd_rn(d, e[o]);
      num = __fadd_rn(num, __fmul_rn(e[o], val[o]));
    }
    out[g] = __fmul_rn(__fdiv_rn(num, d > 0.f ? d : 1.f), mask[g]);
  }
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns the first CUDA error of its set-up or launch
// (0 when there is none).

extern "C" int fold_in_solve(const float* B, const int* idx, const float* ratings,
                             const float* mask, float lam, float* x, int b, int L,
                             int R, int n_b, int threads, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fold_in_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_in_solve_kernel<<<b, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      B, idx, ratings, mask, lam, x, L, R, n_b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int score_rows(const float* Q, const float* T, const int* tidx, float* out,
                          int n_i, int n_j, int R, int ld_out, int n_t, int smem_bytes,
                          void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      score_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_j + kItems - 1) / kItems;
  score_rows_kernel<<<blocks, kItems, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      Q, T, tidx, out, n_i, n_j, R, ld_out, n_t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_score(const float* K, const float* head, const int* tokens,
                            const float* mask, const int* kind, const int* param,
                            float* out, int n_tokens, int L, int R, int w, int n_valid,
                            int ctx_cap, float inv_sqrt_r, void* stream) {
  const int blocks = (n_tokens + kWinWarps - 1) / kWinWarps;
  const int smem = kWinWarps * 4 * (2 * w + 1) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      window_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_score_kernel<<<blocks, kWinWarps * kWarp, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      K, head, tokens, mask, kind, param, out, n_tokens, L, R, w, n_valid, ctx_cap,
      inv_sqrt_r);
  return static_cast<int>(cudaGetLastError());
}
