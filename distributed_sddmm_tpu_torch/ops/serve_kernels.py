"""Hand-written CUDA kernels of the per-request serving programs and their
plain PyTorch versions (``ops/csrc/serve_kernels.cu``).

They replace no TPU kernel: the JAX package's per-request programs
(``serve/workloads.py``) are ``jnp`` code under ``jax.jit``. On the card
torch ops cannot stand in for them, because cuBLAS and torch's CUDA
reductions choose their summation order from the shapes, the batch count
included, and a served request's bits must not depend on its neighbours
in a micro-batch (the serving determinism contract):

* :func:`fold_in_solve` -- one user's ridge fold-in a row of the batch:
  ``x = (rowsᵀrows + λI)⁻¹ rowsᵀ(ratings·mask)`` with ``rows =
  B[idx]·mask``, by Cholesky and two substitutions (JAX
  ``ALSFoldInTopK.build_program`` and ``_chol_solve``);
* :func:`score_rows` -- ``out[i, j] = Σ_r Q[i, r]·T[t_j, r]``: the ALS
  scores of every item against each request's ``x``, and the GAT node
  scores ``X[nodes]·w``;
* :func:`window_score` -- attention token scores over the ``±w``
  neighbourhood of a cached context, with the per-request ``window:p`` /
  ``topk:p`` keep rule of dynamic mode (JAX
  ``AttentionTokenScore.build_program``).

Each kernel keeps one accumulator an output and sums in a fixed order with
every product and sum rounded apart, and the plain versions here sum in
that order with the same roundings; so on the card ``fold_in_solve`` and
``score_rows`` give their plain versions' bits (division and square root
are IEEE's on both sides), ``window_score`` may differ where ``exp``
rounds apart, and on either device a reply does not depend on the batch
size, its slot or padding. The kernels' tiling and launch shapes
(:func:`score_launch`, :func:`fold_in_launch`) never change an output's
order. The plain versions loop in Python over the summed axis, which
makes them slow and exact; nothing on the main path calls them when a
card is present.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel, adds one to its count in :data:`LAUNCHES` and raises
if the launch fails: it never falls back. Gather indices are clamped into
range, as an XLA gather clamps them.
"""

from __future__ import annotations

import functools
import math

import torch

from distributed_sddmm_tpu_torch.ops import _build
from distributed_sddmm_tpu_torch.ops.kernels import ATTN_NEG

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {"fold_in_solve": 0, "score_rows": 0, "window_score": 0}

#: ``score_rows``: outputs a warp tile, one a lane (``kScoreItems`` in the
#: source); queries a group, the accumulators a lane (``kQ``); ring
#: stages a warp (``kScoreStages``).
SCORE_ITEMS = 32
SCORE_QUERIES = 8
SCORE_STAGES = 3
#: The most shared memory a block can opt into on an H100 (227 KB), an
#: SM's shared memory (228 KB) and what the card reserves of it a block.
SMEM_OPTIN = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
#: SMs of an H100 SXM: the launch shape's default where no card is asked.
SM_COUNT = 132
#: Threads of a ``fold_in_solve`` block (``kFoldThreads`` in the source).
FOLD_THREADS = 512


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fold_in_smem_bytes(L: int, R: int) -> int:
    """Shared memory of one fold-in block: the Gram (rows of ``ceil8(R) +
    4`` floats, an odd count of 16-byte words), the masked rows (``ceil4(R)``
    floats), L's diagonal, rhs and the running sums of squares of L's
    rows, and the mask, the weights and the row ids of the L slots."""
    ld, r4, l4 = -(-R // 8) * 8 + 4, -(-R // 4) * 4, -(-L // 4) * 4
    return 4 * (R * ld + L * r4 + 3 * r4 + 3 * l4)


def fold_in_launch(L: int, R: int) -> dict:
    """Launch shape of ``fold_in_solve`` (a block a request):
    ``{"threads", "smem"}``. FOLD_THREADS: the Gram's tiles get four warps
    a scheduler; a thread owns a row of the factor, and the warp after the
    rows' runs the substitutions (R <= 256, so at most nine warps)."""
    return {"threads": FOLD_THREADS, "smem": fold_in_smem_bytes(L, R)}


def score_launch(n_i: int, n_j: int, R: int, sms: int = SM_COUNT) -> dict:
    """Launch shape of ``score_rows``: ``{"blocks", "threads", "items",
    "rchunk", "smem"}``. A warp walks tiles of ``items`` outputs in R
    chunks of ``rchunk`` features, through SCORE_STAGES shared-memory
    stages of its own; a block stages the queries once, SCORE_QUERIES to a
    group (a single query alone). Many tiles (the ALS scores): chunks of 32 features and four
    warps a block, as many blocks as fit on ``sms`` SMs at once; few (the
    GAT head): chunks of 128 and one-warp blocks, so that the tiles spread
    over more SMs, each with more bytes in flight."""
    tiles = -(-n_j // SCORE_ITEMS)
    group = 1 if n_i == 1 else SCORE_QUERIES
    q_bytes = 16 * -(-group * -(-n_i // group) * R // 4)
    rchunk, warps = (32, 4) if tiles >= 4 * sms else (128, 1)
    if R <= 32:
        rchunk = 32

    def smem(rc: int, w: int) -> int:
        return q_bytes + 4 * SCORE_STAGES * w * SCORE_ITEMS * (rc + 4)

    while warps > 1 and smem(rchunk, warps) > SMEM_OPTIN:
        warps //= 2
    if smem(rchunk, warps) > SMEM_OPTIN:
        rchunk = 32
    size = smem(rchunk, warps)
    per_sm = max(1, min(SMEM_SM // (size + SMEM_RESERVED), 2048 // (32 * warps), 32))
    return {"blocks": max(1, min(-(-tiles // warps), per_sm * sms)), "threads": 32 * warps,
            "items": SCORE_ITEMS, "rchunk": rchunk, "smem": size}


# ------------------------------------------------------------------ #
# Plain PyTorch versions
# ------------------------------------------------------------------ #


def _zeros(*shape, like):
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def fold_in_solve_plain(B, idx, ratings, mask, lam: float):
    """``x [b, R]``: the kernel's function, order and roundings."""
    b, L = idx.shape
    R = B.shape[1]
    rows = B[idx.long().clamp(0, B.shape[0] - 1)] * mask[..., None]      # (b, L, R)
    weights = ratings * mask
    gram, rhs = _zeros(b, R, R, like=B), _zeros(b, R, like=B)
    for l in range(L):
        gram = gram + rows[:, l, :, None] * rows[:, l, None, :]
        rhs = rhs + rows[:, l, :] * weights[:, l, None]
    lam32 = torch.tensor(lam, dtype=torch.float32, device=B.device)
    # Left-looking Cholesky: column j from columns < j.
    low, diag = _zeros(b, R, R, like=B), _zeros(b, R, like=B)
    for j in range(R):
        s = _zeros(b, like=B)
        for k in range(j):
            s = s + low[:, j, k] * low[:, j, k]
        d = torch.sqrt((gram[:, j, j] + lam32) - s)
        diag[:, j] = d
        if j + 1 < R:
            t = _zeros(b, R - j - 1, like=B)
            for k in range(j):
                t = t + low[:, j + 1:, k] * low[:, j, k, None]
            low[:, j + 1:, j] = (gram[:, j + 1:, j] - t) / d[:, None]
    v, y = rhs.clone(), _zeros(b, R, like=B)
    for j in range(R):
        yj = v[:, j] / diag[:, j]
        v[:, j + 1:] = v[:, j + 1:] - low[:, j + 1:, j] * yj[:, None]
        y[:, j] = yj
    x = _zeros(b, R, like=B)
    for j in reversed(range(R)):
        xj = y[:, j] / diag[:, j]
        y[:, :j] = y[:, :j] - low[:, j, :j] * xj[:, None]
        x[:, j] = xj
    return x


def score_rows_plain(Q, T, tidx=None, out=None):
    """``[n_i, n_j]``: ``Σ_r Q[i, r]·T[t_j, r]`` in ascending r; into the
    first n_j columns of ``out`` when given."""
    rows = T if tidx is None else T[tidx.long().clamp(0, T.shape[0] - 1)]
    acc = _zeros(Q.shape[0], rows.shape[0], like=T)
    for r in range(Q.shape[1]):
        acc = acc + Q[:, r, None] * rows[None, :, r]
    if out is None:
        return acc
    out[:, :acc.shape[1]] = acc
    return out[:, :acc.shape[1]]


def window_score_plain(K, head, tokens, mask, n_valid: int, window: int,
                       kind=None, param=None):
    """``[b, L]`` attention token scores over the ``±window`` neighbourhood
    of ``K``'s first ``n_valid`` rows; ``kind``/``param`` (``[b]`` int32)
    narrow it per request, kind 0 ``window:p``, kind 1 ``topk:p``."""
    ctx_cap, R = K.shape
    W = 2 * window + 1
    offs = torch.arange(-window, window + 1, device=K.device)
    tok = tokens.long()
    nb = tok[..., None] + offs                                         # (b, L, W)
    valid = (nb >= 0) & (nb < n_valid)
    q = K[tok.clamp(0, ctx_cap - 1)]                                   # (b, L, R)
    kn = K[nb.clamp(0, ctx_cap - 1)]                                   # (b, L, W, R)
    dot, hv = _zeros(*nb.shape, like=K), _zeros(*nb.shape, like=K)
    for r in range(R):
        dot = dot + q[..., r, None] * kn[..., r]
        hv = hv + kn[..., r] * head[r]
    inv = torch.tensor(1.0 / float(math.sqrt(R)), dtype=torch.float32, device=K.device)
    neg = torch.tensor(ATTN_NEG, dtype=torch.float32, device=K.device)
    z = torch.where(valid, dot * inv, neg)
    if kind is None:
        ok = valid
    else:
        p = param.long()[:, None, None]
        keep_window = offs.abs() <= p
        # topk:p keeps a value when fewer than p values exceed it: every
        # tie at the p-th value stays, as the JAX sort-and-threshold keeps.
        above = (z[..., None, :] > z[..., :, None]).sum(-1)
        keep_topk = above < p.clamp(1, W)
        ok = valid & torch.where(kind.long()[:, None, None] == 1, keep_topk, keep_window)
    m = torch.where(ok, z, neg).amax(-1, keepdim=True)
    e = torch.where(ok, torch.exp(z - m), torch.zeros((), device=K.device))
    d, num = _zeros(*tok.shape, like=K), _zeros(*tok.shape, like=K)
    for o in range(W):
        d = d + e[..., o]
        num = num + e[..., o] * hv[..., o]
    return num / torch.where(d > 0, d, torch.ones((), device=K.device)) * mask


# ------------------------------------------------------------------ #
# Kernel wrappers
# ------------------------------------------------------------------ #


def _on_card(dev, **tensors) -> None:
    if dev.type != "cuda":
        raise ValueError(f"serve kernels run on CUDA tensors, got {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dtype(want, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")


def _launch(name: str, lib, rc: int) -> None:
    if rc != 0:
        msg = lib.tile_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: The wrapper's launch shapes, worked out once a shape (a request batch's
#: host time is part of its latency).
_score_shape = functools.lru_cache(maxsize=1024)(score_launch)


def fold_in_solve(B, idx, ratings, mask, lam: float):
    """``x [b, R]`` float32 for ``B [N, R]`` float32 and ``idx`` (int32),
    ``ratings`` and ``mask`` (float32), each ``[b, L]``."""
    if B.device.type == "cpu":
        return fold_in_solve_plain(B, idx, ratings, mask, lam)
    dev = B.device
    _on_card(dev, B=B, idx=idx, ratings=ratings, mask=mask)
    _dtype(torch.float32, B=B, ratings=ratings, mask=mask)
    _dtype(torch.int32, idx=idx)
    if B.dim() != 2 or idx.dim() != 2 or ratings.shape != idx.shape or mask.shape != idx.shape:
        raise ValueError("fold_in_solve takes B [N, R] and idx, ratings, mask [b, L]")
    b, L = idx.shape
    N, R = B.shape
    if min(N, R, L) < 1:
        raise ValueError("fold_in_solve needs N, R and L >= 1")
    shape = fold_in_launch(L, R)
    if shape["smem"] > SMEM_OPTIN:
        raise ValueError(
            f"fold_in_solve at R={R}, L={L} needs {shape['smem']} bytes of shared memory "
            f"a block, past the card's {SMEM_OPTIN}; there is no other path")
    lib = _build.load()
    x = torch.empty(b, R, dtype=torch.float32, device=dev)
    if b:
        _launch("fold_in_solve", lib, lib.fold_in_solve(
            B.data_ptr(), idx.data_ptr(), ratings.data_ptr(), mask.data_ptr(),
            float(lam), x.data_ptr(), b, L, R, N, shape["threads"], shape["smem"],
            _stream(dev)))
    return x


def score_rows(Q, T, tidx=None, out=None):
    """``[n_i, n_j]`` float32: ``Σ_r Q[i, r]·T[t_j, r]`` with ``t_j =
    tidx[j]`` (int32 ``[n_j]``), or ``j`` over every row of ``T`` when
    ``tidx`` is None. With ``out`` (float32 ``[n_i, ld]``, ``ld >= n_j``)
    the scores go into its first n_j columns and the view is returned."""
    if T.device.type == "cpu":
        return score_rows_plain(Q, T, tidx, out)
    dev = T.device
    _on_card(dev, Q=Q, T=T, **({"tidx": tidx} if tidx is not None else {}),
             **({"out": out} if out is not None else {}))
    _dtype(torch.float32, Q=Q, T=T, **({"out": out} if out is not None else {}))
    if tidx is not None:
        _dtype(torch.int32, tidx=tidx)
    if Q.dim() != 2 or T.dim() != 2 or Q.shape[1] != T.shape[1] or min(T.shape) < 1:
        raise ValueError("score_rows takes Q [n_i, R] and T [n_t, R] with one R >= 1")
    n_i, R = Q.shape
    n_j = T.shape[0] if tidx is None else tidx.numel()
    if out is None:
        out = torch.empty(n_i, n_j, dtype=torch.float32, device=dev)
    elif out.dim() != 2 or out.shape[0] != n_i or out.shape[1] < n_j:
        raise ValueError(f"out must be [{n_i}, >= {n_j}]")
    shape = _score_shape(n_i, n_j, R, _sm_count(dev.index))
    if shape["smem"] > SMEM_OPTIN:
        raise ValueError(f"score_rows at R={R} with {n_i} queries needs {shape['smem']} bytes "
                         f"of shared memory a block, past the card's {SMEM_OPTIN}")
    lib = _build.load()
    if n_i and n_j:
        _launch("score_rows", lib, lib.score_rows(
            Q.data_ptr(), T.data_ptr(), tidx.data_ptr() if tidx is not None else None,
            out.data_ptr(), n_i, n_j, R, out.shape[1], T.shape[0], shape["blocks"],
            shape["threads"], shape["rchunk"], shape["smem"], _stream(dev)))
    return out[:, :n_j]


def window_score(K, head, tokens, mask, n_valid: int, window: int, kind=None, param=None):
    """``[b, L]`` float32 token scores (see :func:`window_score_plain`):
    ``K [ctx_cap, R]`` and ``head [R]`` float32, ``tokens`` int32 and
    ``mask`` float32 ``[b, L]``, ``kind``/``param`` int32 ``[b]`` or None
    (the static window)."""
    if K.device.type == "cpu":
        return window_score_plain(K, head, tokens, mask, n_valid, window, kind, param)
    dev = K.device
    dyn = {} if kind is None else {"kind": kind, "param": param}
    _on_card(dev, K=K, head=head, tokens=tokens, mask=mask, **dyn)
    _dtype(torch.float32, K=K, head=head, mask=mask)
    _dtype(torch.int32, tokens=tokens, **dyn)
    if K.dim() != 2 or head.shape != (K.shape[1],) or tokens.dim() != 2 \
            or mask.shape != tokens.shape or min(K.shape) < 1:
        raise ValueError("window_score takes K [n, R], head [R], tokens and mask [b, L]")
    if kind is not None and (kind.shape != (tokens.shape[0],) or param.shape != kind.shape):
        raise ValueError("kind and param must be [b]")
    if window < 0 or not 0 <= n_valid <= K.shape[0]:
        raise ValueError(f"window {window} / n_valid {n_valid} out of range")
    b, L = tokens.shape
    R = K.shape[1]
    out = torch.empty(b, L, dtype=torch.float32, device=dev)
    lib = _build.load()
    if b * L:
        _launch("window_score", lib, lib.window_score(
            K.data_ptr(), head.data_ptr(), tokens.data_ptr(), mask.data_ptr(),
            kind.data_ptr() if kind is not None else None,
            param.data_ptr() if param is not None else None, out.data_ptr(), b * L, L, R,
            window, n_valid, K.shape[0], 1.0 / float(math.sqrt(R)), _stream(dev)))
    return out
