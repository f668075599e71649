"""The serving bit contract of ``ops/serve_kernels.py`` on the CPU.

``fold_in_solve`` and ``score_rows`` run on the card as hand-written kernels
that must give the bits of their plain versions (``chip_smoke.py`` phase
serve holds them to max abs error 0.0); ``window_score`` keeps the same
order and differs from its plain version only where ``exp`` rounds apart.
Those bits are fixed by one order: each output one float32 accumulator,
summed in ascending r, l, k, j or neighbour, each product and each sum
rounded apart. The plain versions are pinned here, bit for bit, against a
numpy float32 re-implementation of that order, so that the order the
kernels must keep is written down and checked. The square root is the
device's own (``torch.sqrt``: IEEE's on the card, as ``__fsqrt_rn`` is; a
CPU build may round it differently); the window scorer's exponential is one
fixed float32 function on both sides (numpy's, patched in for
``torch.exp``: torch's CPU exp has given another last bit from one call to
the next, and the order, not the exponential, is what is pinned); every
other step is numpy's float32 arithmetic.

The launch shapes of the kernels are plain Python (``score_launch``,
``fold_in_launch``, ``window_launch``) and are checked against the card's
limits here.
"""

import math

import numpy as np
import pytest
import torch

from distributed_sddmm_tpu_torch.ops import serve_kernels
from distributed_sddmm_tpu_torch.ops.kernels import ATTN_NEG

F32 = np.float32
#: The serving shapes: the ALS scores (8 queries x 2**20 items, R = 128)
#: and the GAT head (1 query x 512 gathered nodes, 512 features).
ALS = (8, 1 << 20, 128)
GAT = (1, 512, 512)
H100_SMS = 132
#: The attention serve cell: 8 requests x 64 token slots, and 2 x 4 (the
#: batch a 100 Hz stream mostly makes); W = 2w + 1 at w = 16, R = 128.
WINDOW = ((8, 64), (2, 4))
WINDOW_W, WINDOW_R = 33, 128


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def _sqrt(a):
    """The device's float32 square root (the plain version's)."""
    return torch.sqrt(torch.from_numpy(np.asarray(a, F32))).numpy()


def score_rows_numpy(Q, T, tidx=None):
    """``Σ_r Q[i, r]·T[t_j, r]``: one accumulator an output, ascending r."""
    rows = T if tidx is None else T[np.clip(tidx, 0, T.shape[0] - 1)]
    acc = np.zeros((Q.shape[0], rows.shape[0]), F32)
    for r in range(Q.shape[1]):
        acc = acc + Q[:, r, None] * rows[None, :, r]
    return acc


def fold_in_numpy(B, idx, ratings, mask, lam: float):
    """The ridge fold-in in the kernel's order: the masked rows, the Gram
    and rhs over ascending l, a left-looking Cholesky (each diagonal's sum
    of squares and each off-diagonal dot over ascending k), then forward
    and back substitution, one column at a time."""
    b, L = idx.shape
    R = B.shape[1]
    lam32 = F32(lam)
    x = np.zeros((b, R), F32)
    for q in range(b):
        rows = B[np.clip(idx[q], 0, B.shape[0] - 1)] * mask[q][:, None]
        w = ratings[q] * mask[q]
        gram, rhs = np.zeros((R, R), F32), np.zeros(R, F32)
        for l in range(L):
            gram = gram + rows[l][:, None] * rows[l][None, :]
            rhs = rhs + rows[l] * w[l]
        low, diag = np.zeros((R, R), F32), np.zeros(R, F32)
        for j in range(R):
            s = F32(0)
            for k in range(j):
                s = F32(s + low[j, k] * low[j, k])
            diag[j] = _sqrt(F32(F32(gram[j, j] + lam32) - s))
            for i in range(j + 1, R):
                t = F32(0)
                for k in range(j):
                    t = F32(t + low[i, k] * low[j, k])
                low[i, j] = F32(F32(gram[i, j] - t) / diag[j])
        v, y = rhs.copy(), np.zeros(R, F32)
        for j in range(R):
            y[j] = F32(v[j] / diag[j])
            v[j + 1:] = v[j + 1:] - low[j + 1:, j] * y[j]
        for j in reversed(range(R)):
            x[q, j] = F32(y[j] / diag[j])
            y[:j] = y[:j] - low[j, :j] * x[q, j]
    return x


def _exp(a):
    """The float32 exponential of both sides of the window scorer's test."""
    return np.exp(np.asarray(a, F32))


def window_score_numpy(K, head, tokens, mask, n_valid: int, w: int, kind=None, param=None,
                       kept=None):
    """The window scorer in the kernel's order, a token slot at a time over
    every slot (padded ones too): for neighbour o of token t (row t + o - w,
    clamped into K; valid when inside [0, n_valid)) dot_o = sum_r q[r]
    kn_o[r] and hv_o = sum_r kn_o[r] head[r], ascending r; z_o = dot_o *
    (1/sqrt R), ATTN_NEG where not valid; kept are the valid neighbours
    that the request's rule keeps (window:p: |o - w| <= p; topk:p: fewer
    than p logits above z_o, so every tie at the threshold stays); m the
    max of the kept logits and ATTN_NEG; e_o = exp(z_o - m) where kept, else
    0; d = sum_o e_o and num = sum_o e_o hv_o, ascending o; the reply num /
    d (1 where d is 0) times the slot's mask. ``kept``, a list, takes the
    keep mask [b, L, W]."""
    cap, R = K.shape
    W = 2 * w + 1
    offs = np.arange(-w, w + 1)
    tok = tokens.astype(np.int64)
    nb = tok[..., None] + offs                                  # (b, L, W)
    valid = (nb >= 0) & (nb < n_valid)
    q = K[np.clip(tok, 0, cap - 1)]                             # (b, L, R)
    kn = K[np.clip(nb, 0, cap - 1)]                             # (b, L, W, R)
    dot, hv = np.zeros(nb.shape, F32), np.zeros(nb.shape, F32)
    for r in range(R):
        dot = dot + q[..., r, None] * kn[..., r]
        hv = hv + kn[..., r] * head[r]
    neg = F32(ATTN_NEG)
    z = np.where(valid, dot * F32(1.0 / math.sqrt(R)), neg)
    keep = valid.copy()
    if kind is not None:
        for i in range(tokens.shape[0]):
            p = int(param[i])
            if kind[i] == 1:
                above = (z[i][..., None, :] > z[i][..., :, None]).sum(-1)
                keep[i] &= above < min(max(p, 1), W)
            else:
                keep[i] &= np.abs(offs) <= p
    if kept is not None:
        kept.append(keep)
    m = np.where(keep, z, neg).max(-1, keepdims=True)
    e = np.where(keep, _exp(z - m), F32(0))
    d, num = np.zeros(tok.shape, F32), np.zeros(tok.shape, F32)
    for o in range(W):
        d = d + e[..., o]
        num = num + e[..., o] * hv[..., o]
    return num / np.where(d > 0, d, F32(1)) * mask


@pytest.mark.parametrize("rule", ["static", "window", "topk_ties", "mixed"])
def test_window_score_plain_is_the_stated_order(rule, monkeypatch):
    monkeypatch.setattr(torch, "exp", lambda t: torch.from_numpy(_exp(t.numpy())))
    rng = np.random.default_rng(len(rule))
    cap, R, w, b, L = 97, 24, 5, 4, 6
    W = 2 * w + 1
    K = (rng.standard_normal((cap, R)) / np.sqrt(R)).astype(F32)
    head = (rng.standard_normal(R) / np.sqrt(R)).astype(F32)
    if rule in ("topk_ties", "mixed"):
        K[1::3] = K[0::3][:K[1::3].shape[0]]    # repeated rows: tied logits
    n_valid = cap if rule == "static" else cap - 7
    tokens = rng.integers(0, n_valid, size=(b, L)).astype(np.int32)
    tokens[0, :3] = (0, n_valid - 1, 1)         # both ends of the context
    mask = np.ones((b, L), F32)
    mask[b - 1, L // 2:] = 0.0                  # padded slots
    tokens[b - 1, L // 2:] = 0
    kind = param = None
    if rule == "window":
        kind = np.zeros(b, np.int32)
        param = np.array([0, 2, w, w + 3], np.int32)
    elif rule == "topk_ties":
        kind = np.ones(b, np.int32)
        param = np.array([1, 3, W, W + 4], np.int32)
    elif rule == "mixed":
        kind = np.array([1, 0, 1, 0], np.int32)
        param = np.array([2, 1, 5, 0], np.int32)
    kept = []
    want = window_score_numpy(K, head, tokens, mask, n_valid, w, kind, param, kept)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = serve_kernels.window_score_plain(t(K), t(head), t(tokens), t(mask), n_valid, w,
                                           t(kind), t(param)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.isfinite(got).all() and not np.any(got[b - 1, L // 2:])
    if rule == "topk_ties":
        # The ties are real: some token keeps more than p neighbours, every
        # tie at its threshold.
        assert any((kept[0][i].sum(-1) > param[i]).any() for i in range(1, 3))


@pytest.mark.parametrize("n_i, R, gather", [(8, 128, False), (1, 512, True)],
                         ids=["als_8x128_out", "gat_1x512_tidx"])
def test_score_rows_plain_is_the_stated_order(n_i, R, gather):
    rng = np.random.default_rng(3)
    n_t, n_j = 300, 200
    Q = rng.standard_normal((n_i, R)).astype(F32)
    T = rng.standard_normal((n_t if gather else n_j, R)).astype(F32)
    tidx = rng.integers(-2, n_t + 2, size=n_j).astype(np.int32) if gather else None
    want = score_rows_numpy(Q, T, tidx)
    if gather:
        got = serve_kernels.score_rows_plain(torch.from_numpy(Q), torch.from_numpy(T),
                                             torch.from_numpy(tidx))
    else:
        # As the ALS workload calls it: into the first N columns of [b, N + 1].
        out = torch.full((n_i, n_j + 1), 7.0)
        got = serve_kernels.score_rows_plain(torch.from_numpy(Q), torch.from_numpy(T), out=out)
        assert bool((out[:, n_j] == 7.0).all())
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("L, R", [(6, 8), (17, 16), (30, 24), (64, 32)])
def test_fold_in_plain_is_the_stated_order(L, R):
    rng = np.random.default_rng(L * 100 + R)
    N, b = 90, 4
    B = rng.standard_normal((N, R)).astype(F32)
    idx = rng.integers(-3, N + 3, size=(b, L)).astype(np.int32)
    ratings = rng.standard_normal((b, L)).astype(F32)
    mask = (rng.random((b, L)) < 0.6).astype(F32)
    mask[0] = 1.0            # every slot rated
    mask[2] = 0.0            # a fully padded row: x = 0
    mask[3, L // 2:] = 0.0   # masked tail
    want = fold_in_numpy(B, idx, ratings, mask, 0.1)
    got = serve_kernels.fold_in_solve_plain(torch.from_numpy(B), torch.from_numpy(idx),
                                            torch.from_numpy(ratings), torch.from_numpy(mask),
                                            0.1).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert not np.any(got[2])


def test_score_launch_at_the_serving_shapes():
    als = serve_kernels.score_launch(*ALS, sms=H100_SMS)
    assert als["smem"] <= serve_kernels.SMEM_OPTIN
    assert als["blocks"] >= H100_SMS
    gat = serve_kernels.score_launch(*GAT, sms=H100_SMS)
    assert gat["smem"] <= serve_kernels.SMEM_OPTIN
    # The parent kernel took 512 / 64 = 8 blocks at the GAT head.
    assert gat["blocks"] > 8
    for shape in (als, gat):
        assert shape["threads"] % 32 == 0 and shape["items"] == serve_kernels.SCORE_ITEMS
        assert shape["rchunk"] in (32, 128)


@pytest.mark.parametrize("n_i", [1, 2, 7, 8, 9, 33, 64])
@pytest.mark.parametrize("R", [8, 33, 128, 512])
def test_score_launch_fits_the_card(n_i, R):
    for n_j in (1, 31, 512, 4097, 1 << 20):
        shape = serve_kernels.score_launch(n_i, n_j, R, sms=H100_SMS)
        assert shape["smem"] <= serve_kernels.SMEM_OPTIN, (n_i, n_j, R, shape)
        tiles = -(-n_j // shape["items"])
        warps = shape["threads"] // 32
        assert 1 <= shape["blocks"] <= max(1, -(-tiles // warps))
        # Blocks resident at once: each one's shared memory and the card's
        # reserve fit an SM as often as the grid asks.
        per_sm = -(-shape["blocks"] // H100_SMS)
        assert per_sm * (shape["smem"] + serve_kernels.SMEM_RESERVED) <= serve_kernels.SMEM_SM


def test_fold_in_launch_at_the_serving_shape():
    shape = serve_kernels.fold_in_launch(64, 128)
    assert shape["smem"] == serve_kernels.fold_in_smem_bytes(64, 128) == 102656
    # A thread a row of the factor, then the helper warp.
    assert shape["threads"] >= 128 + 32 and shape["threads"] % 32 == 0
    for L in (1, 16, 64):
        for R in (1, 33, 128, 200):
            shape = serve_kernels.fold_in_launch(L, R)
            assert shape["threads"] >= -(-R // 32) * 32 + 32
            assert shape["threads"] <= 1024


@pytest.mark.parametrize("b, L", WINDOW)
def test_window_launch_at_the_serving_shapes(b, L):
    shape = serve_kernels.window_launch(b * L, WINDOW_W, WINDOW_R)
    # A block a token slot, a thread a chain (2W = 66 of them) in whole warps.
    assert shape["blocks"] == b * L
    assert shape["threads"] == 96
    assert shape["rchunk"] == 64
    # Under the 48 KB every block gets without opting in.
    assert shape["smem"] == serve_kernels.window_smem_bytes(WINDOW_W, 64) <= 48 * 1024


@pytest.mark.parametrize("w", [0, 1, 16, 64, 138, 139, 140, 255, 256, 263, 264, 511, 1815,
                               2073, 2074])
@pytest.mark.parametrize("R", [1, 20, 33, 128, 512])
def test_window_launch_fits_or_raises(w, R):
    W = 2 * w + 1
    if serve_kernels.window_smem_bytes(W, 4) > serve_kernels.SMEM_OPTIN:
        with pytest.raises(ValueError, match="no other path"):
            serve_kernels.window_launch(8, W, R)
        return
    shape = serve_kernels.window_launch(8, W, R)
    # A thread a chain in whole warps, at most 1024 (a thread then takes
    # several chains), and at most 32 neighbours a thread.
    assert shape["threads"] == min(-(-2 * W // 32) * 32, serve_kernels.WINDOW_MAX_THREADS)
    assert shape["threads"] * 32 >= W
    assert shape["smem"] == serve_kernels.window_smem_bytes(W, shape["rchunk"])
    assert shape["smem"] <= serve_kernels.SMEM_OPTIN
    # Chunks of 64 features wherever they fit (up to w = 139) and R needs
    # more than 32, of 32 up to w = 263, else of 4.
    assert shape["rchunk"] == (64 if R > 32 and w <= 139 else 32 if w <= 263 else 4)
    # Stage rows are an odd count of 16-byte words.
    ld = 4 if shape["rchunk"] == 4 else shape["rchunk"] + 4
    assert ld // 4 % 2 == 1


def test_window_launch_takes_every_window_a_warp_a_token_fit():
    # A warp a token, four tokens a block, took 64 W bytes of shared memory:
    # every W that fit the card so stays served (up to w = 1815).
    widest = serve_kernels.SMEM_OPTIN // 64 // 2 - 1
    assert widest == 1815
    for w in range(widest + 1):
        shape = serve_kernels.window_launch(1, 2 * w + 1, 128)
        assert shape["smem"] <= serve_kernels.SMEM_OPTIN
