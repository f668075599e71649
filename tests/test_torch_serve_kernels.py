"""The serving bit contract of ``ops/serve_kernels.py`` on the CPU.

``fold_in_solve`` and ``score_rows`` run on the card as hand-written kernels
that must give the bits of their plain versions (``chip_smoke.py`` phase
serve holds them to max abs error 0.0). Those bits are fixed by one order:
each output one float32 accumulator, summed in ascending r, l, k or j, each
product and each sum rounded apart. The plain versions are pinned here, bit
for bit, against a numpy float32 re-implementation of that order, so that
the order the kernels must keep is written down and checked. The square
root is the device's own (``torch.sqrt``: IEEE's on the card, as
``__fsqrt_rn`` is; a CPU build may round it differently), every other step
is numpy's float32 arithmetic.

The launch shapes of the kernels are plain Python (``score_launch``,
``fold_in_launch``) and are checked against the card's limits here.
"""

import numpy as np
import pytest
import torch

from distributed_sddmm_tpu_torch.ops import serve_kernels

F32 = np.float32
#: The serving shapes: the ALS scores (8 queries x 2**20 items, R = 128)
#: and the GAT head (1 query x 512 gathered nodes, 512 features).
ALS = (8, 1 << 20, 128)
GAT = (1, 512, 512)
H100_SMS = 132


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
