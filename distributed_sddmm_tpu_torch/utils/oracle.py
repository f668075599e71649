"""float64 numpy/scipy reference implementations used as oracles
(counterpart of ``utils/oracle.py``).

SpMM goes through scipy's CSR product and SDDMM is a row-wise einsum in
bounded chunks, so the oracle stays usable at the headline size (2M
nonzeros, R=128) without an ``nnz x R`` float64 temporary per operand.
"""

from __future__ import annotations

import numpy as np

from distributed_sddmm_tpu_torch.ops.kernels import ATTN_NEG
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

# Nonzeros per einsum chunk in ``sddmm``.
_SDDMM_CHUNK = 1 << 18


def sddmm(S: HostCOO, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """``out[k] = S.vals[k] * <A[S.rows[k]], B[S.cols[k]]>``."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    dots = np.empty(S.nnz)
    for lo in range(0, S.nnz, _SDDMM_CHUNK):
        hi = min(lo + _SDDMM_CHUNK, S.nnz)
        dots[lo:hi] = np.einsum(
            "kr,kr->k", A[S.rows[lo:hi]], B[S.cols[lo:hi]]
        )
    return S.vals * dots


def spmm_a(S: HostCOO, B: np.ndarray) -> np.ndarray:
    """``S @ B`` as a dense ``[M, R]`` array."""
    return S.to_scipy() @ np.asarray(B, dtype=np.float64)


def spmm_b(S: HostCOO, A: np.ndarray) -> np.ndarray:
    """``S^T @ A`` as a dense ``[N, R]`` array."""
    return S.transpose().to_scipy() @ np.asarray(A, dtype=np.float64)


def fused_spmm_a(S: HostCOO, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """SDDMM then SpMM-A: ``(S_vals * (A B^T)|_S) @ B``."""
    return spmm_a(S.with_values(sddmm(S, A, B)), B)


def fused_spmm_b(S: HostCOO, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """SDDMM then SpMM-B: ``(S_vals * (A B^T)|_S)^T @ A``."""
    return spmm_b(S.with_values(sddmm(S, A, B)), A)


def masked_softmax(S: HostCOO, logits: np.ndarray) -> np.ndarray:
    """Row-wise masked softmax over sparse logit values, in float64.

    Entries with ``S.vals == 0`` are masked out (the ``gate != 0``
    indicator of the device passes); a row with no unmasked entry gets
    exactly-zero weights, never NaN. The max subtraction is the device
    passes' stable form."""
    z = np.asarray(logits, dtype=np.float64)
    gate = S.vals != 0
    m = np.full(S.M, ATTN_NEG)
    np.maximum.at(m, S.rows[gate], z[gate])
    e = np.zeros_like(z)
    e[gate] = np.exp(z[gate] - m[S.rows[gate]])
    d = np.zeros(S.M)
    np.add.at(d, S.rows, e)
    out = np.zeros_like(z)
    ok = gate & (d[S.rows] > 0)
    out[ok] = e[ok] / d[S.rows[ok]]
    return out


def fused_attention_a(S: HostCOO, A: np.ndarray, B: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Block-sparse attention in float64: SDDMM logits, row-wise masked
    softmax, SpMM. Returns ``(out [M, R], probs [nnz])``, probs in S's
    nonzero order. B mode is this on ``S.transpose()`` with A and B
    swapped."""
    probs = masked_softmax(S, sddmm(S, A, B))
    return spmm_a(S.with_values(probs), B), probs


def dummy_dense(n_rows: int, R: int, dtype=np.float64) -> np.ndarray:
    """Deterministic fill ``value = row * R + col``."""
    return (np.arange(n_rows, dtype=dtype)[:, None] * R
            + np.arange(R, dtype=dtype)[None, :])


def fingerprint(x) -> float:
    """Squared-norm fingerprint."""
    x = np.asarray(x, dtype=np.float64)
    return float(np.sum(x * x))
