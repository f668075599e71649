"""Communication volume of the R-split strategies (the part of
``tools/costmodel.py`` the port needs: ``pair_words`` for the models
``15d_sparse``, ``25d_dense`` and ``25d_sparse``, and ``OP_PAIRS``).

Per-device words (float elements) of one fused SDDMM + SpMM pair, the
notebook's first-order accounting: the SpMM reduce-scatter of the dense
shift is folded out; the 2.5D models follow Koanantakool et al.'s 2.5D
volume accounting. The dense-shift strategy counts its collectives itself
(``DenseShift15D.comm_profile``) and has no entry here.
"""

from __future__ import annotations

import math

#: The fraction of one fused pair each op is (``obs/metrics.py``).
OP_PAIRS = {
    "fusedSpMM": 1.0, "fusedSpMMB": 1.0, "fusedAttn": 1.0, "fusedAttnB": 1.0,
    "cgStep": 1.0, "cgStepB": 1.0, "gatLayer": 1.0,
    "sddmmA": 0.5, "sddmmB": 0.5, "spmmA": 0.5, "spmmB": 0.5,
}


def _sqrtpc(p: int, c: int) -> int:
    """sqrt(p/c) of a 2.5D grid; ValueError when p/c is not a square."""
    if c < 1 or p % c:
        raise ValueError(f"c={c} must divide p={p}")
    s = math.isqrt(p // c)
    if s * s * c != p:
        raise ValueError(f"2.5D models require p/c square (p={p}, c={c})")
    return s


def _sparse_shift_words(M, N, R, nnz, p, c):
    """Replicate the stationary operand over the fiber, then ring the tile
    (rows, cols and values: three words a nonzero)."""
    replicate = (c - 1) / c * (N * R * c / p)
    ring = (p / c - 1) * (3 * nnz / p)
    return replicate + ring


def _cannon_dense_words(M, N, R, p, c):
    """Both dense blocks ride the Cannon rotation, each layer covering
    s/c of the s steps; the fiber carries the one-time dense broadcast
    and the output reduce-scatter."""
    s = _sqrtpc(p, c)
    block_a = (M / (s * c)) * (R / s)
    block_b = (N / (s * c)) * (R / s)
    steps = max(s // c, 1)
    replicate = (c - 1) / c * c * (block_a + block_b)
    reduce_out = (c - 1) / c * c * block_a
    return replicate + steps * (block_a + block_b) + reduce_out


def _cannon_sparse_words(M, N, R, nnz, p, c):
    """The sparse tiles are resident (replicated once at ingest); the
    dense blocks ride and the fiber carries the output reduction."""
    s = _sqrtpc(p, c)
    block_a = (M / s) * (R / (s * c))
    block_b = (N / s) * (R / (s * c))
    steps = max(s // c, 1)
    reduce_out = (c - 1) / c * c * block_a
    return steps * (block_a + block_b) + reduce_out


def pair_words(alg: str, M: int, N: int, R: int, nnz: int, p: int, c: int) -> float:
    """Modeled per-device words of one fused pair; ValueError for a grid
    the model cannot take or an unknown model."""
    if c < 1 or p % c:
        raise ValueError(f"c={c} must divide p={p}")
    if alg == "15d_sparse":
        return _sparse_shift_words(M, N, R, nnz, p, c)
    if alg == "25d_dense":
        return _cannon_dense_words(M, N, R, p, c)
    if alg == "25d_sparse":
        return _cannon_sparse_words(M, N, R, nnz, p, c)
    raise ValueError(f"unknown model {alg!r}")
