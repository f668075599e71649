"""Pluggable local SDDMM / SpMM kernels on one sparse tile (counterpart of
``ops/kernels.py``).

* :class:`LocalKernel` — the flat protocol the strategies are written
  against.
* :class:`TorchKernel` — gather-dot SDDMM, ``index_add_`` SpMM and the
  masked-softmax attention passes in plain PyTorch, the counterpart of
  ``XlaKernel``. It runs on any device.
* ``CudaTileKernel`` (``ops/cuda_kernels.py``) — the hand-written tile
  kernels for Hopper, with the same flat protocol.

Tile convention: a tile is a struct-of-arrays ``(rows, cols, vals)`` of
static length, padded with inert entries ``row = col = 0, val = 0``; a
zero value adds nothing to SpMM and gives a zero SDDMM output.
"""

from __future__ import annotations

import functools
from typing import Iterator, Protocol

import torch

# Element budget for the gathered [nnz, R] intermediates (A[rows], B[cols]
# and the SpMM contributions). Past it the ops walk the nonzeros in
# segments so peak memory stays bounded: 2^29 elements is 2 GiB of float32
# per intermediate (the full one-card cell, 33.5M nonzeros at R = 128,
# needs 8 segments).
GATHER_BUDGET = 1 << 29

# Element budget for the one-pass masked-softmax row statistics
# (``attn_stats``). Past it the statistics stream over segments of this
# many values with the online-softmax recurrence, holding two [out_rows]
# running vectors instead of [nnz] temporaries.
ATTN_STREAM_BUDGET = 1 << 24

#: Finite stand-in for -inf in the masked-softmax passes: the max of an
#: empty or fully masked row stays finite, so the rescale
#: ``exp(m_old - m_new)`` never computes ``-inf - -inf``. Every softmax
#: version (flat, tile kernels, float64 oracle) uses it, as the JAX
#: package's do.
ATTN_NEG = -1e30


def segments(n: int, r: int, budget: int) -> Iterator[slice]:
    """Slices of ``range(n)`` whose ``[len, r]`` gathers fit in ``budget``
    elements (one slice covering everything when it all fits)."""
    seg = n if n * r <= budget else max(1, budget // max(r, 1))
    for lo in range(0, n, max(seg, 1)):
        yield slice(lo, min(lo + seg, n))


class LocalKernel(Protocol):
    """Local kernel plugin boundary."""

    def sddmm(self, rows, cols, vals, A, B) -> torch.Tensor:
        """Return ``vals * rowwise_dot(A[rows], B[cols])``."""
        ...

    def spmm(self, rows, cols, vals, B, out_rows: int) -> torch.Tensor:
        """Return ``S_tile @ B`` as a dense ``[out_rows, R]`` tensor."""
        ...


# ------------------------------------------------------------------ #
# Masked softmax over sparse values
#
# The SDDMM values are the row-sparse logits; these passes turn them into
# row-stochastic weights without a dense logit matrix. The mask indicator
# is ``gate != 0`` (pads carry 0 by the tile contract), so a fully masked
# row gets all-zero weights, never NaN.
# ------------------------------------------------------------------ #


def _row_stats(rows, gate, logits, m_floor):
    """Max of each row's unmasked logits (at least ``m_floor``) and the
    sum of ``exp(z - max)`` over them."""
    keep = gate != 0
    m = m_floor.scatter_reduce(0, rows.long(), torch.where(keep, logits, ATTN_NEG),
                               "amax", include_self=True)
    e = torch.where(keep, torch.exp(logits - m[rows]), 0.0)
    return m, torch.zeros_like(m_floor).index_add_(0, rows, e)


def attn_row_stats(rows, gate, logits, out_rows: int,
                   budget: int = ATTN_STREAM_BUDGET):
    """Per-row masked max and sum-of-exp ``(m, d)``, each ``[out_rows]``;
    ``m = ATTN_NEG`` and ``d = 0`` for rows with no unmasked entry. Past
    ``budget`` values it streams over segments, carrying the running max
    and a rescaled denominator: ``d <- d*exp(m_old - m_new) + sum exp(z - m_new)``."""
    m = torch.full((out_rows,), ATTN_NEG, dtype=logits.dtype, device=logits.device)
    if rows.shape[0] <= budget:
        return _row_stats(rows, gate, logits, m)
    d = torch.zeros_like(m)
    for sl in segments(rows.shape[0], 1, budget):
        m_new, cs = _row_stats(rows[sl], gate[sl], logits[sl], m)
        d = d * torch.exp(m - m_new) + cs
        m = m_new
    return m, d


def attn_weights(rows, gate, logits, m, d):
    """``exp(z - m[row]) / d[row]`` at unmasked entries; exactly 0 at
    masked entries, pads and fully masked rows (``d == 0``). ``exp`` runs
    on the select-guarded argument, so a masked ``z - ATTN_NEG`` never
    makes an inf."""
    d_r = d[rows]
    sel = (gate != 0) & (d_r > 0)
    e = torch.exp(torch.where(sel, logits - m[rows], 0.0))
    return torch.where(sel, e / torch.where(sel, d_r, 1.0), 0.0)


def attn_merge_stats(stats):
    """Merge per-partition row stats ``[(m, d), ...]`` over one row frame
    (per tile, per band, per device) by the online-softmax rule: the max
    of the maxima, each denominator rescaled into it. An empty partition
    (``m = ATTN_NEG, d = 0``) adds exactly nothing."""
    m = functools.reduce(torch.maximum, [s[0] for s in stats])
    d = sum(s[1] * torch.exp(s[0] - m) for s in stats)
    return m, d


class TorchKernel:
    """Gather-dot SDDMM, ``index_add_`` SpMM and the masked-softmax passes
    in plain PyTorch.

    ``gather_budget`` and ``stream_budget`` override :data:`GATHER_BUDGET`
    and :data:`ATTN_STREAM_BUDGET` for this instance."""

    name = "torch"

    def __init__(self, gather_budget: int | None = None,
                 stream_budget: int | None = None):
        self.gather_budget = GATHER_BUDGET if gather_budget is None else gather_budget
        self.stream_budget = (ATTN_STREAM_BUDGET if stream_budget is None
                              else stream_budget)

    def sddmm(self, rows, cols, vals, A, B):
        dots = torch.empty(rows.shape[0], dtype=vals.dtype, device=vals.device)
        for sl in segments(rows.shape[0], A.shape[-1], self.gather_budget):
            dots[sl] = torch.sum(A[rows[sl]] * B[cols[sl]], dim=-1).to(vals.dtype)
        return vals * dots

    def spmm(self, rows, cols, vals, B, out_rows: int):
        dtype = torch.promote_types(vals.dtype, B.dtype)
        out = torch.zeros(out_rows, B.shape[-1], dtype=dtype, device=B.device)
        for sl in segments(rows.shape[0], B.shape[-1], self.gather_budget):
            out.index_add_(0, rows[sl], vals[sl, None] * B[cols[sl]])
        return out

    def attn_stats(self, rows, gate, logits, out_rows: int):
        """Row stats ``(m, d)`` of the masked softmax (see
        :func:`attn_row_stats`)."""
        return attn_row_stats(rows, gate, logits, out_rows, self.stream_budget)

    def attn_normalize(self, rows, gate, logits, m, d):
        return attn_weights(rows, gate, logits, m, d)

    def attn_softmax(self, rows, gate, logits, out_rows: int):
        """Stats and weights in one call (the strategies call the two
        halves around their merge of partial stats)."""
        m, d = self.attn_stats(rows, gate, logits, out_rows)
        return self.attn_normalize(rows, gate, logits, m, d)
