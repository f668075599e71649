"""Pluggable local SDDMM / SpMM kernels on one sparse tile (counterpart of
``ops/kernels.py``).

* :class:`LocalKernel` — the flat protocol the strategies are written
  against.
* :class:`TorchKernel` — gather-dot SDDMM and ``index_add_`` SpMM in plain
  PyTorch, the counterpart of ``XlaKernel``. It runs on any device.
* ``CudaTileKernel`` (``ops/cuda_kernels.py``) — the hand-written tile
  kernels for Hopper, with the same flat protocol.

Tile convention: a tile is a struct-of-arrays ``(rows, cols, vals)`` of
static length, padded with inert entries ``row = col = 0, val = 0``; a
zero value adds nothing to SpMM and gives a zero SDDMM output.
"""

from __future__ import annotations

from typing import Iterator, Protocol

import torch

# Element budget for the gathered [nnz, R] intermediates (A[rows], B[cols]
# and the SpMM contributions). Past it the ops walk the nonzeros in
# segments so peak memory stays bounded: 2^29 elements is 2 GiB of float32
# per intermediate (the full one-card cell, 33.5M nonzeros at R = 128,
# needs 8 segments).
GATHER_BUDGET = 1 << 29


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


class TorchKernel:
    """Gather-dot SDDMM and ``index_add_`` SpMM in plain PyTorch.

    ``gather_budget`` overrides :data:`GATHER_BUDGET` for this instance."""

    name = "torch"

    def __init__(self, gather_budget: int | None = None):
        self.gather_budget = GATHER_BUDGET if gather_budget is None else gather_budget

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
