"""Differentiable tile ops (counterpart of the custom VJPs ``_sddmm_op``,
``_spmm_op`` and ``_fused_op`` of ``ops/pallas_kernels.py:688-770``).

Each :class:`torch.autograd.Function` takes ``(kernel, tile, sv, at,
bt)``: a tile kernel object (``CudaTileKernel`` or ``BankedCudaKernel``),
the tile's CSR view and the operands as the kernel reads them. The
forward is the kernel object's own ``sddmm_tile`` / ``spmm_tile`` /
``fused_tile``: the hand-written kernel on the card, its plain version on
the CPU. The backward is the JAX package's formulas term for term, in
float32, each grad cast to its operand's type at the end. Its
SDDMM-shaped and SpMM-shaped terms run through the same kernel object on
float32 operands (the bf16 SpMM would round each contribution to bf16,
which the JAX backward does not):

* SDDMM ``mid = sv * <A[r], B[c]>``: ``d_sv = g * <A[r], B[c]>`` is the
  SDDMM kernel with values ``g``; ``dA[r] = sum (g * sv) B[c]`` is the
  SpMM kernel with values ``g * sv``.
* SpMM ``out[r] = sum sv B[c]``: ``d_sv = <G[r], B[c]>`` is the SDDMM
  kernel with ``at = G`` and values 1.
* fused: ``<G_out[r], B[c]>`` and the dots ``<A[r], B[c]>`` are two SDDMM
  launches with values 1, ``dA`` the SpMM kernel.

The column scatters (``dB[c] = sum (...) A[r]``, and the fused op's ``+
mid * G_out[r]``) are ``index_add_`` over the tile's columns on the
device, in segments of at most ``GATHER_BUDGET`` gathered elements, as
the plain versions walk. Pad slots carry ``sv = 0``, so they add nothing
to ``dA`` or ``dB``; their ``d_sv`` is whatever the SDDMM gives there (0
from the card's kernel, ``g * <A[0], B[0]>`` from the plain version and
from the JAX formulas), which reaches no dense operand. The tile and the
kernel object ride on ``ctx``: a tile that travels round a ring is
differentiated with the view its step used.
"""

from __future__ import annotations

import torch

from distributed_sddmm_tpu_torch.ops.kernels import GATHER_BUDGET, segments


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous()


def _rows_grad(part: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An SpMM output over the tile's ``n_rows`` as the grad of an operand
    of ``like``'s height (the rows past the frame get none), in its type."""
    extra = like.shape[0] - part.shape[0]
    if extra:
        part = torch.cat([part, part.new_zeros(extra, part.shape[1])])
    return part.to(like.dtype)


def _cols_grad(tile, contrib, like: torch.Tensor) -> torch.Tensor:
    """``out[cols[k]] += contrib(sl)[k]`` over the tile's slots, in float32
    segments, cast to ``like``'s type."""
    R = like.shape[1]
    out = torch.zeros(like.shape[0], R, dtype=torch.float32, device=like.device)
    for sl in segments(tile.cap, R, GATHER_BUDGET):
        out.index_add_(0, tile.cols[sl], contrib(sl))
    return out.to(like.dtype)


def _ones(tile, device) -> torch.Tensor:
    return torch.ones(tile.cap, dtype=torch.float32, device=device)


class SddmmTile(torch.autograd.Function):
    """``mid = sv * <at[rows], bt[cols]>`` (``_sddmm_op``)."""

    @staticmethod
    def forward(ctx, kernel, tile, sv, at, bt):
        ctx.kernel, ctx.tile = kernel, tile
        ctx.save_for_backward(sv, at, bt)
        return kernel.sddmm_tile(tile, sv, at, bt)

    @staticmethod
    def backward(ctx, g):
        sv, at, bt = ctx.saved_tensors
        k, tile = ctx.kernel, ctx.tile
        _, _, need_sv, need_a, need_b = ctx.needs_input_grad
        g = _f32(g)
        A, B = _f32(at), _f32(bt)
        d_sv = dA = dB = None
        if need_sv:
            d_sv = k.sddmm_tile(tile, g, A, B).to(sv.dtype)
        if need_a or need_b:
            gs = (g * sv.float()).contiguous()
            if need_a:
                dA = _rows_grad(k.spmm_tile(tile, gs, B), at)
            if need_b:
                dB = _cols_grad(tile, lambda sl: gs[sl, None] * A[tile.rows[sl]], bt)
        return None, None, d_sv, dA, dB


class SpmmTile(torch.autograd.Function):
    """``out[r] = sum_{k: rows[k] = r} sv[k] * bt[cols[k]]`` (``_spmm_op``)."""

    @staticmethod
    def forward(ctx, kernel, tile, sv, bt):
        ctx.kernel, ctx.tile = kernel, tile
        ctx.save_for_backward(sv, bt)
        return kernel.spmm_tile(tile, sv, bt)

    @staticmethod
    def backward(ctx, g):
        sv, bt = ctx.saved_tensors
        k, tile = ctx.kernel, ctx.tile
        _, _, need_sv, need_b = ctx.needs_input_grad
        G, B = _f32(g), _f32(bt)
        d_sv = dB = None
        if need_sv:
            d_sv = k.sddmm_tile(tile, _ones(tile, G.device), G, B).to(sv.dtype)
        if need_b:
            svf = sv.float()
            dB = _cols_grad(tile, lambda sl: svf[sl, None] * G[tile.rows[sl]], bt)
        return None, None, d_sv, dB


class FusedTile(torch.autograd.Function):
    """``(out, mid)``: the SDDMM, then the SpMM weighted by it
    (``_fused_op``). ``out``'s grad folds into ``mid``'s."""

    @staticmethod
    def forward(ctx, kernel, tile, sv, at, bt):
        ctx.kernel, ctx.tile = kernel, tile
        out, mid = kernel.fused_tile(tile, sv, at, bt)
        ctx.save_for_backward(sv, at, bt, mid)
        return out, mid

    @staticmethod
    def backward(ctx, g_out, g_mid):
        sv, at, bt, mid = ctx.saved_tensors
        k, tile = ctx.kernel, ctx.tile
        _, _, need_sv, need_a, need_b = ctx.needs_input_grad
        G, A, B = _f32(g_out), _f32(at), _f32(bt)
        ones = _ones(tile, G.device)
        g_eff = (g_mid.float() + k.sddmm_tile(tile, ones, G, B)).contiguous()
        d_sv = dA = dB = None
        if need_sv:
            d_sv = (g_eff * k.sddmm_tile(tile, ones, A, B)).to(sv.dtype)
        if need_a or need_b:
            gs = (g_eff * sv.float()).contiguous()
            if need_a:
                dA = _rows_grad(k.spmm_tile(tile, gs, B), at)
            if need_b:
                dB = _cols_grad(tile, lambda sl: gs[sl, None] * A[tile.rows[sl]]
                                + mid[sl, None] * G[tile.rows[sl]], bt)
        return None, None, d_sv, dA, dB
