"""The banked CUDA kernel: one launch per row band (counterpart of
``codegen/kernel.py``).

:class:`BankedCudaKernel` takes the place of ``CudaTileKernel`` with the
same tile entry points. Given a :class:`~distributed_sddmm_tpu_torch.
parallel.sharding.BankedTileView` (a tile set built with a banked
variant), each entry point launches once per band (``codegen/banded.py``):
the short and mid bands run the tile kernels with the band's row list, the
heavy band runs the split's pass 1 over its segments and, where an output
row sums its segments, pass 2. The bands write disjoint rows of one
output and the first launch zeroes ``mid`` at the pads, so every slot and
row is written exactly once. ``attn_norm_tile`` stays one launch of the
generic kernel over the whole tile: it runs a thread per slot and never
looks at row lengths.

Given a plain ``TileView`` (a tile set built without banding), every entry
point is the generic kernel's, as ``BankedPallasKernel`` falls through to
``PallasKernel`` (``codegen/kernel.py:111``); the record then reports the
realized variant, None.
"""

from __future__ import annotations

import torch

from distributed_sddmm_tpu_torch.codegen.variants import KernelVariant, variant_from_id
from distributed_sddmm_tpu_torch.ops import cuda_kernels as ck
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.sharding import BankedTileView, TileView


class BankedCudaKernel(CudaTileKernel):
    """The fingerprint-specialised tile kernel: one launch per row band.

    ``variant`` is a :class:`~distributed_sddmm_tpu_torch.codegen.variants.
    KernelVariant` or its id; ``precision`` and ``device`` as for
    :class:`~distributed_sddmm_tpu_torch.ops.cuda_kernels.CudaTileKernel`.
    """

    def __init__(self, variant: KernelVariant | str, precision: str | None = None,
                 device=None):
        super().__init__(precision, device)
        if isinstance(variant, str):
            variant = variant_from_id(variant)
        self.variant = variant
        self.variant_id = variant.variant_id
        self.name = f"{self.name}:{self.variant_id}"

    def sddmm_tile(self, tile: TileView, vals, at, bt):
        if not isinstance(tile, BankedTileView):
            return super().sddmm_tile(tile, vals, at, bt)
        mid = torch.empty(tile.cap, dtype=torch.float32, device=vals.device)
        for i, band in enumerate(tile.bands):
            op = ck.sddmm_split if band.heavy else ck.sddmm_rows
            op(tile, band, vals, at, bt, mid, zero_pads=i == 0)
        return mid

    def spmm_tile(self, tile: TileView, vals, bt):
        if not isinstance(tile, BankedTileView):
            return super().spmm_tile(tile, vals, bt)
        out = torch.empty(tile.n_rows, bt.shape[1], dtype=torch.float32,
                          device=vals.device)
        for band in tile.bands:
            if band.heavy:
                ck.split_reduce(band, ck.spmm_split(tile, band, vals, bt), out)
            else:
                ck.spmm_rows(tile, band, vals, bt, out)
        return out

    def fused_tile(self, tile: TileView, vals, at, bt):
        if not isinstance(tile, BankedTileView):
            return super().fused_tile(tile, vals, at, bt)
        out = torch.empty(tile.n_rows, bt.shape[1], dtype=torch.float32,
                          device=vals.device)
        mid = torch.empty(tile.cap, dtype=torch.float32, device=vals.device)
        for i, band in enumerate(tile.bands):
            if band.heavy:
                work = ck.fused_split(tile, band, vals, at, bt, mid, zero_pads=i == 0)
                ck.split_reduce(band, work, out)
            else:
                ck.fused_rows(tile, band, vals, at, bt, out, mid, zero_pads=i == 0)
        return out, mid

    def attn_stats_tile(self, tile: TileView, gate, logits):
        if not isinstance(tile, BankedTileView):
            return super().attn_stats_tile(tile, gate, logits)
        m = torch.empty(tile.n_rows, dtype=torch.float32, device=gate.device)
        d = torch.empty_like(m)
        for band in tile.bands:
            if band.heavy:
                wm, wd = ck.attn_stats_split(tile, band, gate, logits)
                ck.attn_stats_merge(band, wm, wd, m, d)
            else:
                ck.attn_stats_rows(tile, band, gate, logits, m, d)
        return m, d


def make_banked_kernel(variant: KernelVariant | str, **kw) -> BankedCudaKernel:
    """The banked kernel of a variant or a variant id."""
    return BankedCudaKernel(variant, **kw)
