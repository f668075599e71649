"""1.5D dense-shift strategy with both SDDMM->SpMM fusion approaches
(counterpart of ``parallel/dense_shift_15d.py``).

Grid ``(p/c) x c``: the sparse matrix stays put in block rows, tiles are
pre-skewed into ring-step order, the stationary dense operand is
replicated over the ``c`` axis and the moving one rotates around the
``p/c`` ring. ``fusion_approach=2`` runs the fused SDDMM->SpMM tile kernel
at every ring step; ``fusion_approach=1`` runs a whole SDDMM rotation,
then a whole SpMM rotation over its output. Both return the SDDMM values.

Block-sparse attention (:meth:`DenseShift15D.fused_attention`) runs a
complete SDDMM rotation over the mask, a row-wise masked softmax over the
logits and an SpMM rotation over the weights, whatever the fusion
approach: a row's denominator needs its complete set of logits.

This slice runs one rank (``p = c = 1``): the ring has one step, so its
shift is the identity and no collective runs. The ring structure stays so
that the communication layer slots in later.
"""

from __future__ import annotations

import torch

from distributed_sddmm_tpu_torch.common import MatMode, divide_round_up
from distributed_sddmm_tpu_torch.ops.kernels import attn_merge_stats
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockCyclicColumn
from distributed_sddmm_tpu_torch.parallel.sharding import TileSet, build_tiles
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

_MULTI_RANK = ("p > 1 needs the comm, mesh and ring layer, which is not "
               "ported yet (ROADMAP.md, queue A item 5)")


class DenseShift15D(DistributedSparse):
    algorithm_name = "1.5D Block Row Replicated S Striped AB Cyclic Shift"
    proc_grid_names = ("# Rows", "# Layers")

    def __init__(self, S: HostCOO, R: int, c: int = 1, fusion_approach: int = 2,
                 kernel=None, p: int = 1, device=None):
        if p % c != 0:
            raise ValueError(f"1.5D algorithm requires c | p (p={p}, c={c})")
        if fusion_approach not in (1, 2):
            raise ValueError("fusion_approach must be 1 or 2")
        if p > 1:
            raise NotImplementedError(_MULTI_RANK)
        super().__init__(S.M, S.N, R, c, p, kernel=kernel, device=device)
        self.fusion_approach = fusion_approach
        self.nr = p // c
        self.localArows = divide_round_up(S.M, p)
        self.localBrows = divide_round_up(S.N, p)
        self.M_pad = self.localArows * p
        self.N_pad = self.localBrows * p
        self.S_tiles = build_tiles(
            S, ShardedBlockCyclicColumn(self.M_pad, self.N_pad, p, c),
            tile_rows=self.localArows * c, tile_cols=self.localBrows,
            device=self.device,
        )
        self.ST_tiles = build_tiles(
            S.transpose(), ShardedBlockCyclicColumn(self.N_pad, self.M_pad, p, c),
            tile_rows=self.localBrows * c, tile_cols=self.localArows,
            device=self.device,
        )

    # ------------------------------ ring pieces ---------------------------- #
    # This process holds grid coordinate (0, 0): device slot 0 of the tiles.
    # With c = 1 the stationary block needs no all-gather and the output no
    # reduce-scatter; the comm layer adds both with p > 1.

    def _after_step(self, s: int, mov, final_shift: bool = False):
        """Shift the moving block one rank along the ring between steps,
        and after the last one if asked. On a ring of one rank the
        permutation is the identity."""
        return mov

    @property
    def _tiled(self) -> bool:
        return getattr(self.kernel, "is_tiled", False)

    def _stationary(self, stat):
        return self.kernel.prep(stat) if self._tiled else stat

    # ------------------------------ local ops ------------------------------ #

    def _tile_sddmm(self, tiles: TileSet, s: int, vals, at, mov):
        t, k = tiles.tile(0, s), self.kernel
        if self._tiled:
            return k.sddmm_tile(t, vals, at, k.prep(mov))
        return k.sddmm(t.rows, t.cols, vals, at, mov)

    def _tile_spmm(self, tiles: TileSet, s: int, vals, mov):
        t, k = tiles.tile(0, s), self.kernel
        if self._tiled:
            return k.spmm_tile(t, vals, k.prep(mov))
        return k.spmm(t.rows, t.cols, vals, mov, t.n_rows)

    def _tile_fused(self, tiles: TileSet, s: int, vals, at, mov):
        t, k = tiles.tile(0, s), self.kernel
        if self._tiled:
            return k.fused_tile(t, vals, at, k.prep(mov))
        mid = k.sddmm(t.rows, t.cols, vals, at, mov)
        return k.spmm(t.rows, t.cols, mid, mov, t.n_rows), mid

    # ------------------------------- rings --------------------------------- #

    def _sddmm_ring(self, tiles, at, mov, vals, final_shift=False):
        out = torch.empty_like(vals)
        for s in range(self.nr):
            out[0, s] = self._tile_sddmm(tiles, s, vals[0, s], at, mov)
            mov = self._after_step(s, mov, final_shift)
        return out, mov

    def _spmm_ring(self, tiles, mov, vals):
        acc = None
        for s in range(self.nr):
            part = self._tile_spmm(tiles, s, vals[0, s], mov)
            acc = part if acc is None else acc + part
            mov = self._after_step(s, mov)
        return acc

    def _fused_ring(self, tiles, at, mov, vals):
        acc, out_vals = None, torch.empty_like(vals)
        for s in range(self.nr):
            part, out_vals[0, s] = self._tile_fused(tiles, s, vals[0, s], at, mov)
            acc = part if acc is None else acc + part
            mov = self._after_step(s, mov)
        return acc, out_vals

    # --------------------------- masked softmax ---------------------------- #
    # The values double as the mask: ``gate != 0`` marks an attended slot.
    # After a complete SDDMM rotation the device holds every logit of its
    # rows, spread over its T tiles, which share one row frame.

    def _merge_stats_cols(self, m, d):
        """Online-softmax merge of the row stats over the replication
        axis: with c > 1 a row's nonzeros are spread column-cyclically
        over the ``c`` devices of its row frame, so the global max is an
        all-reduce max and each denominator is rescaled into it before an
        all-reduce sum. The identity at c = 1."""
        if self.c == 1:
            return m, d
        mg = self._cols_all_reduce(m, "max")
        return mg, self._cols_all_reduce(d * torch.exp(m - mg), "sum")

    def _cols_all_reduce(self, x, op: str):
        """All-reduce over the ``c`` axis (the comm layer's)."""
        raise NotImplementedError(_MULTI_RANK)

    def _softmax_flat(self, tiles: TileSet, gate, logits):
        """Flat route: row stats over all of the device's tiles at once
        (``attn_stats`` of the flat kernel), the c-axis merge, then the
        weights."""
        k = self.kernel
        rows, g, z = tiles.rows[0].reshape(-1), gate[0].reshape(-1), logits[0].reshape(-1)
        m, d = self._merge_stats_cols(*k.attn_stats(rows, g, z, tiles.tile_rows))
        probs = torch.empty_like(logits)
        probs[0] = k.attn_normalize(rows, g, z, m, d).reshape(logits.shape[1:])
        return probs

    def _softmax_blk(self, tiles: TileSet, gate, logits):
        """Tile route: one ``attn_stats_tile`` launch per tile, the tile
        merge, the c-axis merge, then one ``attn_norm_tile`` launch per
        tile."""
        k = self.kernel
        views = [tiles.tile(0, s) for s in range(tiles.n_tiles)]
        m, d = attn_merge_stats([k.attn_stats_tile(t, gate[0, s], logits[0, s])
                                 for s, t in enumerate(views)])
        m, d = self._merge_stats_cols(m, d)
        probs = torch.empty_like(logits)
        for s, t in enumerate(views):
            probs[0, s] = k.attn_norm_tile(t, gate[0, s], logits[0, s], m, d)
        return probs

    def _softmax(self, use_st: bool, gate, logits):
        tiles = self.ST_tiles if use_st else self.S_tiles
        if self._tiled:
            return self._softmax_blk(tiles, gate, logits)
        return self._softmax_flat(tiles, gate, logits)

    # ------------------------------ programs ------------------------------- #

    def _sddmm(self, use_st: bool, stat, mov, vals):
        tiles = self.ST_tiles if use_st else self.S_tiles
        return self._sddmm_ring(tiles, self._stationary(stat), mov, vals)[0]

    def _spmm(self, use_st: bool, mov, vals):
        tiles = self.ST_tiles if use_st else self.S_tiles
        return self._spmm_ring(tiles, mov, vals).to(mov.dtype)

    def _fused(self, use_st: bool, stat, mov, vals):
        tiles = self.ST_tiles if use_st else self.S_tiles
        at = self._stationary(stat)
        if self.fusion_approach == 2:
            acc, mid = self._fused_ring(tiles, at, mov, vals)
        else:
            # One replicated stationary block feeds a complete SDDMM
            # rotation, then a complete SpMM rotation over its output.
            mid, mov = self._sddmm_ring(tiles, at, mov, vals, final_shift=True)
            acc = self._spmm_ring(tiles, mov, mid)
        return acc.to(mov.dtype), mid

    def _attention(self, use_st: bool, stat, mov, vals):
        """SDDMM rotation over the mask values (complete, so every logit of
        a row lands before its softmax), masked softmax, SpMM rotation
        over the weights."""
        tiles = self.ST_tiles if use_st else self.S_tiles
        logits, mov = self._sddmm_ring(tiles, self._stationary(stat), mov, vals,
                                       final_shift=True)
        probs = self._softmax(use_st, vals, logits)
        return self._spmm_ring(tiles, mov, probs).to(mov.dtype), probs

    # ------------------------------ public ops ----------------------------- #

    def sddmm_a(self, A, B, s_vals):
        return self._timed("sddmmA", self._sddmm, False, A, B, s_vals)

    def sddmm_b(self, A, B, st_vals):
        return self._timed("sddmmB", self._sddmm, True, B, A, st_vals)

    def spmm_a(self, A, B, s_vals):
        """``S @ B``; A is not added in."""
        return self._timed("spmmA", self._spmm, False, B, s_vals)

    def spmm_b(self, A, B, st_vals):
        return self._timed("spmmB", self._spmm, True, A, st_vals)

    def fused_spmm(self, A, B, s_vals, mode: MatMode = MatMode.A):
        """Returns ``(new_dense, sddmm_vals)``; in B mode the values are in
        S^T's tile layout and the output has B's shape."""
        if mode == MatMode.A:
            return self._timed("fusedSpMM", self._fused, False, A, B, s_vals)
        return self._timed("fusedSpMM", self._fused, True, B, A, s_vals)

    # ------------------- block-sparse attention (softmax) ------------------ #

    def fused_attention(self, A, B, s_vals, mode: MatMode = MatMode.A):
        """SDDMM logits at the mask's pattern, a stable row-wise masked
        softmax (``s_vals != 0`` is the mask; fully masked rows come back
        all zero), and the SpMM aggregation. Returns ``(new_dense,
        probs)``, probs in the tile layout of the values; in B mode the
        softmax runs over rows of S^T and the output has B's shape."""
        if mode == MatMode.A:
            return self._timed("fusedAttn", self._attention, False, A, B, s_vals)
        return self._timed("fusedAttn", self._attention, True, B, A, s_vals)

    def attention_softmax(self, s_vals, logits, mode: MatMode = MatMode.A):
        """The masked softmax alone, over tile-layout logits: the middle
        step of the unfused baseline, the same code as the fused op's."""
        return self._timed("attnSoftmax", self._softmax, mode == MatMode.B,
                           s_vals, logits)

    def attention_unfused(self, A, B, s_vals, mode: MatMode = MatMode.A):
        """SDDMM, softmax and SpMM as three separate ops; equal to
        :meth:`fused_attention` bit for bit (same kernels, same order)."""
        sddmm, spmm = ((self.sddmm_a, self.spmm_a) if mode == MatMode.A
                       else (self.sddmm_b, self.spmm_b))
        probs = self.attention_softmax(s_vals, sddmm(A, B, s_vals), mode)
        return spmm(A, B, probs), probs

    def attention_program(self, s_vals, mode: MatMode = MatMode.A):
        """``f(A, B) -> (out, probs)``: one fused attention call without
        the per-op counters."""
        if mode == MatMode.A:
            return lambda A, B: self._attention(False, A, B, s_vals)
        return lambda A, B: self._attention(True, B, A, s_vals)
