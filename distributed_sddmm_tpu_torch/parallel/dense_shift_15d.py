"""1.5D dense-shift strategy with both SDDMM->SpMM fusion approaches
(counterpart of ``parallel/dense_shift_15d.py``).

Grid ``(p/c) x c``: the sparse matrix stays put in block rows, tiles are
pre-skewed into ring-step order, the stationary dense operand is
replicated over the ``cols`` axis (an all-gather of the ``c`` blocks of a
grid row) and the moving one rotates around the ``p/c``-long ``rows``
ring; SpMM partials are reduce-scattered back over ``cols``.
``fusion_approach=2`` runs the fused SDDMM->SpMM tile kernel at every
ring step; ``fusion_approach=1`` runs a whole SDDMM rotation, then a whole
SpMM rotation over its output. Both return the SDDMM values.
``overlap=True`` issues each step's hop before the step's kernels
(``ring_loop_overlap``), with the same results bit for bit.

Each op runs per rank the process holds (every rank under a
``LocalWorld``, one under a ``DistWorld``); the collectives are the comm
layer's (``parallel/comm.py``) through the ablation wrappers of
``parallel/loops.py``. The moving operand is read-only on every ring: each
rank's block is cast to the kernel's type once, before the ring, and the
ring carries what the kernel reads. Under a bf16 wire policy
(``parallel/wire.py``) the stationary gather and a float32 moving block
cross in bf16, and the SpMM reduce-scatter in its role's type (float32
by default).

Block-sparse attention (:meth:`DenseShift15D.fused_attention`) runs a
complete SDDMM rotation over the mask, a row-wise masked softmax over the
logits (row stats merged over the ``c`` ranks of a row frame) and an SpMM
rotation over the weights, whatever the fusion approach: a row's
denominator needs its complete set of logits.
"""

from __future__ import annotations

import torch

from distributed_sddmm_tpu_torch.common import MatMode, divide_round_up
from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.ops.kernels import attn_merge_stats
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.parallel.comm import world_from_env
from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockCyclicColumn
from distributed_sddmm_tpu_torch.parallel.loops import (
    Shifter, abl_all_gather, abl_psum_scatter, ring_loop, ring_loop_overlap,
)
from distributed_sddmm_tpu_torch.parallel.mesh import COLS, ROWS, make_grid
from distributed_sddmm_tpu_torch.parallel.sharding import TileSet, build_tiles
from distributed_sddmm_tpu_torch.utils.coo import HostCOO


class DenseShift15D(DistributedSparse):
    algorithm_name = "1.5D Block Row Replicated S Striped AB Cyclic Shift"
    proc_grid_names = ("# Rows", "# Layers")

    def __init__(self, S: HostCOO, R: int, c: int = 1, fusion_approach: int = 2,
                 kernel=None, adjacency: int = 1, overlap: bool = False,
                 world=None, device=None, wire=None):
        """``world``: a ``LocalWorld`` or ``DistWorld``
        (``parallel/comm.py``); None takes it from the environment
        (``world_from_env``). ``p`` is the world's size. ``wire``: the
        wire-precision policy (``parallel/wire.py``; None: the
        environment's, the f32 identity wire when unset)."""
        if fusion_approach not in (1, 2):
            raise ValueError("fusion_approach must be 1 or 2")
        device = resolve_device(device)
        world = world_from_env(device) if world is None else world
        p = world.p
        if p % c != 0:
            raise ValueError(f"1.5D algorithm requires c | p (p={p}, c={c})")
        super().__init__(S.M, S.N, R, c, world,
                         make_grid(p // c, c, 1, adjacency=adjacency),
                         kernel=kernel, device=device, wire=wire)
        self.fusion_approach = fusion_approach
        self.cost_model_name = "15d_fusion2" if fusion_approach == 2 else "15d_fusion1"
        self.overlap = bool(overlap)
        self.nr = p // c
        self.localArows = divide_round_up(S.M, p)
        self.localBrows = divide_round_up(S.N, p)
        self.M_pad = self.localArows * p
        self.N_pad = self.localBrows * p
        # A codegen kernel's variant bands both tile sets, each by its own
        # row degrees (S^T's rows are S's columns).
        variant = getattr(self.kernel, "variant", None)
        self.S_tiles = build_tiles(
            S, ShardedBlockCyclicColumn(self.M_pad, self.N_pad, p, c),
            tile_rows=self.localArows * c, tile_cols=self.localBrows,
            device=self.device, variant=variant, devs=self.blocks,
        )
        self.ST_tiles = build_tiles(
            S.transpose(), ShardedBlockCyclicColumn(self.N_pad, self.M_pad, p, c),
            tile_rows=self.localBrows * c, tile_cols=self.localArows,
            device=self.device, variant=variant, devs=self.blocks,
        )
        self._note_tile_metrics()

    def comm_profile(self, op: str, pairs: float = 1.0) -> list[dict]:
        """Per-collective word and byte volumes of one op from the layout
        math: a rank's stationary block is ``localArows x R``
        (all-gathered over the c-wide ``cols`` axis), its moving block
        ``localBrows x R`` (hopped around the ``p/c``-long ``rows`` ring),
        and SpMM partials reduce-scatter back over ``cols``; B-output ops
        swap the two. Words are the JAX package's (``in_model`` marks the
        ones its cost model counts). Bytes: the gather and the
        reduce-scatter move their role's wire type under :attr:`wire`; the
        ring moves the blocks in the type the kernel reads (bf16 for a
        bf16 tile kernel) or the ring role's wire type, whichever is
        narrower; the attention stats merge moves float32 always. A
        ``LocalWorld`` moves none of it: its collectives are list
        operations."""
        R, c, nr, wire = self.R, self.c, self.nr, self.wire
        n_pass = 1 if self.fusion_approach == 2 else 2
        stat_rows, mov_rows = self.localArows, self.localBrows
        if op.endswith("B"):
            stat_rows, mov_rows = mov_rows, stat_rows
        # The kernel's operand type, read without a prep call (the ring
        # tests count preps).
        kernel_bytes = 2 if self._tiled and getattr(self.kernel, "precision", "") == "bf16" else 4
        ring_bytes = min(kernel_bytes, wire.bytes_for("ring"))
        repl_words = (c - 1) * stat_rows * R * pairs
        repl = {"collective": "all_gather", "axis": COLS,
                "count": (1 if c > 1 else 0) * pairs, "words": repl_words,
                "bytes": repl_words * wire.bytes_for("gather"), "in_model": True}
        reduce_ = {"collective": "psum_scatter", "axis": COLS,
                   "count": (1 if c > 1 else 0) * pairs, "words": repl_words,
                   "bytes": repl_words * wire.bytes_for("reduce"), "in_model": False}

        def ring(passes):
            words = (nr - 1) * mov_rows * R * passes * pairs
            return {"collective": "ppermute", "axis": ROWS,
                    "count": (nr - 1) * passes * pairs, "words": words,
                    "bytes": words * ring_bytes, "in_model": True}

        if op in ("fusedSpMM", "cgStep", "gatLayer", "fusedSpMMB", "cgStepB"):
            return [repl, ring(n_pass), reduce_]
        if op in ("fusedAttn", "fusedAttnB"):
            merge_words = 2 * (c - 1) * stat_rows * pairs
            merge = {"collective": "pmax+psum", "axis": COLS,
                     "count": (2 if c > 1 else 0) * pairs, "words": merge_words,
                     "bytes": merge_words * 4, "in_model": False}
            return [repl, ring(2), merge, reduce_]
        if op in ("sddmmA", "sddmmB"):
            return [repl, ring(1)]
        if op in ("spmmA", "spmmB"):
            return [ring(1), reduce_]
        return []

    # ------------------------------ ring pieces ---------------------------- #
    # Lists hold one entry per rank this process holds; entry h is tile
    # slot h and dense block ``self.blocks[h]``.

    def _replicate(self, stat, mode: MatMode) -> list:
        """Each rank's stationary row frame: the all-gather of its grid
        row's ``c`` blocks over ``cols``."""
        blocks = self._blocks(stat, mode)
        if self.c > 1:
            blocks = abl_all_gather(self.comm, blocks, COLS, self.c,
                                    self.wire.dtype_for("gather"))
        return self._prep_each(blocks)

    def _moving(self, mov, mode: MatMode) -> list:
        """Each rank's moving block, in the kernel's type: prepared once,
        before the ring."""
        return self._prep_each(self._blocks(mov, mode))

    def _reduce_out(self, accs: list, dtype) -> torch.Tensor:
        """Reduce-scatter the SpMM partials over ``cols`` (c > 1) and
        assemble the output blocks."""
        if self.c > 1:
            accs = abl_psum_scatter(self.comm, accs, COLS, self.c,
                                    self.wire.dtype_for("reduce"))
        return self._assemble(accs).to(dtype)

    def _ring(self, body, carry, movs: list, final_shift: bool = False):
        """``carry = body(s, carry, movs)`` over the ring's steps, the
        moving blocks hopping one rank along ``rows`` between steps (and
        after the last with ``final_shift``). Returns ``(carry, movs)``."""
        shift = Shifter(self.comm, ROWS, self.nr, self.wire.dtype_for("ring"))
        if self.overlap:
            return ring_loop_overlap(self.nr, body, carry, movs, shift.start,
                                     final_shift=final_shift)

        def step(s, state):
            carry, movs = state
            return body(s, carry, movs), movs

        def hop(state):
            carry, movs = state
            return carry, shift(movs)

        return ring_loop(self.nr, step, (carry, movs), hop,
                         hop if final_shift else None)

    # ------------------------------- rings --------------------------------- #

    def _sddmm_ring(self, tiles, ats, movs, vals, final_shift=False):
        def body(s, out, movs):
            for h, mov in enumerate(movs):
                out[h, s] = self._k_sddmm(tiles.tile(h, s), vals[h, s], ats[h], mov)
            return out

        return self._ring(body, torch.empty_like(vals), movs, final_shift)

    def _spmm_ring(self, tiles, movs, vals) -> list:
        def body(s, accs, movs):
            parts = [self._k_spmm(tiles.tile(h, s), vals[h, s], mov)
                     for h, mov in enumerate(movs)]
            return parts if accs is None else [a + p for a, p in zip(accs, parts)]

        return self._ring(body, None, movs)[0]

    def _fused_ring(self, tiles, ats, movs, vals):
        out_vals = torch.empty_like(vals)

        def body(s, accs, movs):
            parts = []
            for h, mov in enumerate(movs):
                part, out_vals[h, s] = self._k_fused(tiles.tile(h, s), vals[h, s], ats[h],
                                                     mov)
                parts.append(part)
            return parts if accs is None else [a + p for a, p in zip(accs, parts)]

        return self._ring(body, None, movs)[0], out_vals

    # --------------------------- masked softmax ---------------------------- #
    # The values double as the mask: ``gate != 0`` marks an attended slot.
    # After a complete SDDMM rotation each rank holds every logit of its
    # rows, spread over its T tiles, which share one row frame.

    def _merge_stats_cols(self, stats: list) -> list:
        """Online-softmax merge of each rank's row stats over the
        replication axis: with c > 1 a row's nonzeros are spread
        column-cyclically over the ``c`` ranks of its row frame, so the
        global max is an all-reduce max and each denominator is rescaled
        into it before an all-reduce sum. The identity at c = 1."""
        if self.c == 1:
            return stats
        ms = self.comm.all_reduce([m for m, _ in stats], COLS, "max")
        ds = self.comm.all_reduce([d * torch.exp(m - mg) for (m, d), mg
                                   in zip(stats, ms)], COLS, "sum")
        return list(zip(ms, ds))

    def _softmax_flat(self, tiles: TileSet, gate, logits):
        """Flat route: each rank's row stats over all of its tiles at once
        (``attn_stats`` of the flat kernel), the c-axis merge, then the
        weights."""
        k = self.kernel
        flat = [(tiles.rows[h].reshape(-1), gate[h].reshape(-1), logits[h].reshape(-1))
                for h in range(len(self.blocks))]
        stats = self._merge_stats_cols([k.attn_stats(r, g, z, tiles.tile_rows)
                                        for r, g, z in flat])
        probs = torch.empty_like(logits)
        for h, ((r, g, z), (m, d)) in enumerate(zip(flat, stats)):
            probs[h] = k.attn_normalize(r, g, z, m, d).reshape(logits.shape[1:])
        return probs

    def _softmax_blk(self, tiles: TileSet, gate, logits):
        """Tile route: one ``attn_stats_tile`` launch per tile, the tile
        merge, the c-axis merge, then one ``attn_norm_tile`` launch per
        tile."""
        k = self.kernel
        views = [[tiles.tile(h, s) for s in range(tiles.n_tiles)]
                 for h in range(len(self.blocks))]
        stats = self._merge_stats_cols([
            attn_merge_stats([k.attn_stats_tile(t, gate[h, s], logits[h, s])
                              for s, t in enumerate(ts)])
            for h, ts in enumerate(views)])
        probs = torch.empty_like(logits)
        for h, (ts, (m, d)) in enumerate(zip(views, stats)):
            for s, t in enumerate(ts):
                probs[h, s] = k.attn_norm_tile(t, gate[h, s], logits[h, s], m, d)
        return probs

    def _softmax(self, use_st: bool, gate, logits):
        tiles = self.ST_tiles if use_st else self.S_tiles
        if self._tiled:
            return self._softmax_blk(tiles, gate, logits)
        return self._softmax_flat(tiles, gate, logits)

    # ------------------------------ programs ------------------------------- #
    # ``use_st``: the transposed tile set (B-output ops), whose stationary
    # operand is B and moving operand A.

    def _sides(self, use_st: bool) -> tuple:
        return ((self.ST_tiles, MatMode.B, MatMode.A) if use_st
                else (self.S_tiles, MatMode.A, MatMode.B))

    def _sddmm(self, use_st: bool, stat, mov, vals):
        tiles, sm, mm = self._sides(use_st)
        return self._sddmm_ring(tiles, self._replicate(stat, sm),
                                self._moving(mov, mm), vals)[0]

    def _spmm(self, use_st: bool, mov, vals):
        tiles, _, mm = self._sides(use_st)
        return self._reduce_out(self._spmm_ring(tiles, self._moving(mov, mm), vals),
                                mov.dtype)

    def _fused(self, use_st: bool, stat, mov, vals):
        tiles, sm, mm = self._sides(use_st)
        ats, movs = self._replicate(stat, sm), self._moving(mov, mm)
        if self.fusion_approach == 2:
            accs, mid = self._fused_ring(tiles, ats, movs, vals)
        else:
            # One replicated stationary block feeds a complete SDDMM
            # rotation, then a complete SpMM rotation over its output.
            mid, movs = self._sddmm_ring(tiles, ats, movs, vals, final_shift=True)
            accs = self._spmm_ring(tiles, movs, mid)
        return self._reduce_out(accs, mov.dtype), mid

    def _attention(self, use_st: bool, stat, mov, vals):
        """SDDMM rotation over the mask values (complete, so every logit of
        a row lands before its softmax), masked softmax, SpMM rotation
        over the weights."""
        tiles, sm, mm = self._sides(use_st)
        logits, movs = self._sddmm_ring(tiles, self._replicate(stat, sm),
                                        self._moving(mov, mm), vals, final_shift=True)
        probs = self._softmax(use_st, vals, logits)
        return self._reduce_out(self._spmm_ring(tiles, movs, probs), mov.dtype), probs

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
        return self._timed("fusedSpMM", self._fused, True, B, A, s_vals,
                           _comm_op="fusedSpMMB")

    # ------------------- block-sparse attention (softmax) ------------------ #

    def fused_attention(self, A, B, s_vals, mode: MatMode = MatMode.A):
        """SDDMM logits at the mask's pattern, a stable row-wise masked
        softmax (``s_vals != 0`` is the mask; fully masked rows come back
        all zero), and the SpMM aggregation. Returns ``(new_dense,
        probs)``, probs in the tile layout of the values; in B mode the
        softmax runs over rows of S^T and the output has B's shape."""
        if mode == MatMode.A:
            return self._timed("fusedAttn", self._attention, False, A, B, s_vals)
        return self._timed("fusedAttn", self._attention, True, B, A, s_vals,
                           _comm_op="fusedAttnB")

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

    # -------------------------- raw op accessor ---------------------------- #

    def attention_program(self, s_vals, mode: MatMode = MatMode.A):
        """``f(A, B) -> (out, probs)``: one fused attention call without
        the per-op counters."""
        if mode == MatMode.A:
            return lambda A, B: self._attention(False, A, B, s_vals)
        return lambda A, B: self._attention(True, B, A, s_vals)
