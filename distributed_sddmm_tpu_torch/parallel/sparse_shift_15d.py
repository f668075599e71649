"""1.5D sparse-shift strategy: the sparse tile rotates, the dense operands
stay put, R-split (counterpart of ``parallel/sparse_shift_15d.py``).

Grid ``(p/c) x c``. Block row ``b`` of the sparse matrix lives on rank
``(b // c, b % c)`` as one tile whose column indices stay global
(``ShardedBlockRow``). Dense operands are split ``p/c`` ways in R: rank
``(i, j)`` holds R-slice ``i`` of the row blocks ``s * c + j`` for every
stripe ``s`` (the JAX package's ``P(None, "cols", None, "rows")``), one
contiguous ``(p/c * block, R * c / p)`` block. The stationary operand is
all-gathered over ``cols`` into all ``N_pad`` rows of the rank's R-slice;
the tile (and for SDDMM its partial R-slice dots, which a whole ring trip
sums into the full dot) travels round the ``p/c``-long ``rows`` ring. SpMM
writes, at each step, the output stripe of the tile held. ``fused_spmm``
chains the SDDMM and the SpMM (the base's): a dot is complete only after
a ring trip, so the fused tile kernel has no place here. ``overlap=True``
issues each step's hop of the tile before the step's kernel; the SDDMM's
dots, which the kernel writes, hop after it.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import MatMode, divide_round_up
from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.parallel.comm import world_from_env
from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockRow
from distributed_sddmm_tpu_torch.parallel.loops import (
    Shifter, abl_all_gather, ablation, ring_loop, ring_loop_overlap,
)
from distributed_sddmm_tpu_torch.parallel.mesh import COLS, ROWS, make_grid
from distributed_sddmm_tpu_torch.parallel.sharding import build_tiles
from distributed_sddmm_tpu_torch.utils.coo import HostCOO


class SparseShift15D(DistributedSparse):
    algorithm_name = "1.5D Sparse Shifting Dense Replicating Algorithm"
    cost_model_name = "15d_sparse"
    proc_grid_names = ("# Rows", "# Layers")
    r_split = True
    #: The axis a consumer's dot products over R reduce on.
    r_split_axis = ROWS

    def __init__(self, S: HostCOO, R: int, c: int = 1, kernel=None, adjacency: int = 1,
                 overlap: bool = False, world=None, device=None):
        device = resolve_device(device)
        world = world_from_env(device) if world is None else world
        p = world.p
        if p % c != 0:
            raise ValueError(f"1.5D algorithm requires c | p (p={p}, c={c})")
        nr = p // c
        if R % nr != 0:
            raise ValueError(
                f"sparse-shift requires (p/c) | R (R={R}, p/c={nr}): the R "
                "dimension is split across the shift axis "
                "(reference check at 15D_sparse_shift.hpp:145-147)"
            )
        super().__init__(S.M, S.N, R, c, world, make_grid(nr, c, 1, adjacency=adjacency),
                         kernel=kernel, device=device)
        self.overlap = bool(overlap)
        self.nr = nr
        self.blockAwidth = divide_round_up(S.M, p)
        self.blockBwidth = divide_round_up(S.N, p)
        self.M_pad = self.blockAwidth * p
        self.N_pad = self.blockBwidth * p
        variant = getattr(self.kernel, "variant", None)
        self.S_tiles = build_tiles(
            S, ShardedBlockRow(self.M_pad, self.N_pad, p, c),
            tile_rows=self.blockAwidth, tile_cols=self.N_pad, device=self.device,
            variant=variant, devs=self.blocks)
        self.ST_tiles = build_tiles(
            S.transpose(), ShardedBlockRow(self.N_pad, self.M_pad, p, c),
            tile_rows=self.blockBwidth, tile_cols=self.M_pad, device=self.device,
            variant=variant, devs=self.blocks)

    def set_r_value(self, R: int) -> None:
        if R % self.nr != 0:
            raise ValueError(f"(p/c) | R required (R={R}, p/c={self.nr})")
        self.R = R

    # ---------------------------- dense layout ----------------------------- #

    def _n_slices(self) -> int:
        return self.nr

    def _dense_map(self, mode: MatMode, width: int) -> tuple:
        """Rank ``d = i * c + j``: rows ``(s * c + j) * bw + r`` for every
        stripe ``s``, columns of R-slice ``i``."""
        bw = self.blockAwidth if mode == MatMode.A else self.blockBwidth
        nr, c, w = self.nr, self.c, width // self.nr
        i, j = np.divmod(np.arange(self.p, dtype=np.int64), c)
        s = np.arange(nr, dtype=np.int64)[None, :, None]
        r = np.arange(bw, dtype=np.int64)[None, None, :]
        rows = ((s * c + j[:, None, None]) * bw + r).reshape(self.p, nr * bw)
        return rows, i * w

    # ------------------------------ ring pieces ---------------------------- #
    # Lists hold one entry per rank this process holds; entry h is tile
    # slot h and dense block ``self.blocks[h]``.

    def _sides(self, use_st: bool) -> tuple:
        """``(tiles, striped operand's mode, gathered operand's mode)``."""
        return ((self.ST_tiles, MatMode.B, MatMode.A) if use_st
                else (self.S_tiles, MatMode.A, MatMode.B))

    def _stripe(self, h: int, s: int) -> int:
        """The output stripe of the tile rank ``h`` holds at step ``s``."""
        return (self.comm.coords[h][0] - s) % self.nr

    def _src(self, h: int, s: int) -> int:
        """The grid device whose tile rank ``h`` holds at step ``s``."""
        i, j, _ = self.comm.coords[h]
        if ablation() != "full":
            return self.blocks[h]
        return ((i - s) % self.nr) * self.c + j

    def _replicate(self, X, mode: MatMode) -> list:
        """Each rank's stationary operand in the kernel's type: the ``c``
        blocks of its grid row gathered over ``cols`` and put in global
        row order, all ``n_pad`` rows of its R-slice."""
        blocks = self._blocks(X, mode)
        if self.c == 1:
            return self._prep_each(blocks)
        bw = self.blockAwidth if mode == MatMode.A else self.blockBwidth
        done: dict = {}
        out = []
        for g in abl_all_gather(self.comm, blocks, COLS, self.c):
            if id(g) not in done:
                w = g.shape[-1]
                done[id(g)] = self._prep(
                    g.view(self.c, self.nr, bw, w).transpose(0, 1).reshape(-1, w))
            out.append(done[id(g)])
        return out

    def _ring(self, body, carry, mov: tuple, final_shift: bool, carry_hop=None):
        """``carry = body(s, carry, mov)`` over the ``rows`` ring, ``mov``
        (a tuple of per-rank lists) hopping between steps, ``carry_hop``
        hopping the carry with it; with ``final_shift`` both hop after the
        last step too. Returns the carry."""
        shifters = [Shifter(self.comm, ROWS, self.nr) for _ in mov]

        def start(m):
            waits = [sh.start(x) for sh, x in zip(shifters, m)]
            return lambda: tuple(w() for w in waits)

        if self.overlap:
            return ring_loop_overlap(self.nr, body, carry, mov, start,
                                     final_shift=final_shift, shift_carry=carry_hop)[0]

        def step(s, state):
            c_, m = state
            return body(s, c_, m), m

        def hop(state):
            c_, m = state
            return (c_ if carry_hop is None else carry_hop(c_)), start(m)()

        return ring_loop(self.nr, step, (carry, mov), hop, hop if final_shift else None)[0]

    # ------------------------------ programs ------------------------------- #

    def _sddmm(self, use_st: bool, striped, gathered, vals):
        """Partial R-slice dots accumulate on the traveling tile; a whole
        ring trip brings them home summed, then they scale the values."""
        tiles, sm, gm = self._sides(use_st)
        bts = self._replicate(gathered, gm)
        ats = self._prep_each(self._blocks(striped, sm))
        bw = tiles.tile_rows
        held = range(len(self.blocks))
        masks = [tiles.mask[h, 0] for h in held]
        accs = [torch.zeros_like(m) for m in masks]

        def body(s, accs, mov):
            states, mks = mov
            out = []
            for h in held:
                st = self._stripe(h, s)
                view = self._tile_view(tiles, states[h], self._src(h, s))
                out.append(accs[h] + self._k_sddmm(view, mks[h], ats[h][st * bw:(st + 1) * bw],
                                                   bts[h]))
            return out

        acc_shift = Shifter(self.comm, ROWS, self.nr)
        accs = self._ring(body, accs, (self._tile_states(tiles), masks), True, acc_shift)
        return torch.stack([vals[h, 0] * accs[h] for h in held])[:, None]

    def _spmm(self, use_st: bool, gathered, vals):
        """The tile and its values rotate; each step writes the output
        stripe of the tile held."""
        tiles, _, gm = self._sides(use_st)
        bts = self._replicate(gathered, gm)
        held = range(len(self.blocks))
        stripes = [[None] * self.nr for _ in held]

        def body(s, carry, mov):
            states, vs = mov
            for h in held:
                view = self._tile_view(tiles, states[h], self._src(h, s))
                stripes[h][self._stripe(h, s)] = self._k_spmm(view, vs[h], bts[h])
            return carry

        self._ring(body, None, (self._tile_states(tiles), [vals[h, 0] for h in held]), False)
        return torch.cat([x for blk in stripes for x in blk]).to(self.dtype)

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
