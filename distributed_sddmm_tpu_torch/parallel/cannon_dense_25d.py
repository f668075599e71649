"""2.5D Cannon's algorithm, dense-replicating variant (counterpart of
``parallel/cannon_dense_25d.py``).

Grid ``sqrt(p/c) x sqrt(p/c) x c`` (adjacency 3 by default). Sparse tiles
live at their Cannon-skewed home from ingest (``BlockCyclic25D``). Dense
operands are R-split over ``cols`` and row-distributed over ``(rows,
layers)``: rank ``(i, j, k)`` holds R-slice ``j`` of row block
``i * c + k`` (the JAX package's ``P(("rows", "layers"), "cols")``). The
stationary operand is all-gathered over the ``layers`` fiber; at every
step the moving operand hops along ``rows`` and the tile with its values
along ``cols``. SDDMM partial dots (this rank's R-slice) travel with the
tile and sum to the full dot over a ring trip; SpMM accumulates into the
moving operand, which is its output (no reduction: the outputs are
R-split), and completes its ring trip home.

``initial_shift`` / ``de_shift`` skew and unskew the moving operand, a
permutation over ``(rows, cols)`` (rank ``(i, j)`` then holds the block of
``(i + j, j)``); the ops expect it pre-skewed, as the reference's API
does. ``fused_spmm`` chains the SDDMM and an SpMM into a zero output, as
the JAX package's: the dots are complete only after a ring trip.

Transposed-values quirk, kept from the reference: the A-ops run over the
S^T tiles, so ``sddmm_a`` / ``spmm_a`` take and return values in S^T's
tile layout, and ``like_s_values`` / ``scatter_s_values`` /
``gather_s_values`` address S^T's tiles (the B-ops and the ``*_st_*``
helpers S's). SpMM writes the tile's column dimension, so the tiles are
built with ``swap=True``: the kernel's rows are the layout's columns, and
the SDDMM is the same dot with its operands in the other order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode, divide_round_up
from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.parallel.comm import world_from_env
from distributed_sddmm_tpu_torch.parallel.layouts import BlockCyclic25D
from distributed_sddmm_tpu_torch.parallel.loops import (
    Shifter, abl_all_gather, ablation, ring_loop,
)
from distributed_sddmm_tpu_torch.parallel.mesh import COLS, LAYERS, ROWS, make_grid
from distributed_sddmm_tpu_torch.parallel.sharding import build_tiles
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

_A_MODES = (KernelMode.SDDMM_A, KernelMode.SPMM_A)


def square_side(p: int, c: int, where: str) -> int:
    """``sqrt(p/c)``; the JAX package's ValueError when ``p/c`` is not a
    perfect square."""
    sqrtpc = int(math.isqrt(p // c))
    if sqrtpc * sqrtpc * c != p:
        raise ValueError(f"2.5D algorithm requires p/c to be a perfect square "
                         f"(p={p}, c={c}{where})")
    return sqrtpc


class CannonDense25D(DistributedSparse):
    algorithm_name = "2.5D Cannon's Algorithm Replicating Dense Matrices"
    cost_model_name = "25d_dense"
    proc_grid_names = ("# Rows", "# Cols", "# Layers")
    r_split = True
    r_split_axis = COLS

    def __init__(self, S: HostCOO, R: int, c: int = 1, kernel=None, adjacency: int = 3,
                 world=None, device=None):
        device = resolve_device(device)
        world = world_from_env(device) if world is None else world
        p = world.p
        n = square_side(p, c, "; reference check at 25D_cannon_dense.hpp:59-67")
        if R % n != 0:
            raise ValueError(
                f"2.5D dense-replicating requires sqrt(p/c) | R "
                f"(R={R}, sqrt(p/c)={n})"
            )
        super().__init__(S.M, S.N, R, c, world, make_grid(n, n, c, adjacency=adjacency),
                         kernel=kernel, device=device)
        self.sqrtpc = n
        self.localArows = divide_round_up(S.M, n * c)
        self.localBrows = divide_round_up(S.N, n * c)
        self.M_pad = self.localArows * n * c
        self.N_pad = self.localBrows * n * c
        variant = getattr(self.kernel, "variant", None)
        self.S_tiles = build_tiles(
            S, BlockCyclic25D(self.M_pad, self.N_pad, n, c),
            tile_rows=self.localArows * c, tile_cols=self.localBrows, device=self.device,
            variant=variant, devs=self.blocks, swap=True)
        self.ST_tiles = build_tiles(
            S.transpose(), BlockCyclic25D(self.N_pad, self.M_pad, n, c),
            tile_rows=self.localBrows * c, tile_cols=self.localArows, device=self.device,
            variant=variant, devs=self.blocks, swap=True)

    def set_r_value(self, R: int) -> None:
        if R % self.sqrtpc != 0:
            raise ValueError(f"sqrt(p/c) | R required (R={R}, sqrt={self.sqrtpc})")
        self.R = R

    # ---------------------------- dense layout ----------------------------- #

    def _n_slices(self) -> int:
        return self.sqrtpc

    def _dense_map(self, mode: MatMode, width: int) -> tuple:
        """Rank ``d = (i * n + j) * c + k``: the rows of row block
        ``i * c + k``, the columns of R-slice ``j``."""
        lx = self.localArows if mode == MatMode.A else self.localBrows
        n, c, w = self.sqrtpc, self.c, width // self.sqrtpc
        ij, k = np.divmod(np.arange(self.p, dtype=np.int64), c)
        i, j = np.divmod(ij, n)
        rows = (i * c + k)[:, None] * lx + np.arange(lx, dtype=np.int64)[None, :]
        return rows, j * w

    # -- transposed-values quirk (see the module docstring) ----------------- #

    def like_s_values(self, value: float):
        return self.ST_tiles.like_values(value)

    def like_st_values(self, value: float):
        return self.S_tiles.like_values(value)

    def scatter_s_values(self, host_vals):
        """Values for the A-ops, in the host order of S.transpose()'s
        nonzeros."""
        return self.ST_tiles.scatter_values(host_vals)

    def gather_s_values(self, dev_vals):
        return self.ST_tiles.gather_values(self._all_blocks(dev_vals.detach()))

    def scatter_st_values(self, host_vals):
        """Values for the B-ops, in the host order of S's nonzeros."""
        return self.S_tiles.scatter_values(host_vals)

    def gather_st_values(self, dev_vals):
        return self.S_tiles.gather_values(self._all_blocks(dev_vals.detach()))

    # ------------------------ Cannon skew (moving) ------------------------- #

    def _skew(self, X, mode: MatMode, sign: int):
        """``sign = +1``: rank ``(i, j)``'s block moves to ``(i - j, j)``,
        Cannon's initial skew; ``-1`` undoes it."""
        n = self.sqrtpc
        if X is None or n == 1:
            return X
        perm = [(i * n + j, ((i - sign * j) % n) * n + j) for i in range(n) for j in range(n)]
        return self._assemble(self.comm.ppermute(self._blocks(X, mode), (ROWS, COLS), perm))

    def initial_shift(self, A, B, mode: KernelMode):
        """Pre-skew the moving operand (A for the A-modes, B for the
        B-modes)."""
        if mode in _A_MODES:
            return self._skew(A, MatMode.A, +1), B
        return A, self._skew(B, MatMode.B, +1)

    def de_shift(self, A, B, mode: KernelMode):
        if mode in _A_MODES:
            return self._skew(A, MatMode.A, -1), B
        return A, self._skew(B, MatMode.B, -1)

    # ------------------------------ ring pieces ---------------------------- #

    def _sides(self, use_st: bool) -> tuple:
        """``(tiles, stationary operand's mode, moving operand's mode)``."""
        return ((self.ST_tiles, MatMode.B, MatMode.A) if use_st
                else (self.S_tiles, MatMode.A, MatMode.B))

    def _src(self, h: int, s: int) -> int:
        """The grid device whose tile rank ``h`` holds at step ``s``."""
        i, j, k = self.comm.coords[h]
        if ablation() != "full":
            return self.blocks[h]
        return (i * self.sqrtpc + (j - s) % self.sqrtpc) * self.c + k

    def _replicate(self, X, mode: MatMode) -> list:
        """The stationary operand over the ``layers`` fiber: ``(c * rows,
        slice)``, k-major like the tile's frame, in the kernel's type."""
        blocks = self._blocks(X, mode)
        if self.c > 1:
            blocks = abl_all_gather(self.comm, blocks, LAYERS, self.c)
        return self._prep_each(blocks)

    def _shifters(self, *axes) -> list:
        return [Shifter(self.comm, axis, self.sqrtpc) for axis in axes]

    # ------------------------------ programs ------------------------------- #

    def _sddmm(self, use_st: bool, stat, mov, vals):
        """Partial dots travel with the tile round ``cols`` while the moving
        operand rotates round ``rows``; the dots complete their trip home."""
        tiles, sm, mm = self._sides(use_st)
        reps = self._replicate(stat, sm)
        held = range(len(self.blocks))
        masks = [tiles.mask[h, 0] for h in held]
        init = (self._tile_states(tiles), masks, [torch.zeros_like(m) for m in masks],
                self._prep_each(self._blocks(mov, mm)))
        sh_t, sh_m, sh_a, sh_d = self._shifters(COLS, COLS, COLS, ROWS)

        def body(s, state):
            sts, mks, accs, movs = state
            accs = [accs[h] + self._k_sddmm(self._tile_view(tiles, sts[h], self._src(h, s)),
                                            mks[h], movs[h], reps[h]) for h in held]
            return sts, mks, accs, movs

        def hop(state):
            sts, mks, accs, movs = state
            return sh_t(sts), sh_m(mks), sh_a(accs), sh_d(movs)

        def home(state):
            sts, mks, accs, movs = state
            return sts, mks, sh_a(accs), movs

        accs = ring_loop(self.sqrtpc, body, init, hop, home)[2]
        return torch.stack([vals[h, 0] * accs[h] for h in held])[:, None]

    def _spmm(self, use_st: bool, stat, mov, vals):
        """``out[tile cols] += vals * stat[tile rows]``: the output is the
        moving operand, accumulating as it rotates, then home."""
        tiles, sm, mm = self._sides(use_st)
        reps = self._replicate(stat, sm)
        held = range(len(self.blocks))
        init = (self._tile_states(tiles), [vals[h, 0] for h in held],
                self._blocks(mov, mm))
        sh_t, sh_v, sh_d = self._shifters(COLS, COLS, ROWS)

        def body(s, state):
            sts, vs, outs = state
            outs = [outs[h] + self._k_spmm(self._tile_view(tiles, sts[h], self._src(h, s)),
                                           vs[h], reps[h]) for h in held]
            return sts, vs, outs

        def hop(state):
            sts, vs, outs = state
            return sh_t(sts), sh_v(vs), sh_d(outs)

        def home(state):
            sts, vs, outs = state
            return sts, vs, sh_d(outs)

        return self._assemble(ring_loop(self.sqrtpc, body, init, hop, home)[2])

    # --------------- public ops (moving operand pre-skewed) ---------------- #

    def sddmm_a(self, A, B, s_vals):
        return self._timed("sddmmA", self._sddmm, True, B, A, s_vals)

    def sddmm_b(self, A, B, st_vals):
        return self._timed("sddmmB", self._sddmm, False, A, B, st_vals)

    def spmm_a(self, A, B, s_vals):
        """``A + S @ B``: A is the rotating output (pre-skewed zeros, or a
        base to accumulate on)."""
        return self._timed("spmmA", self._spmm, True, B, A, s_vals)

    def spmm_b(self, A, B, st_vals):
        return self._timed("spmmB", self._spmm, False, A, B, st_vals)

    def fused_spmm(self, A, B, s_vals, mode: MatMode = MatMode.A):
        """SDDMM, then SpMM into a zero output, the moving operand skewed
        once for both."""
        if mode == MatMode.A:
            mid = self.sddmm_a(A, B, s_vals)
            return self.spmm_a(self.like_a_matrix(0.0), B, mid), mid
        mid = self.sddmm_b(A, B, s_vals)
        return self.spmm_b(A, self.like_b_matrix(0.0), mid), mid
