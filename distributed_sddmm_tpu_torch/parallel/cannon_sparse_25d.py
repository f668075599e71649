"""2.5D Cannon's algorithm, sparse-replicating variant (counterpart of
``parallel/cannon_sparse_25d.py``).

Grid ``sqrt(p/c) x sqrt(p/c) x c``. The sparse matrix is blocked on the
grid floor (``Floor2D``) and replicated up the ``layers`` fiber; each layer
owns a contiguous ``1/c`` slice of every tile's values
(``ReplicatedTiles``). Dense operands are R-split ``sqrt(p/c) * c`` ways,
Cannon-skewed in R: rank ``(i, j, k)`` holds row block ``i`` and R-slice
``((i + j) mod sqrt(p/c)) * c + k``. The skew lives in the host converters
and the fills (``_dense_map``), so it costs no communication.

``initial_shift`` / ``de_shift`` move the moving operand to the transposed
grid position, a self-inverse permutation over ``(rows, cols)``. In the
main loop the sparse stays put and both dense operands rotate, the A-role
along ``cols`` and the B-role along ``rows``. SpMM all-gathers the values
up the fiber first, and its rotating A-role output accumulates complete
results and completes its ring trip home. SDDMM accumulates dots over the
rank's R-slices, and a fiber reduce-scatter sums the ``c`` layers into each
layer's owned value slice. The tiles are not bankable (as in the JAX
package): a banked kernel runs its generic walk here. Wire roles
(``parallel/wire.py``): the rotating inputs are ``ring``, the rotating
SpMM output ``ring_accum``, the fiber value gather ``gather`` and the
fiber reduce-scatter of the dots ``reduce``; the transpose shifts stay
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode, divide_round_up
from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import square_side
from distributed_sddmm_tpu_torch.parallel.comm import world_from_env
from distributed_sddmm_tpu_torch.parallel.layouts import Floor2D
from distributed_sddmm_tpu_torch.parallel.loops import (
    Shifter, abl_all_gather, abl_psum_scatter, ring_loop,
)
from distributed_sddmm_tpu_torch.parallel.mesh import COLS, LAYERS, ROWS, make_grid
from distributed_sddmm_tpu_torch.parallel.sharding import build_replicated_tiles
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

_A_MODES = (KernelMode.SDDMM_A, KernelMode.SPMM_A)


class CannonSparse25D(DistributedSparse):
    algorithm_name = "2.5D Cannon's Algorithm Replicating Sparse Matrix"
    cost_model_name = "25d_sparse"
    proc_grid_names = ("# Rows", "# Cols", "# Layers")
    r_split = True
    r_split_axis = (COLS, LAYERS)
    #: Replicated tiles are never banked (``build_replicated_tiles``).
    bankable = False

    def __init__(self, S: HostCOO, R: int, c: int = 1, kernel=None, adjacency: int = 3,
                 world=None, device=None, wire=None):
        device = resolve_device(device)
        world = world_from_env(device) if world is None else world
        p = world.p
        n = square_side(p, c, "")
        if R % (n * c) != 0:
            raise ValueError(
                f"2.5D sparse-replicating requires sqrt(p/c)*c | R "
                f"(R={R}, sqrt(p/c)*c={n * c}; reference check at "
                "25D_cannon_sparse.hpp:142-145)"
            )
        super().__init__(S.M, S.N, R, c, world, make_grid(n, n, c, adjacency=adjacency),
                         kernel=kernel, device=device, wire=wire)
        self.sqrtpc = n
        self.localArows = divide_round_up(S.M, n)
        self.localBrows = divide_round_up(S.N, n)
        self.M_pad = self.localArows * n
        self.N_pad = self.localBrows * n
        variant = getattr(self.kernel, "variant", None)
        self.S_tiles = build_replicated_tiles(
            S, Floor2D(self.M_pad, self.N_pad, n), c, tile_rows=self.localArows,
            tile_cols=self.localBrows, device=self.device, variant=variant,
            devs=self.blocks)
        self.ST_tiles = build_replicated_tiles(
            S.transpose(), Floor2D(self.N_pad, self.M_pad, n), c,
            tile_rows=self.localBrows, tile_cols=self.localArows, device=self.device,
            variant=variant, devs=self.blocks)
        self._note_tile_metrics()

    def set_r_value(self, R: int) -> None:
        if R % (self.sqrtpc * self.c) != 0:
            raise ValueError(f"sqrt(p/c)*c | R required (R={R})")
        self.R = R

    # ------------------------- skewed dense layout ------------------------- #

    def _n_slices(self) -> int:
        return self.sqrtpc * self.c

    def _dense_map(self, mode: MatMode, width: int) -> tuple:
        """Rank ``d = (i * n + j) * c + k``: the rows of row block ``i``,
        the columns of R-slice ``((i + j) mod n) * c + k``."""
        lx = self.localArows if mode == MatMode.A else self.localBrows
        n, c = self.sqrtpc, self.c
        la = width // (n * c)
        ij, k = np.divmod(np.arange(self.p, dtype=np.int64), c)
        i, j = np.divmod(ij, n)
        rows = i[:, None] * lx + np.arange(lx, dtype=np.int64)[None, :]
        return rows, (((i + j) % n) * c + k) * la

    # ------------------- transpose shift (self-inverse) -------------------- #

    def _transpose(self, X, mode: MatMode):
        n = self.sqrtpc
        if X is None or n == 1:
            return X
        perm = [(i * n + j, j * n + i) for i in range(n) for j in range(n)]
        return self._assemble(self.comm.ppermute(self._blocks(X, mode), (ROWS, COLS), perm))

    def initial_shift(self, A, B, mode: KernelMode):
        """Move the moving operand (B for the A-modes, A for the B-modes)
        to the transposed grid position."""
        if mode in _A_MODES:
            return A, self._transpose(B, MatMode.B)
        return self._transpose(A, MatMode.A), B

    def de_shift(self, A, B, mode: KernelMode):
        return self.initial_shift(A, B, mode)

    # ------------------------------ programs ------------------------------- #

    def _sides(self, use_st: bool) -> tuple:
        """``(tiles, A-role mode, B-role mode)``."""
        return ((self.ST_tiles, MatMode.B, MatMode.A) if use_st
                else (self.S_tiles, MatMode.A, MatMode.B))

    def _sddmm(self, use_st: bool, a_role, b_role, vals):
        """Dots over the rank's R-slices as both operands rotate, then the
        fiber reduce-scatter into the owned value slices."""
        tiles, am, bm = self._sides(use_st)
        held = range(len(self.blocks))
        views = [tiles.tile(h) for h in held]
        masks = [tiles.mask[tiles.floor_slot[h]] for h in held]
        init = ([torch.zeros_like(m) for m in masks], self._prep_each(self._blocks(a_role, am)),
                self._prep_each(self._blocks(b_role, bm)))
        sh_a = Shifter(self.comm, COLS, self.sqrtpc, self.wire.dtype_for("ring"))
        sh_b = Shifter(self.comm, ROWS, self.sqrtpc, self.wire.dtype_for("ring"))

        def body(s, state):
            accs, a, b = state
            return [accs[h] + self._k_sddmm(views[h], masks[h], a[h], b[h])
                    for h in held], a, b

        def hop(state):
            accs, a, b = state
            return accs, sh_a(a), sh_b(b)

        accs = ring_loop(self.sqrtpc, body, init, hop)[0]
        if self.c > 1:
            accs = abl_psum_scatter(self.comm, accs, LAYERS, self.c,
                                    self.wire.dtype_for("reduce"))
        return torch.stack([vals[h] * accs[h] for h in held])

    def _spmm(self, use_st: bool, a_role, b_role, vals):
        """The values gathered up the fiber; the A-role output accumulates
        as it rotates, then completes its trip home."""
        tiles, am, bm = self._sides(use_st)
        held = range(len(self.blocks))
        views = [tiles.tile(h) for h in held]
        vs = [vals[h] for h in held]
        if self.c > 1:
            vs = abl_all_gather(self.comm, vs, LAYERS, self.c,
                                self.wire.dtype_for("gather"))
        init = (self._blocks(a_role, am), self._prep_each(self._blocks(b_role, bm)))
        sh_a = Shifter(self.comm, COLS, self.sqrtpc, self.wire.dtype_for("ring_accum"))
        sh_b = Shifter(self.comm, ROWS, self.sqrtpc, self.wire.dtype_for("ring"))

        def body(s, state):
            a, b = state
            return [a[h] + self._k_spmm(views[h], vs[h], b[h]) for h in held], b

        def hop(state):
            a, b = state
            return sh_a(a), sh_b(b)

        def home(state):
            a, b = state
            return sh_a(a), b

        return self._assemble(ring_loop(self.sqrtpc, body, init, hop, home)[0])

    # ----------- public ops (moving operand transpose-shifted) ------------- #

    def sddmm_a(self, A, B, s_vals):
        return self._timed("sddmmA", self._sddmm, False, A, B, s_vals)

    def sddmm_b(self, A, B, st_vals):
        return self._timed("sddmmB", self._sddmm, True, B, A, st_vals)

    def spmm_a(self, A, B, s_vals):
        """``A + S @ B``: A is the rotating output."""
        return self._timed("spmmA", self._spmm, False, A, B, s_vals)

    def spmm_b(self, A, B, st_vals):
        return self._timed("spmmB", self._spmm, True, B, A, st_vals)

    def fused_spmm(self, A, B, s_vals, mode: MatMode = MatMode.A):
        if mode == MatMode.A:
            mid = self.sddmm_a(A, B, s_vals)
            return self.spmm_a(self.like_a_matrix(0.0), B, mid), mid
        mid = self.sddmm_b(A, B, s_vals)
        return self.spmm_b(A, self.like_b_matrix(0.0), mid), mid
