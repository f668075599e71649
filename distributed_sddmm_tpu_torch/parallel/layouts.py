"""Nonzero distributions of the four strategies (counterpart of
``parallel/layouts.py``): ``ShardedBlockCyclicColumn`` (1.5D dense shift),
``ShardedBlockRow`` (1.5D sparse shift), ``BlockCyclic25D`` (2.5D Cannon,
dense-replicating, with the Cannon skew baked in) and ``Floor2D`` (2.5D
Cannon, sparse-replicating).

A layout maps every nonzero ``(r, c)`` to a grid coordinate ``(i, j, k)``,
a tile id (the ring step that visits it) and tile-local coordinates. All
outputs are int64 numpy arrays, vectorized over the nonzeros. ``grid`` is
the ``(rows, cols, layers)`` extent the coordinates range over (``Floor2D``
spans the grid floor, ``layers`` 1: the fiber replication happens at
placement, ``parallel/sharding.py::build_replicated_tiles``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from distributed_sddmm_tpu_torch.common import divide_round_up


@dataclasses.dataclass(frozen=True)
class LayoutResult:
    i: np.ndarray
    j: np.ndarray
    k: np.ndarray
    tile: np.ndarray
    local_r: np.ndarray
    local_c: np.ndarray


class ShardedBlockCyclicColumn:
    """Grid ``(p/c) x c``. Device ``(i, j)`` owns row block ``i`` of height
    ``rows_per_proc * c`` and every column block with
    ``col_block % c == j``. Tiles are stored in step order: slot ``s``
    holds the block-column the ring visits at step ``s``
    (``col_block = ((i - s) mod p/c) * c + j``)."""

    def __init__(self, M: int, N: int, p: int, c: int):
        self.p, self.c = p, c
        self.rows_per_proc = divide_round_up(M, p)
        self.cols_per_proc = divide_round_up(N, p)
        self.n_tiles = p // c
        self.grid = (p // c, c, 1)

    def __call__(self, rows: np.ndarray, cols: np.ndarray) -> LayoutResult:
        nr = self.p // self.c
        row_block = rows // (self.rows_per_proc * self.c)
        col_block = cols // self.cols_per_proc
        t = col_block // self.c
        return LayoutResult(
            i=row_block,
            j=col_block % self.c,
            k=np.zeros_like(row_block),
            tile=np.mod(row_block - t, nr),
            local_r=rows % (self.rows_per_proc * self.c),
            local_c=cols % self.cols_per_proc,
        )


class ShardedBlockRow:
    """Grid ``(p/c) x c``. Block row ``b`` (height ``rows_per_proc``, the
    whole width) lives on ``(b // c, b % c)``, one tile a device whose
    column indices stay global: the stationary operand is gathered whole
    along the shift axis, so a tile addresses it directly wherever the
    ring takes it."""

    def __init__(self, M: int, N: int, p: int, c: int):
        self.p, self.c = p, c
        self.rows_per_proc = divide_round_up(M, p)
        self.n_tiles = 1
        self.grid = (p // c, c, 1)

    def __call__(self, rows: np.ndarray, cols: np.ndarray) -> LayoutResult:
        row_block = rows // self.rows_per_proc
        return LayoutResult(
            i=row_block // self.c,
            j=row_block % self.c,
            k=np.zeros_like(rows),
            tile=np.zeros_like(rows),
            local_r=rows % self.rows_per_proc,
            local_c=cols.copy(),
        )


class BlockCyclic25D:
    """Grid ``sqrtpc x sqrtpc x c``. The matrix is cut into ``sqrtpc`` row
    blocks (height ``rows_in_block``, ``c`` dense blocks) and
    ``sqrtpc * c`` column blocks. Unskewed, the tile of row block ``i`` and
    column block ``q * c + k`` belongs to ``(i, q, k)``; with ``skew`` it
    sits at column ``q - i``, Cannon's initial skew, so ingest places it
    where the first step needs it and no set-up hop is made."""

    def __init__(self, M: int, N: int, sqrtpc: int, c: int, skew: bool = True):
        self.sqrtpc, self.c, self.skew = sqrtpc, c, skew
        self.rows_in_block = divide_round_up(M, sqrtpc * c) * c
        self.cols_in_block = divide_round_up(N, sqrtpc * c)
        self.n_tiles = 1
        self.grid = (sqrtpc, sqrtpc, c)

    def __call__(self, rows: np.ndarray, cols: np.ndarray) -> LayoutResult:
        rb = rows // self.rows_in_block
        cb = cols // self.cols_in_block
        q = cb // self.c
        return LayoutResult(
            i=rb,
            j=np.mod(q - rb, self.sqrtpc) if self.skew else q,
            k=cb % self.c,
            tile=np.zeros_like(rows),
            local_r=rows % self.rows_in_block,
            local_c=cols % self.cols_in_block,
        )


class Floor2D:
    """A plain ``sqrtpc x sqrtpc`` blocking of the grid floor; the
    sparse-replicating Cannon strategy replicates each tile up its
    ``layers`` fiber."""

    def __init__(self, M: int, N: int, sqrtpc: int):
        self.rows_in_block = divide_round_up(M, sqrtpc)
        self.cols_in_block = divide_round_up(N, sqrtpc)
        self.n_tiles = 1
        self.grid = (sqrtpc, sqrtpc, 1)

    def __call__(self, rows: np.ndarray, cols: np.ndarray) -> LayoutResult:
        return LayoutResult(
            i=rows // self.rows_in_block,
            j=cols // self.cols_in_block,
            k=np.zeros_like(rows),
            tile=np.zeros_like(rows),
            local_r=rows % self.rows_in_block,
            local_c=cols % self.cols_in_block,
        )
