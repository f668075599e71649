"""Nonzero distribution of the 1.5D dense-shift strategy (counterpart of
``parallel/layouts.py``, of which only ``ShardedBlockCyclicColumn`` is
ported so far).

A layout maps every nonzero ``(r, c)`` to a grid coordinate ``(i, j)``, a
tile id (the ring step that visits it) and tile-local coordinates. All
outputs are int64 numpy arrays, vectorized over the nonzeros.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from distributed_sddmm_tpu_torch.common import divide_round_up


@dataclasses.dataclass(frozen=True)
class LayoutResult:
    i: np.ndarray
    j: np.ndarray
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
        self.grid = (p // c, c)

    def __call__(self, rows: np.ndarray, cols: np.ndarray) -> LayoutResult:
        nr = self.p // self.c
        row_block = rows // (self.rows_per_proc * self.c)
        col_block = cols // self.cols_per_proc
        t = col_block // self.c
        return LayoutResult(
            i=row_block,
            j=col_block % self.c,
            tile=np.mod(row_block - t, nr),
            local_r=rows % (self.rows_per_proc * self.c),
            local_c=cols % self.cols_per_proc,
        )
