"""Capacity policy of dynamic-structure builds: the row rung and the
knobs (counterpart of ``dynstruct/capacity.py``).

The nnz-side capacities (a tile set's slots, each band's tables) are
taken inside the tile builders through the ``utils.buckets.dyn_capacity``
scope; this module owns the row side. The declared matrix height is a
capacity too, since every dense frame (``M_pad``, the ranks' row blocks)
derives from it: a dynamic-structure build wraps S in a ``HostCOO`` whose
``M`` is the row rung, and the real row count travels in the
``DynHandle``.
"""

from __future__ import annotations

import os

from distributed_sddmm_tpu_torch.utils.buckets import pow2_at_least
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

HEADROOM_ENV = "SDDMM_TORCH_DYNSTRUCT_HEADROOM"
ROWS_ENV = "SDDMM_TORCH_DYNSTRUCT_ROWS"


def default_headroom() -> float:
    """The capacity headroom (``SDDMM_TORCH_DYNSTRUCT_HEADROOM``, default
    1.0): each raw structure requirement is multiplied by it before its
    rung is chosen. 1.0 leaves the pow2 rounding alone as churn slack."""
    return float(os.environ.get(HEADROOM_ENV, "1.0"))


def default_grow_rows() -> bool:
    """Whether builds reserve a row-growth rung (``SDDMM_TORCH_DYNSTRUCT_
    ROWS``, default on): the declared height becomes ``pow2_at_least(M +
    1)``, so appended rows rebind instead of spilling. Off keeps the exact
    M, right for a matrix that only churns edges."""
    return os.environ.get(ROWS_ENV, "1") != "0"


def row_capacity(m: int, grow: bool = True) -> int:
    """The declared-height rung of a matrix with ``m`` real rows:
    ``grow=True`` leaves strict room above ``m`` (a power of two jumps a
    rung, or the commonest heights would spill on their first appended
    row); ``grow=False`` keeps ``m``."""
    return pow2_at_least(int(m) + 1) if grow else int(m)


def with_row_capacity(S: HostCOO, row_cap: int) -> HostCOO:
    """``S`` declared at height ``row_cap`` (the same arrays): the rows past
    ``S.M`` are empty, which every tile builder handles."""
    if row_cap < S.M:
        raise ValueError(f"row capacity {row_cap} below the matrix height {S.M}")
    return HostCOO(S.rows, S.cols, S.vals, int(row_cap), S.N)
