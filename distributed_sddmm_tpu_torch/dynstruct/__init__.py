"""Dynamic sparse structure (counterpart of ``dynstruct/``).

A strategy's tile sets are exact functions of S's pattern: slot
capacities, band tables and dense frames. So fold-in growth
(``HostCOO.append_rows``), edge churn or a new mask would need a new
strategy. This package makes structure data bound at run time:

* :func:`build` constructs a named strategy under a
  ``utils.buckets.dyn_capacity`` scope: every structure-sizing decision
  (a tile set's slots, each band's rows, segments and units) pads up to a
  pow2 capacity rung, and the declared row count reserves a growth rung;
* :func:`rebind` rebuilds the tile sets of a mutated pattern on the host
  and, when they land in the same rungs, copies them into the existing
  strategy's device tensors; a pattern that outgrows its rungs spills to
  a replacement built at the next rungs, through the program store when
  the strategy is bound to one.

Results equal a fresh build's bit for bit: pads are never walked.
"""

from distributed_sddmm_tpu_torch.dynstruct.capacity import (  # noqa: F401
    default_grow_rows,
    default_headroom,
    row_capacity,
    with_row_capacity,
)
from distributed_sddmm_tpu_torch.dynstruct.rebind import (  # noqa: F401
    DynHandle,
    StructureUpdate,
    build,
    note_rebind,
    rebind,
)
from distributed_sddmm_tpu_torch.utils.buckets import (  # noqa: F401
    dyn_capacity,
    dyn_capacity_state,
    pow2_at_least,
)
