"""Shared power-of-two bucketing, one rounding rule for every subsystem
(counterpart of ``utils/buckets.py``).

The problem fingerprint's nnz/row bucket and the codegen variant's band
threshold both round through :func:`pow2_bucket`, so a variant id bands
rows exactly where the fingerprint buckets them, in both packages. The
dynamic-structure builds (``dynstruct/``) size their structure arrays to
:func:`pow2_at_least` rungs through the per-thread :func:`dyn_capacity`
scope.

Standard library only: ``autotune/fingerprint.py`` imports it.
"""

from __future__ import annotations

import contextlib
import math
import threading


def pow2_bucket(x: float) -> int:
    """``x`` rounded to the nearest power of two (>= 1), rounding at the
    geometric midpoint (6 -> 8, 5 -> 4, 1.4 -> 1)."""
    x = max(float(x), 1.0)
    b = 1
    while b * 2 <= x * (2 ** 0.5):
        b *= 2
    return b


def pow2_ladder(cap: int) -> tuple[int, ...]:
    """Ascending power-of-two rungs up to (and always including) ``cap``,
    which is the last rung even when it is not a power of two."""
    cap = int(cap)
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return tuple(out)


def bucket_for(n: int, ladder: tuple[int, ...]) -> int:
    """Smallest ladder rung >= ``n`` (the largest rung for a larger ``n``)."""
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= ``max(n, 1)``: the capacity rung rule. It
    never rounds down, so 5 -> 8."""
    n = max(int(n), 1)
    b = 1
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------- #
# The dynamic-structure capacity scope (``dynstruct/``)
# --------------------------------------------------------------------- #
#
# The tile builders (``parallel/sharding.build_tiles``,
# ``build_replicated_tiles``, ``codegen/banded.build_banded``) size their
# structure arrays exactly. Under an active scope each sizing decision is
# padded up to a power-of-two rung (times the builder's alignment), so
# every pattern whose requirements land in the same rungs gets tensors of
# the same shapes: a rebind then copies the new structure into the
# existing tensors. Decisions are consumed in build order, one ordinal a
# site; ``floors`` replays a previous build's rungs so a smaller pattern
# pads back up to them. A floor sequence that no longer lines up (the
# band structure changed) yields other capacities, and the rebind's fit
# check spills.

_DYN = threading.local()


class DynCapacityState:
    """Mutable per-thread state of one active capacity scope."""

    __slots__ = ("headroom", "floors", "seq", "realized")

    def __init__(self, headroom: float, floors: tuple[int, ...]):
        self.headroom = float(headroom)
        self.floors = tuple(int(f) for f in floors)
        self.seq = 0
        self.realized: list[int] = []


def dyn_capacity_state() -> DynCapacityState | None:
    """The active capacity scope of this thread, or None."""
    return getattr(_DYN, "state", None)


@contextlib.contextmanager
def dyn_capacity(headroom: float = 1.0, floors: tuple[int, ...] = ()):
    """Size tile and band structure to capacity rungs in this scope.

    ``headroom`` multiplies each raw requirement before the rung is
    chosen; ``floors`` replays the realized capacities of a previous
    build of the same strategy. Scopes do not nest: a build inside a
    build would desynchronise the ordinal replay."""
    if dyn_capacity_state() is not None:
        raise RuntimeError("dyn_capacity scopes do not nest")
    if headroom < 1.0:
        raise ValueError(f"dyn_capacity headroom must be >= 1.0, got {headroom}")
    st = DynCapacityState(headroom, floors)
    _DYN.state = st
    try:
        yield st
    finally:
        _DYN.state = None


def dyn_rung(raw: int, multiple: int = 1) -> int | None:
    """Consume one capacity decision of the active scope: the capacity to
    size for (``>= raw``, a pow2 rung rounded up to ``multiple``, never
    below this ordinal's floor), or None with no scope active (the
    builder keeps its exact size). A floor is reused as it is when the
    new requirement fits under it."""
    st = dyn_capacity_state()
    if st is None:
        return None
    floor = st.floors[st.seq] if st.seq < len(st.floors) else 0
    st.seq += 1
    raw = max(int(raw), 0)
    need = math.ceil(raw * st.headroom)
    cap = pow2_at_least(max(need, raw, 1))
    multiple = max(int(multiple), 1)
    cap = -(-cap // multiple) * multiple
    if floor and cap <= floor:
        cap = floor
    st.realized.append(cap)
    return cap
