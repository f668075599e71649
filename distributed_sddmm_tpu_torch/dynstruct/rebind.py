"""The host-side rebind path: ``rebind(alg, S') -> StructureUpdate``
(counterpart of ``dynstruct/rebind.py``).

:func:`build` constructs a named strategy under a capacity scope and
stamps a :class:`DynHandle` (the recipe and the realized rungs) on it.
:func:`rebind` rebuilds the tile sets of a mutated pattern on the host
under the build's capacity floors and, when the new structure has the
same shapes (:func:`_mismatch`: the strategy class, every tile tensor's
shape, the band structure, the realized variant and the rungs), copies it
into the strategy's existing device tensors: no tile tensor is allocated
anew, and the strategy keeps its metrics, its handle and its store
binding. The next op runs the same kernels on the new pattern: the port's
form of "zero retraces", counted as ``dynstruct_rebinds``.

A pattern that outgrows a rung, or changes its band structure, spills:
the rebuild at the new rungs replaces the strategy, built through the
program store when a binder is attached, and the event counts a
``dynstruct_bucket_spills`` and a ``structure_retraces``.
"""

from __future__ import annotations

import dataclasses

from distributed_sddmm_tpu_torch.dynstruct.capacity import (
    default_grow_rows, default_headroom, row_capacity, with_row_capacity,
)
from distributed_sddmm_tpu_torch.parallel.sharding import copy_structure_, structure_sig
from distributed_sddmm_tpu_torch.utils.buckets import dyn_capacity
from distributed_sddmm_tpu_torch.utils.coo import HostCOO


@dataclasses.dataclass(frozen=True)
class DynHandle:
    """The recipe and realized capacities of a dynamic-structure strategy:
    what :func:`rebind` needs to rebuild it for a mutated pattern."""

    name: str
    R: int
    c: int
    kw: dict
    headroom: float
    grow_rows: bool
    row_cap: int
    true_m: int
    n: int
    floors: tuple  # realized capacity rungs, in build order


@dataclasses.dataclass(frozen=True)
class StructureUpdate:
    """The outcome of one :func:`rebind`. ``alg`` is the strategy passed in
    on a fit (rebound in place) and its replacement on a spill: a caller
    that holds the strategy re-points it when ``fit`` is False."""

    fit: bool
    alg: object
    nnz_before: int
    nnz_after: int
    row_cap: int
    caps: tuple
    reason: str | None = None

    @property
    def spilled(self) -> bool:
        return not self.fit


def note_rebind(fit: bool) -> None:
    """Count one structure change: a fit is a ``dynstruct_rebinds``; a
    spill a ``dynstruct_bucket_spills`` and a ``structure_retraces`` (the
    replacement's set-up is built anew). Shared with the callers that
    rebind on their own, so the counters mean one thing."""
    from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics

    if fit:
        obs_metrics.GLOBAL.add("dynstruct_rebinds")
    else:
        obs_metrics.GLOBAL.add("dynstruct_bucket_spills")
        obs_metrics.GLOBAL.add("structure_retraces")


def capacity_segment(row_cap: int, headroom: float, floors: tuple) -> str:
    """The program-store key segment of a capacity build: what fixes its
    rungs before it is built (the row rung, the headroom and the replayed
    floors)."""
    seg = f"r{int(row_cap)}h{float(headroom):g}"
    if floors:
        seg += "f" + "x".join(str(int(f)) for f in floors)
    return seg


def build(name: str, S: HostCOO, R: int, c: int, *, headroom: float | None = None,
          grow_rows: bool | None = None, **kw):
    """Construct strategy ``name`` sized to capacity rungs, rebindable.

    ``kw`` passes to ``bench.harness.make_algorithm`` (kernel, world,
    device, overlap, wire, ...). ``headroom`` multiplies every raw
    structure requirement before its rung is chosen (default
    ``SDDMM_TORCH_DYNSTRUCT_HEADROOM``); ``grow_rows`` reserves a row
    rung for the declared height (default ``SDDMM_TORCH_DYNSTRUCT_ROWS``).
    The strategy carries a :class:`DynHandle` on ``_dynstruct``, and its
    tile sets ``dyn_cap``."""
    from distributed_sddmm_tpu_torch.bench.harness import make_algorithm

    headroom = default_headroom() if headroom is None else float(headroom)
    grow_rows = default_grow_rows() if grow_rows is None else bool(grow_rows)
    row_cap = row_capacity(S.M, grow_rows)
    with dyn_capacity(headroom=headroom) as scope:
        alg = make_algorithm(name, with_row_capacity(S, row_cap), R, c, **kw)
    alg._dynstruct = DynHandle(
        name=name, R=int(R), c=int(c), kw=dict(kw), headroom=headroom,
        grow_rows=grow_rows, row_cap=row_cap, true_m=S.M, n=S.N,
        floors=tuple(scope.realized))
    return alg


def rebind(alg, S_new: HostCOO) -> StructureUpdate:
    """Bind a mutated pattern into a strategy :func:`build` made.

    Rebuilds the tile sets of ``S_new`` on the host under the build's
    capacity floors, then compares their structure with the live ones. A
    fit copies the new structure into the strategy's device tensors in
    place. No fit (a rung or the row capacity outgrown, or the band
    structure changed): the rebuild, at its new rungs, is returned as the
    replacement strategy with its own handle (through the program store
    when the strategy is bound to one)."""
    h: DynHandle | None = getattr(alg, "_dynstruct", None)
    if h is None:
        raise ValueError(
            "rebind needs a dynamic-structure strategy (dynstruct.build); "
            f"{type(alg).__name__} has no _dynstruct handle")
    if S_new.N != h.n:
        raise ValueError(
            f"rebind cannot change the column count ({h.n} -> {S_new.N}); "
            "column growth needs a fresh build")
    from distributed_sddmm_tpu_torch.bench.harness import make_algorithm

    row_spill = S_new.M > h.row_cap
    row_cap = row_capacity(S_new.M, h.grow_rows) if row_spill else h.row_cap
    # Floors replay only against unchanged frames: after a row spill every
    # tile frame moved and the ordinals describe nothing.
    floors = () if row_spill else h.floors
    S_decl = with_row_capacity(S_new, row_cap)
    nnz_before = int(getattr(alg.S_tiles, "nnz", 0))

    def fresh_build():
        return make_algorithm(h.name, S_decl, h.R, h.c, **h.kw)

    binder = getattr(alg, "_program_binder", None)
    with dyn_capacity(headroom=h.headroom, floors=floors) as scope:
        if row_spill and binder is not None:
            fresh = _through_store(binder, alg, h, fresh_build, S_decl, row_cap, floors)
        else:
            fresh = fresh_build()
    reason = f"row capacity {h.row_cap} < {S_new.M}" if row_spill else _mismatch(alg, fresh)
    fit = reason is None
    note_rebind(fit)
    caps = tuple(scope.realized)
    if fit:
        for name in alg.SETUP_TILE_SETS:
            copy_structure_(getattr(alg, name), getattr(fresh, name))
        alg._structure_changed()
        alg._dynstruct = dataclasses.replace(h, true_m=S_new.M, floors=caps)
        return StructureUpdate(fit=True, alg=alg, nnz_before=nnz_before,
                               nnz_after=S_new.nnz, row_cap=row_cap, caps=caps)
    if binder is not None and not row_spill:
        # Already built: the store saves it (or a stored copy stands in).
        built = fresh
        with dyn_capacity(headroom=h.headroom, floors=floors) as scope:
            fresh = _through_store(binder, alg, h, lambda: built, S_decl, row_cap, floors)
        # A stored copy replays its rungs; a save of the rebuild adds none.
        caps = tuple(scope.realized) or caps
    fresh._dynstruct = dataclasses.replace(h, row_cap=row_cap, true_m=S_new.M, floors=caps)
    return StructureUpdate(fit=False, alg=fresh, nnz_before=nnz_before,
                           nnz_after=S_new.nnz, row_cap=row_cap, caps=caps, reason=reason)


def _through_store(binder, alg, h: DynHandle, build_fn, S_decl, row_cap, floors):
    from distributed_sddmm_tpu_torch.programs.store import SetupConfig

    config = SetupConfig(type(alg), h.c, alg.kernel, alg.wire, overlap=alg.overlap)
    return binder(build_fn, config, S_decl,
                  capacity=capacity_segment(row_cap, h.headroom, floors))


def _mismatch(old, new) -> str | None:
    """None when ``new``'s structure fits ``old``'s tensors; else a
    one-line reason for the spill."""
    if type(old) is not type(new):
        return f"strategy class changed ({type(new).__name__})"
    for name in old.SETUP_TILE_SETS:
        if structure_sig(getattr(old, name)) != structure_sig(getattr(new, name)):
            return f"{name} structure signature changed"
    return None
