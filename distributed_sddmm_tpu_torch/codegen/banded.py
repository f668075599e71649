"""Row bands of a tile for the banked CUDA launches (counterpart of
``codegen/banded.py``).

The JAX package builds one 128-lane chunk list per band. On the card a
band is a list of tile rows: the short and mid bands are walked one lane
group per row, like the generic kernel, and the heavy band's rows are cut
into segments of at most ``split`` slots, one lane group per segment,
whose partial results a second pass sums per row in segment order. A heavy
row then no longer serialises on one group while the rest of the card
idles. The second pass walks a unit table (:func:`reduce_units`): the
rows of at most ``chunk // 4`` segments a warp each, eight to a block, and
the longer rows cut into chunks of at most ``chunk`` segments, a block
each, whose partials the row's last block to finish combines in chunk
order; so no row's segments are summed on one serial chain either.

The bands index the tile's CSR (``parallel/sharding.py``: real nonzeros
in row order, pads at the tail, ``row_ptr``) and change nothing in it, so
the value layout, ``scatter_values``/``gather_values`` and every value
vector serve the generic and the banked kernel alike, as in the JAX
package (its ``banded.py`` module doc).

Row assignment follows the JAX builder exactly: a row goes to the first
band whose ``npr_max`` it does not exceed, the heavy band taking the
rest; when the largest populated row degree is at most twice the median
and rows were split across bands, every row collapses into the band with
the most nonzeros; bands left without a nonzero are dropped (a tile set
with no nonzero keeps the heavy band alone). Rows without a nonzero join
the first band's row list, so each tile row is written exactly once by
one band and the output needs no memset.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_sddmm_tpu_torch.codegen.variants import BandSpec, KernelVariant

#: Most slots a heavy-row segment holds: at most that many nonzeros a warp
#: walks in a heavy row. ``chip_smoke.py``'s split sweep on an H100 put the
#: bigbird attention call best at 64-128 (256: +13%, 512: +60%) and the
#: Graph500 R-mat fused pair flat from 128 to 512 (PERF.md, section 5).
SPLIT = 128
#: Most segments a block of the second pass sums (``chunk``; a row of at
#: most a quarter of them is a warp's alone): chosen on an H100 by
#: ``bench/kernel_ab.py``'s chunk sweep, 16-256 (PERF.md, section 6).
REDUCE_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class RowBand:
    """One band of one tile: its sorted int32 tile rows and, for the heavy
    band, the segment table (``seg_ptr`` [n_rows + 1]: the segments of
    ``rows[i]`` are ``seg_ptr[i]:seg_ptr[i+1]``; segment ``s`` covers
    slots ``seg_beg[s]:seg_end[s]`` of tile row ``seg_row[s]``) and the
    second pass's unit table (:func:`reduce_units`, made from ``seg_ptr``
    when not given, at ``chunk`` segments, default :data:`REDUCE_CHUNK`)
    with one zero counter a row, which the pass's kernels leave at zero.
    Arrays are numpy on the host and tensors once moved with :meth:`to`."""

    spec: BandSpec
    rows: object
    n_slots: int
    seg_ptr: object = None
    seg_row: object = None
    seg_beg: object = None
    seg_end: object = None
    chunk: int = 0
    n_short: int = 0
    unit_row: object = None
    unit_beg: object = None
    unit_end: object = None
    counters: object = None

    def __post_init__(self):
        if self.seg_ptr is None or self.unit_row is not None:
            return
        chunk = self.chunk or REDUCE_CHUNK
        seg_ptr = self.seg_ptr
        if isinstance(seg_ptr, torch.Tensor):
            seg_ptr = seg_ptr.cpu().numpy()
        n_short, unit_row, unit_beg, unit_end = reduce_units(seg_ptr, chunk)
        for name, value in (("chunk", chunk), ("n_short", n_short),
                            ("unit_row", unit_row), ("unit_beg", unit_beg),
                            ("unit_end", unit_end),
                            ("counters", np.zeros(seg_ptr.size - 1, np.int32))):
            object.__setattr__(self, name, value)

    @property
    def heavy(self) -> bool:
        return self.seg_ptr is not None

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_seg(self) -> int:
        return int(self.seg_beg.shape[0]) if self.heavy else 0

    @property
    def n_units(self) -> int:
        return int(self.unit_row.shape[0]) if self.heavy else 0

    def to(self, device) -> "RowBand":
        def put(x):
            if x is None:
                return None
            if isinstance(x, torch.Tensor):
                return x.to(device)
            return torch.from_numpy(np.asarray(x)).to(device)

        return dataclasses.replace(
            self, rows=put(self.rows), seg_ptr=put(self.seg_ptr),
            seg_row=put(self.seg_row), seg_beg=put(self.seg_beg),
            seg_end=put(self.seg_end), unit_row=put(self.unit_row),
            unit_beg=put(self.unit_beg), unit_end=put(self.unit_end),
            counters=put(self.counters))


@dataclasses.dataclass(frozen=True)
class Banding:
    """The bands of a tile set: the live specs, the band of every tile row
    of every bucket and each bucket's :class:`RowBand` s (numpy)."""

    specs: tuple[BandSpec, ...]
    band_of_row: np.ndarray            # [n_buckets, tile_rows] int64
    tiles: tuple[tuple[RowBand, ...], ...]


def _segments(starts: np.ndarray, ends: np.ndarray, split: int):
    """Cut the slot ranges ``[starts[i], ends[i])`` into segments of at
    most ``split`` slots: ``(seg_ptr, owner, seg_beg, seg_end)``; a range
    whose length is a multiple of ``split`` gets no empty last segment."""
    n_seg = -(-(ends - starts) // split)
    seg_ptr = np.zeros(starts.size + 1, dtype=np.int64)
    np.cumsum(n_seg, out=seg_ptr[1:])
    owner = np.repeat(np.arange(starts.size), n_seg)
    k = np.arange(seg_ptr[-1]) - seg_ptr[owner]
    seg_beg = starts[owner] + k * split
    seg_end = np.minimum(seg_beg + split, ends[owner])
    return seg_ptr, owner, seg_beg, seg_end


def reduce_units(seg_ptr, chunk: int):
    """The second pass's unit table over the rows ``i`` of a heavy band
    (segments ``seg_ptr[i]:seg_ptr[i+1]``): ``(n_short, unit_row,
    unit_beg, unit_end)``, int32, unit ``u`` covering segments
    ``unit_beg[u]:unit_end[u]`` of band row ``unit_row[u]``. Units
    ``[0, n_short)`` are the rows of at most ``chunk // 4`` segments
    (rows without one too), whole, in row order; then every longer row's
    chunks of at most ``chunk`` segments, in row order and, within a row,
    in segment order (its ``k``-th chunk starts at ``seg_ptr[i] + k *
    chunk``), a row's chunks consecutive."""
    if chunk < 4:
        raise ValueError(f"chunk must be >= 4, got {chunk}")
    seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
    n = np.diff(seg_ptr)
    short = np.flatnonzero(n <= chunk // 4)
    long_ = np.flatnonzero(n > chunk // 4)
    n_chunks = -(-n[long_] // chunk)
    row = np.repeat(long_, n_chunks)
    k = np.arange(row.size) - np.repeat(np.cumsum(n_chunks) - n_chunks, n_chunks)
    beg = seg_ptr[row] + k * chunk
    end = np.minimum(beg + chunk, seg_ptr[row + 1])
    as32 = [np.concatenate(p).astype(np.int32) for p in
            ((short, row), (seg_ptr[short], beg), (seg_ptr[short + 1], end))]
    return int(short.size), *as32


def build_banded(row_ptr, variant: KernelVariant, split: int | None = None,
                 chunk: int | None = None) -> Banding:
    """Partition the rows of every tile by nnz/row into ``variant``'s bands.

    ``row_ptr`` is the tile set's ``[n_buckets, tile_rows + 1]`` CSR row
    pointer (numpy or tensor). The band of each row is decided over all
    buckets together, as the JAX builder decides it over all nonzeros.
    ``split`` (default :data:`SPLIT`) bounds the slots of a heavy-row
    segment, ``chunk`` (default :data:`REDUCE_CHUNK`) the segments of a
    second-pass block (:func:`reduce_units`)."""
    split = SPLIT if split is None else int(split)
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    if isinstance(row_ptr, torch.Tensor):
        row_ptr = row_ptr.cpu().numpy()
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    deg = np.diff(row_ptr, axis=-1)
    specs = variant.bands

    band = np.full(deg.shape, len(specs) - 1, dtype=np.int64)
    unassigned = np.ones(deg.shape, dtype=bool)
    for i, spec in enumerate(specs):
        if spec.npr_max is None:
            continue
        m = unassigned & (deg <= spec.npr_max)
        band[m] = i
        unassigned &= ~m

    # The degeneration guard (JAX banded.py:214-221): a near-uniform degree
    # distribution that straddles a threshold collapses into one band.
    populated = deg > 0
    cnt = deg[populated]
    if len(specs) > 1 and cnt.size and cnt.max() <= 2 * np.median(cnt):
        per_band = np.bincount(band[populated], weights=cnt, minlength=len(specs))
        if (per_band > 0).sum() > 1:
            band[:] = int(per_band.argmax())

    live = [i for i in range(len(specs)) if np.any(populated & (band == i))]
    if not live:
        live = [len(specs) - 1]
    lut = np.zeros(len(specs), dtype=np.int64)
    lut[live] = np.arange(len(live))
    band = np.where(populated, lut[band], 0)
    specs = tuple(specs[i] for i in live)

    tiles = []
    for b in range(deg.shape[0]):
        per = []
        for j, spec in enumerate(specs):
            rows = np.flatnonzero(band[b] == j)
            n_slots = int(deg[b, rows].sum())
            if spec.npr_max is not None:
                per.append(RowBand(spec, rows.astype(np.int32), n_slots))
                continue
            seg_ptr, owner, beg, end = _segments(row_ptr[b, rows], row_ptr[b, rows + 1],
                                                 split)
            per.append(RowBand(spec, rows.astype(np.int32), n_slots,
                               seg_ptr=seg_ptr.astype(np.int32),
                               seg_row=rows[owner].astype(np.int32),
                               seg_beg=beg.astype(np.int32),
                               seg_end=end.astype(np.int32),
                               chunk=REDUCE_CHUNK if chunk is None else int(chunk)))
        tiles.append(tuple(per))
    return Banding(specs=specs, band_of_row=band, tiles=tuple(tiles))
