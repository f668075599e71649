"""Host-side nonzero bucketing: HostCOO + layout -> padded device tiles
(counterpart of the host half of ``parallel/sharding.py``: ``build_tiles``
with ``TileSet``, and ``build_replicated_tiles`` with ``ReplicatedTiles``).

Flat value layout, owned by the port: every (device, tile) bucket is a
segment of ``max_nnz`` slots. Inside a segment the real nonzeros come
first, sorted by tile-local row (CSR order, ties in host order), and the
pads sit at the tail. A per-tile ``row_ptr`` gives each row's slot range,
so the CUDA tile kernels walk rows without any permutation on the device.
Pads are inert by the zero-value contract: ``row = col = 0`` and value 0,
so a pad adds nothing to SpMM and its SDDMM output is 0.

``swap=True`` builds the CSR over the layout's columns (a tile-local
column becomes the kernel's row, and the other way round): the Cannon
dense strategy's SpMM writes the tile's column dimension, and its SDDMM is
the same dot either way.

A codegen variant (``codegen/variants.py``) that bands adds each tile's
row bands (``codegen/banded.py``) beside the CSR, which it leaves as it
is; ``TileSet.tile`` then returns a :class:`BankedTileView`. The
replicated tiles of the sparse-replicating Cannon strategy are not
bankable, as in the JAX package: a banked variant builds the generic CSR
there and counts one ``codegen_generic_fallbacks`` (:data:`COUNTERS`).

Under a ``utils/buckets.dyn_capacity`` scope (``dynstruct/``) the slot
capacity of a tile set, and each band's tables, are sized to capacity
rungs, recorded as ``dyn_cap``; pads are never walked (a walk reads
``row_ptr``), so a capacity build computes what an exact build computes.
:func:`setup_tensors` / :func:`setup_from_tensors` turn a tile set into
named tensors and back (the program store's entries), and inside a
:func:`replaying` scope the builders hand back loaded tile sets in build
order instead of building them. :func:`copy_structure_` copies a rebuilt
tile set of the same shapes into an existing one's device tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import divide_round_up
from distributed_sddmm_tpu_torch.utils import buckets
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

#: Process-wide build counters: ``codegen_generic_fallbacks`` counts the
#: tile sets built generic although their kernel's variant bands.
COUNTERS = {"codegen_generic_fallbacks": 0}


@dataclasses.dataclass(frozen=True)
class TileView:
    """One tile of one device, as the tile kernels take it."""

    row_ptr: torch.Tensor  # [n_rows + 1] int32, slot range of each row
    rows: torch.Tensor     # [cap] int32 tile-local row of each slot (pads: 0)
    cols: torch.Tensor     # [cap] int32 tile-local column (pads: 0)
    n_rows: int            # output frame height
    n_cols: int            # moving-operand frame height

    @property
    def cap(self) -> int:
        return self.rows.shape[0]


@dataclasses.dataclass(frozen=True)
class BankedTileView(TileView):
    """A :class:`TileView` with its row bands
    (:class:`~distributed_sddmm_tpu_torch.codegen.banded.RowBand`, in band
    order), as the banked kernel takes it."""

    bands: tuple = ()


def packed_structure(view: TileView) -> torch.Tensor:
    """``row_ptr``, ``rows`` and ``cols`` of a tile in one int32 vector:
    what a ring hop between processes sends of the structure."""
    return torch.cat([view.row_ptr, view.rows, view.cols])


def unpack_structure(packed: torch.Tensor, like: TileView) -> TileView:
    """The :class:`TileView` of a :func:`packed_structure` vector, in the
    frame of ``like`` (every tile of a set has one frame and one cap).
    Its arrays are contiguous views of ``packed``."""
    n, cap = like.n_rows + 1, like.cap
    return TileView(packed[:n], packed[n:n + cap], packed[n + cap:], like.n_rows,
                    like.n_cols)


@dataclasses.dataclass
class TileSet:
    """Padded struct-of-arrays tiles, ``(slots, T, max_nnz)``: slot ``h``
    holds grid device ``devs[h]`` (``d = (i * nc + j) * nh + k``, grid
    row-major). A process that holds every rank holds every device in
    order; a process of one rank holds its own slot only. Host-side fields
    (``host_to_flat``, ``nnz_per_tile``) cover every device."""

    rows: torch.Tensor
    cols: torch.Tensor
    mask: torch.Tensor      # 1 at real nonzeros, 0 at pads
    row_ptr: torch.Tensor   # (slots, T, tile_rows + 1) int32
    host_to_flat: np.ndarray  # [nnz] int64: host nonzero -> flat slot
    tile_rows: int
    tile_cols: int
    nnz: int
    grid: tuple             # (rows, cols, layers)
    nnz_per_tile: np.ndarray  # (n_dev, T)
    #: The variant id that shaped the tiles: a banked variant's, or a
    #: non-banked variant's (the generic CSR, recorded); None without one.
    blk_variant: str | None = None
    #: Host banding (``codegen/banded.Banding``) of a banked variant.
    banding: object = None
    #: Each held tile's row bands on the device, ``bands[slot][s]``.
    bands: tuple | None = None
    #: The grid devices held, one a slot (None: every device, in order).
    devs: tuple | None = None
    #: Each band's stacked arrays of the held tiles on the device,
    #: ``band_arrays["<j>.<field>"]`` ``(slots, T, cap)``; ``bands`` are
    #: views of them.
    band_arrays: dict | None = None
    #: The capacity rungs this set was sized to under a ``dyn_capacity``
    #: scope, in build order (None: an exact build).
    dyn_cap: tuple | None = None

    def __post_init__(self):
        if self.devs is None:
            self.devs = tuple(range(self.n_dev))

    @property
    def n_dev(self) -> int:
        return int(np.prod(self.grid))

    @property
    def shape(self) -> tuple:
        return tuple(self.rows.shape)

    @property
    def max_nnz(self) -> int:
        return self.rows.shape[-1]

    @property
    def n_tiles(self) -> int:
        return self.rows.shape[-2]

    @property
    def nnz_per_device(self) -> np.ndarray:
        return self.nnz_per_tile.sum(axis=1).reshape(self.grid)

    def tile(self, slot: int, s: int) -> TileView:
        args = (self.row_ptr[slot, s], self.rows[slot, s], self.cols[slot, s],
                self.tile_rows, self.tile_cols)
        if self.bands is None:
            return TileView(*args)
        return BankedTileView(*args, bands=self.bands[slot][s])

    def like_values(self, value: float) -> torch.Tensor:
        """``value`` at every real nonzero, 0 at pads."""
        return self.mask * value

    def scatter_values(self, host_vals) -> torch.Tensor:
        """Place a vector in host nonzero order into tile structure (the
        held slots)."""
        buf = _host_buffer(host_vals, self.nnz, self.host_to_flat,
                           self.n_dev * self.n_tiles * self.max_nnz)
        buf = buf.reshape(self.n_dev, self.n_tiles, self.max_nnz)[list(self.devs)]
        return torch.from_numpy(buf).to(self.mask.device)

    def gather_values(self, all_vals: torch.Tensor) -> np.ndarray:
        """Values back in host nonzero order, from the values of every
        device, ``(n_dev, T, max_nnz)``."""
        return all_vals.detach().reshape(-1).cpu().numpy()[self.host_to_flat]


def _host_buffer(host_vals, nnz: int, host_to_flat, total: int) -> np.ndarray:
    if isinstance(host_vals, torch.Tensor):
        host_vals = host_vals.detach().cpu().numpy()
    host_vals = np.asarray(host_vals)
    if host_vals.shape != (nnz,):
        raise ValueError(f"expected ({nnz},) values, got {host_vals.shape}")
    buf = np.zeros(total, dtype=np.float32)
    buf[host_to_flat] = host_vals
    return buf


@dataclasses.dataclass
class _CSR:
    """The CSR of ``n_buckets`` buckets, each ``max_nnz`` slots: the flat
    structure on the build's device, the host map and counts on the host."""

    host_to_flat: np.ndarray
    counts: np.ndarray
    row_ptr: torch.Tensor  # (n_buckets, tile_rows + 1) int64
    rows: torch.Tensor     # (n_buckets * max_nnz,) int32
    cols: torch.Tensor
    mask: torch.Tensor     # float32
    max_nnz: int


def _bucket_csr(bucket, local_r, local_c, n_buckets: int, tile_rows: int,
                device, min_pad: int = 1, multiple: int = 1) -> _CSR:
    """Sort the nonzeros by (bucket, tile-local row), stable, and pad every
    bucket to the largest one's size, rounded up to ``multiple`` (to a
    capacity rung of the active ``dyn_capacity`` scope when one is).

    Runs on ``device``: a card sorts and scatters the full cell's 33.5M
    nonzeros in milliseconds, where the host takes seconds. Integer
    operations only, and a stable sort is unique, so every device gives
    the same tiles bit for bit."""
    b = torch.as_tensor(bucket).to(device)
    nnz = b.numel()
    row_key = b * tile_rows + torch.as_tensor(local_r).to(device)
    order = torch.sort(row_key, stable=True).indices
    counts = torch.bincount(b, minlength=n_buckets)
    top = int(counts.max()) if counts.numel() else 0
    max_nnz = divide_round_up(max(top, min_pad), multiple) * multiple
    cap = buckets.dyn_rung(max_nnz, multiple=multiple)
    if cap is not None:
        max_nnz = cap

    starts = torch.cumsum(counts, 0) - counts
    sorted_bucket = b[order]
    del b
    host_to_flat = torch.empty_like(order)
    host_to_flat[order] = (sorted_bucket * max_nnz
                           + torch.arange(nnz, device=order.device) - starts[sorted_bucket])
    del sorted_bucket, order

    total = n_buckets * max_nnz

    def flat(values, dtype):
        out = torch.zeros(total, dtype=dtype, device=host_to_flat.device)
        out[host_to_flat] = values.to(dtype)
        return out

    rows_flat = flat(row_key - (row_key // tile_rows) * tile_rows, torch.int32)
    cols_flat = flat(torch.as_tensor(local_c).to(device), torch.int32)
    mask_flat = torch.zeros(total, dtype=torch.float32, device=host_to_flat.device)
    mask_flat[host_to_flat] = 1

    row_counts = torch.bincount(row_key, minlength=n_buckets * tile_rows)
    row_ptr = torch.zeros((n_buckets, tile_rows + 1), dtype=torch.int64,
                          device=row_counts.device)
    torch.cumsum(row_counts.reshape(n_buckets, tile_rows), dim=1, out=row_ptr[:, 1:])
    return _CSR(host_to_flat.cpu().numpy(), counts.cpu().numpy(), row_ptr, rows_flat,
                cols_flat, mask_flat, max_nnz)


def _grid3(layout) -> tuple:
    return tuple(layout.grid) + (1,) * (3 - len(layout.grid))


def _layout(S: HostCOO, layout, tile_rows: int, tile_cols: int, swap: bool):
    """The layout's coordinates, checked against its grid and the tile
    frame; with ``swap`` the local coordinates trade places."""
    nr, nc, nh = _grid3(layout)
    res = layout(S.rows, S.cols)
    if res.i.size and not (res.i.max() < nr and res.j.max() < nc and res.k.max() < nh
                           and res.tile.max() < layout.n_tiles):
        raise ValueError("layout produced out-of-grid coordinates")
    if res.local_r.size and (res.local_r.max() >= tile_rows
                             or res.local_c.max() >= tile_cols):
        raise ValueError("layout produced coordinates outside the tile frame")
    dev = (res.i * nc + res.j) * nh + res.k
    if swap:
        return dev, res.tile, res.local_c, res.local_r
    return dev, res.tile, res.local_r, res.local_c


def build_tiles(
    S: HostCOO,
    layout,
    tile_rows: int,
    tile_cols: int,
    device: torch.device,
    min_pad: int = 1,
    variant=None,
    devs=None,
    swap: bool = False,
) -> TileSet:
    """Bucket ``S``'s nonzeros by (device, tile), sort each bucket by
    tile-local row and pad every bucket to the largest one's size. Only
    the grid devices ``devs`` (default: all) go to ``device``; the host
    build and ``max_nnz`` cover every device, so each slot has one shape
    whichever process holds it.

    ``tile_rows`` / ``tile_cols`` are the layout's frame. With ``swap`` the
    CSR runs over the layout's columns: the tile set's ``tile_rows`` is
    then the layout's ``tile_cols`` and the other way round.

    ``variant`` (a ``codegen.KernelVariant``): a banked one adds each
    tile's row bands; a non-banked one keeps the generic CSR. Either way
    the tile set records its id (``blk_variant``), as the JAX build does
    (``parallel/sharding.py:585-596``)."""
    grid = _grid3(layout)
    T = layout.n_tiles
    devs = tuple(range(int(np.prod(grid)))) if devs is None else tuple(devs)
    frame = (tile_cols, tile_rows) if swap else (tile_rows, tile_cols)
    loaded = _replayed(TileSet, S, device, grid=grid, n_tiles=T, frame=frame, devs=devs,
                       blk_variant=None if variant is None else variant.variant_id)
    if loaded is not None:
        return loaded
    mark = _dyn_mark()
    dev, tile, local_r, local_c = _layout(S, layout, tile_rows, tile_cols, swap)
    if swap:
        tile_rows, tile_cols = tile_cols, tile_rows
    n_dev = int(np.prod(grid))
    csr = _bucket_csr(dev * T + tile, local_r, local_c, n_dev * T, tile_rows, device,
                      min_pad)
    shape = (n_dev, T, csr.max_nnz)
    held = torch.as_tensor(devs, device=csr.rows.device)

    def put(x):
        return x.index_select(0, held)

    banding = None
    if variant is not None and variant.banked:
        # Imported here: codegen's kernel module imports this one.
        from distributed_sddmm_tpu_torch.codegen.banded import build_banded

        banding = build_banded(csr.row_ptr, variant)
    band_arrays, bands = _device_bands(banding, devs, T, device)

    return TileSet(
        rows=put(csr.rows.reshape(shape)),
        cols=put(csr.cols.reshape(shape)),
        mask=put(csr.mask.reshape(shape)),
        row_ptr=put(csr.row_ptr.to(torch.int32).reshape(n_dev, T, tile_rows + 1)),
        host_to_flat=csr.host_to_flat,
        tile_rows=tile_rows,
        tile_cols=tile_cols,
        nnz=S.nnz,
        grid=grid,
        nnz_per_tile=csr.counts.reshape(n_dev, T),
        blk_variant=None if variant is None else variant.variant_id,
        banding=banding,
        bands=bands,
        devs=devs,
        band_arrays=band_arrays,
        dyn_cap=_dyn_realized(mark),
    )


def _device_bands(banding, devs, T: int, device) -> tuple:
    """``(band_arrays, bands)`` of the held tiles: the band stacks of the
    held buckets on ``device``, ``(slots, T, cap)``, and each held tile's
    bands as views of them (``(None, None)`` without banding)."""
    if banding is None:
        return None, None
    from distributed_sddmm_tpu_torch.codegen.banded import band_views

    held = [d * T + s for d in devs for s in range(T)]
    arrays = {k: torch.from_numpy(v[held]).to(device).reshape(len(devs), T, -1)
              for k, v in banding.stacks.items()}
    bands = tuple(tuple(band_views(arrays, banding.counts[d * T + s], banding.specs,
                                   banding.chunk, (h, s)) for s in range(T))
                  for h, d in enumerate(devs))
    return arrays, bands


@dataclasses.dataclass
class ReplicatedTiles:
    """Tiles of the grid floor replicated up the ``layers`` fiber, values
    split over it (the JAX ``ReplicatedTiles``): rank ``(i, j, k)`` holds
    the structure of floor tile ``(i, j)`` and the ``k``-th of ``nh``
    contiguous equal slices of its values, ``max_nnz = nh * owned_len``.
    A fiber all-gather of the owned slices gives the tile's values; a
    fiber reduce-scatter splits summed dots back into them.

    Structure (``rows``, ``cols``, ``mask``, ``row_ptr``) is stored once a
    held floor tile (``floors``: the floor tiles of the held ranks, in
    order; ``floor_slot[h]`` is held rank ``h``'s); values and
    ``mask_owned`` once a held rank, ``(slots, owned_len)``."""

    rows: torch.Tensor      # (n_floor_held, max_nnz) int32
    cols: torch.Tensor
    mask: torch.Tensor      # (n_floor_held, max_nnz) float32
    row_ptr: torch.Tensor   # (n_floor_held, tile_rows + 1) int32
    mask_owned: torch.Tensor  # (slots, owned_len)
    host_to_flat: np.ndarray  # [nnz]: host nonzero -> flat index of (n_dev, owned_len)
    owned_len: int
    tile_rows: int
    tile_cols: int
    nnz: int
    grid: tuple             # (rows, cols, layers)
    nnz_per_floor: np.ndarray  # (nr, nc)
    devs: tuple
    floor_slot: tuple
    #: Always None: no variant shapes these tiles (the generic build).
    blk_variant: str | None = None
    #: The capacity rungs of a ``dyn_capacity`` build (None: exact).
    dyn_cap: tuple | None = None

    @property
    def n_dev(self) -> int:
        return int(np.prod(self.grid))

    @property
    def max_nnz(self) -> int:
        return self.rows.shape[-1]

    @property
    def nnz_per_device(self) -> np.ndarray:
        """Nonzeros of each floor tile, ``(nr, nc, 1)`` (the JAX
        package's shape for this layout)."""
        return self.nnz_per_floor.reshape(self.grid[0], self.grid[1], 1)

    def tile(self, slot: int) -> TileView:
        f = self.floor_slot[slot]
        return TileView(self.row_ptr[f], self.rows[f], self.cols[f], self.tile_rows,
                        self.tile_cols)

    def like_values(self, value: float) -> torch.Tensor:
        return self.mask_owned * value

    def scatter_values(self, host_vals) -> torch.Tensor:
        buf = _host_buffer(host_vals, self.nnz, self.host_to_flat,
                           self.n_dev * self.owned_len)
        buf = buf.reshape(self.n_dev, self.owned_len)[list(self.devs)]
        return torch.from_numpy(buf).to(self.mask.device)

    def gather_values(self, all_vals: torch.Tensor) -> np.ndarray:
        """Values back in host order, from every rank's owned slice,
        ``(n_dev, owned_len)``."""
        return all_vals.detach().reshape(-1).cpu().numpy()[self.host_to_flat]


def build_replicated_tiles(
    S: HostCOO,
    layout,
    nh: int,
    tile_rows: int,
    tile_cols: int,
    device: torch.device,
    variant=None,
    devs=None,
) -> ReplicatedTiles:
    """Bucket nonzeros onto the grid floor (``layout``, a ``Floor2D``),
    replicate the structure up the ``nh``-deep fiber and split each tile's
    values into ``nh`` contiguous slices (``max_nnz`` padded to a multiple
    of ``nh``). A banked ``variant`` cannot band this layout (the JAX
    package's ``sharding.py:228-252``): the build stays generic and counts
    one ``codegen_generic_fallbacks``."""
    if variant is not None and getattr(variant, "banked", False):
        COUNTERS["codegen_generic_fallbacks"] += 1
    nr, nc, _ = _grid3(layout)
    n_floor = nr * nc
    devs = tuple(range(n_floor * nh)) if devs is None else tuple(devs)
    loaded = _replayed(ReplicatedTiles, S, device, grid=(nr, nc, nh),
                       frame=(tile_rows, tile_cols), devs=devs)
    if loaded is not None:
        return loaded
    mark = _dyn_mark()
    floor, _, local_r, local_c = _layout(S, layout, tile_rows, tile_cols, False)
    csr = _bucket_csr(floor, local_r, local_c, n_floor, tile_rows, device, multiple=nh)
    owned = csr.max_nnz // nh
    floors = sorted({d // nh for d in devs})
    shape = (n_floor, csr.max_nnz)
    held = torch.as_tensor(floors, device=csr.rows.device)

    def put(x):
        return x.index_select(0, held)

    return ReplicatedTiles(
        rows=put(csr.rows.reshape(shape)),
        cols=put(csr.cols.reshape(shape)),
        mask=put(csr.mask.reshape(shape)),
        row_ptr=put(csr.row_ptr.to(torch.int32)),
        mask_owned=csr.mask.reshape(n_floor * nh, owned).index_select(
            0, torch.as_tensor(devs, device=csr.mask.device)),
        host_to_flat=csr.host_to_flat,
        owned_len=owned,
        tile_rows=tile_rows,
        tile_cols=tile_cols,
        nnz=S.nnz,
        grid=(nr, nc, nh),
        nnz_per_floor=csr.counts.reshape(nr, nc),
        devs=devs,
        floor_slot=tuple(floors.index(d // nh) for d in devs),
        dyn_cap=_dyn_realized(mark),
    )


# --------------------------------------------------------------------- #
# Capacity rungs, set-up tensors, replay and in-place structure copies
# --------------------------------------------------------------------- #


def _dyn_mark() -> int:
    st = buckets.dyn_capacity_state()
    return len(st.realized) if st is not None else 0


def _dyn_realized(mark: int):
    st = buckets.dyn_capacity_state()
    return tuple(st.realized[mark:]) if st is not None else None


#: The device tensors of each tile-set type that hold structure (a fit
#: rebind copies into them; ``band_arrays`` come beside a banked set's).
DEVICE_FIELDS = {"TileSet": ("rows", "cols", "mask", "row_ptr"),
                 "ReplicatedTiles": ("rows", "cols", "mask", "row_ptr", "mask_owned")}
#: The fields the program store keeps of each type; ``mask`` and
#: ``mask_owned`` are remade from the nonzero counts (real nonzeros lead
#: every bucket, pads trail).
_STORED = {"TileSet": ("rows", "cols", "row_ptr"),
           "ReplicatedTiles": ("rows", "cols", "row_ptr")}


class SetupMismatch(ValueError):
    """A loaded set-up does not match the tile set a build asked for."""


def setup_tensors(tiles) -> dict:
    """A tile set as named tensors and plain values, all on the host (what
    ``torch.load(weights_only=True)`` reads back): the held device
    structure, the host maps, the banding's stacks and the frame."""
    kind = type(tiles).__name__
    out = {"kind": kind, "tile_rows": tiles.tile_rows, "tile_cols": tiles.tile_cols,
           "nnz": tiles.nnz, "grid": list(tiles.grid), "devs": list(tiles.devs),
           "blk_variant": tiles.blk_variant,
           "dyn_cap": None if tiles.dyn_cap is None else list(tiles.dyn_cap),
           "host_to_flat": torch.from_numpy(np.ascontiguousarray(tiles.host_to_flat))}
    for name in _STORED[kind]:
        out[name] = getattr(tiles, name).detach().cpu()
    if kind == "TileSet":
        out["nnz_per_tile"] = torch.from_numpy(np.ascontiguousarray(tiles.nnz_per_tile))
        b = tiles.banding
        out["banding"] = None if b is None else {
            "live": list(b.live), "chunk": b.chunk,
            "band_of_row": torch.from_numpy(b.band_of_row),
            "counts": torch.from_numpy(b.counts),
            "stacks": {k: torch.from_numpy(v) for k, v in b.stacks.items()}}
    else:
        out["owned_len"] = tiles.owned_len
        out["nnz_per_floor"] = torch.from_numpy(np.ascontiguousarray(tiles.nnz_per_floor))
        out["floor_slot"] = list(tiles.floor_slot)
    return out


def _lead_mask(counts: torch.Tensor, width: int) -> torch.Tensor:
    """float32 1 at the first ``counts[...]`` slots of each bucket, 0 after."""
    slots = torch.arange(width, device=counts.device)
    return (slots < counts[..., None]).to(torch.float32)


def setup_from_tensors(d: dict, device):
    """The tile set :func:`setup_tensors` gave, on ``device``."""
    device = torch.device(device)
    kind = d["kind"]
    common = dict(tile_rows=int(d["tile_rows"]), tile_cols=int(d["tile_cols"]),
                  nnz=int(d["nnz"]), grid=tuple(d["grid"]), devs=tuple(d["devs"]),
                  host_to_flat=d["host_to_flat"].numpy(), blk_variant=d["blk_variant"],
                  dyn_cap=None if d["dyn_cap"] is None else tuple(d["dyn_cap"]))
    put = {name: d[name].to(device) for name in _STORED[kind]}
    width = put["rows"].shape[-1]
    if kind == "ReplicatedTiles":
        nr, nc, nh = common["grid"]
        per_floor = d["nnz_per_floor"]
        floors = sorted({x // nh for x in common["devs"]})
        every = _lead_mask(per_floor.reshape(-1), width)
        owned = int(d["owned_len"])
        return ReplicatedTiles(
            **put, mask=every[floors].to(device),
            mask_owned=every.reshape(nr * nc * nh, owned)[list(common["devs"])].to(device),
            owned_len=owned, nnz_per_floor=per_floor.numpy(),
            floor_slot=tuple(d["floor_slot"]), **common)
    per_tile = d["nnz_per_tile"]
    T = per_tile.shape[1]
    mask = _lead_mask(per_tile[list(common["devs"])].to(device), width)
    banding = None
    b = d["banding"]
    if b is not None:
        from distributed_sddmm_tpu_torch.codegen.banded import Banding
        from distributed_sddmm_tpu_torch.codegen.variants import variant_from_id

        bands_of = variant_from_id(common["blk_variant"]).bands
        banding = Banding(specs=tuple(bands_of[i] for i in b["live"]),
                          band_of_row=b["band_of_row"].numpy(), counts=b["counts"].numpy(),
                          stacks={k: v.numpy() for k, v in b["stacks"].items()},
                          chunk=int(b["chunk"]), live=tuple(b["live"]))
    band_arrays, bands = _device_bands(banding, common["devs"], T, device)
    return TileSet(**put, mask=mask, nnz_per_tile=per_tile.numpy(), banding=banding,
                   bands=bands, band_arrays=band_arrays, **common)


_REPLAY = threading.local()


@contextlib.contextmanager
def replaying(setups: list, device):
    """Inside this scope the tile builders return the tile sets of
    ``setups`` (:func:`setup_tensors` dicts) in order instead of building
    them; a build that asks for another tile set raises
    :class:`SetupMismatch`. Under a ``dyn_capacity`` scope the loaded
    sets' rungs count as realized."""
    if getattr(_REPLAY, "queue", None) is not None:
        raise RuntimeError("replaying scopes do not nest")
    _REPLAY.queue, _REPLAY.device = list(setups), torch.device(device)
    try:
        yield
        if _REPLAY.queue:
            raise SetupMismatch(f"{len(_REPLAY.queue)} loaded tile sets left unused")
    finally:
        _REPLAY.queue = _REPLAY.device = None


def _replayed(kind, S: HostCOO, device, **want):
    """The next loaded tile set when replaying (checked against what the
    build asks for), else None."""
    queue = getattr(_REPLAY, "queue", None)
    if queue is None:
        return None
    if not queue:
        raise SetupMismatch("no loaded tile set left for this build")
    d = queue.pop(0)
    got = {"grid": tuple(d["grid"]), "devs": tuple(d["devs"]),
           "frame": (int(d["tile_rows"]), int(d["tile_cols"]))}
    if "n_tiles" in want:
        got["n_tiles"] = int(d["nnz_per_tile"].shape[1])
    if "blk_variant" in want:
        got["blk_variant"] = d["blk_variant"]
    st = buckets.dyn_capacity_state()
    if (d["kind"] != kind.__name__ or got != want or int(d["nnz"]) != S.nnz
            or (st is None) != (d["dyn_cap"] is None)
            or torch.device(device) != _REPLAY.device):
        raise SetupMismatch(f"loaded {d['kind']} {got} does not match the build's "
                            f"{kind.__name__} {want}")
    tiles = setup_from_tensors(d, device)
    if st is not None:
        st.realized.extend(tiles.dyn_cap)
        st.seq += len(tiles.dyn_cap)
    return tiles


def structure_sig(tiles) -> tuple | None:
    """Everything of a tile set that tensors are sized by or kernels branch
    on: the device tensors' shapes, the frame, the realized variant, the
    live bands and the capacity rungs. Two sets with one signature can
    take each other's structure in place."""
    if tiles is None:
        return None
    kind = type(tiles).__name__
    sig = (kind, tiles.tile_rows, tiles.tile_cols, tiles.blk_variant, tiles.dyn_cap,
           tuple(tuple(getattr(tiles, f).shape) for f in DEVICE_FIELDS[kind]))
    if kind == "TileSet":
        banding = tiles.banding
        sig += (None if banding is None else banding.live,
                None if tiles.band_arrays is None else
                tuple(sorted((k, tuple(v.shape)) for k, v in tiles.band_arrays.items())))
    return sig


def copy_structure_(old, new) -> None:
    """Give ``old`` the structure of ``new`` (equal :func:`structure_sig`)
    without allocating a device tensor: copy into ``old``'s tensors and
    band stacks, take ``new``'s host maps and counts, and rebuild the band
    views over ``old``'s stacks."""
    if structure_sig(old) != structure_sig(new):
        raise ValueError("copy_structure_ needs tile sets of one structure signature")
    kind = type(old).__name__
    for f in DEVICE_FIELDS[kind]:
        getattr(old, f).copy_(getattr(new, f))
    old.host_to_flat, old.nnz = new.host_to_flat, new.nnz
    if kind == "ReplicatedTiles":
        old.nnz_per_floor = new.nnz_per_floor
        return
    old.nnz_per_tile = new.nnz_per_tile
    if old.band_arrays is not None:
        for k, v in old.band_arrays.items():
            v.copy_(new.band_arrays[k])
        old.banding = new.banding
        from distributed_sddmm_tpu_torch.codegen.banded import band_views

        T = old.n_tiles
        old.bands = tuple(tuple(band_views(old.band_arrays, new.banding.counts[d * T + s],
                                           new.banding.specs, new.banding.chunk, (h, s))
                                for s in range(T)) for h, d in enumerate(old.devs))
