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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import divide_round_up
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
    """The host CSR of ``n_buckets`` buckets, each ``max_nnz`` slots."""

    host_to_flat: np.ndarray
    counts: np.ndarray
    row_ptr: np.ndarray   # (n_buckets, tile_rows + 1) int64
    rows: np.ndarray      # (n_buckets * max_nnz,) int32
    cols: np.ndarray
    mask: np.ndarray      # float32
    max_nnz: int


def _bucket_csr(bucket, local_r, local_c, n_buckets: int, tile_rows: int,
                device, min_pad: int = 1, multiple: int = 1) -> _CSR:
    """Sort the nonzeros by (bucket, tile-local row), stable, and pad every
    bucket to the largest one's size, rounded up to ``multiple``."""
    nnz = bucket.size
    row_key = bucket * tile_rows + local_r
    # A stable sort is unique, so sorting on ``device`` gives the host
    # sort's permutation; a card sorts the full cell's 33.5M keys in
    # milliseconds, where the host takes tens of seconds.
    order = torch.sort(torch.from_numpy(row_key).to(device), stable=True
                       ).indices.cpu().numpy()
    counts = np.bincount(bucket, minlength=n_buckets)
    max_nnz = divide_round_up(max(int(counts.max(initial=0)), min_pad), multiple) * multiple

    starts = np.zeros(n_buckets, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    sorted_bucket = bucket[order]
    within = np.arange(nnz, dtype=np.int64) - starts[sorted_bucket]
    host_to_flat = np.empty(nnz, dtype=np.int64)
    host_to_flat[order] = sorted_bucket * max_nnz + within

    total = n_buckets * max_nnz
    rows_flat = np.zeros(total, dtype=np.int32)
    cols_flat = np.zeros(total, dtype=np.int32)
    mask_flat = np.zeros(total, dtype=np.float32)
    rows_flat[host_to_flat] = local_r
    cols_flat[host_to_flat] = local_c
    mask_flat[host_to_flat] = 1

    row_counts = np.bincount(row_key, minlength=n_buckets * tile_rows)
    row_ptr = np.zeros((n_buckets, tile_rows + 1), dtype=np.int64)
    np.cumsum(row_counts.reshape(n_buckets, tile_rows), axis=1, out=row_ptr[:, 1:])
    return _CSR(host_to_flat, counts, row_ptr, rows_flat, cols_flat, mask_flat, max_nnz)


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
    dev, tile, local_r, local_c = _layout(S, layout, tile_rows, tile_cols, swap)
    if swap:
        tile_rows, tile_cols = tile_cols, tile_rows
    n_dev = int(np.prod(grid))
    csr = _bucket_csr(dev * T + tile, local_r, local_c, n_dev * T, tile_rows, device,
                      min_pad)
    shape = (n_dev, T, csr.max_nnz)
    devs = tuple(range(n_dev)) if devs is None else tuple(devs)

    def put(x):
        return torch.from_numpy(x[list(devs)]).to(device)

    banding = bands = None
    if variant is not None and variant.banked:
        # Imported here: codegen's kernel module imports this one.
        from distributed_sddmm_tpu_torch.codegen.banded import build_banded

        banding = build_banded(csr.row_ptr, variant)
        bands = tuple(tuple(tuple(b.to(device) for b in banding.tiles[d * T + s])
                            for s in range(T)) for d in devs)

    return TileSet(
        rows=put(csr.rows.reshape(shape)),
        cols=put(csr.cols.reshape(shape)),
        mask=put(csr.mask.reshape(shape)),
        row_ptr=put(csr.row_ptr.astype(np.int32).reshape(n_dev, T, tile_rows + 1)),
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
    )


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
    floor, _, local_r, local_c = _layout(S, layout, tile_rows, tile_cols, False)
    n_floor = nr * nc
    csr = _bucket_csr(floor, local_r, local_c, n_floor, tile_rows, device, multiple=nh)
    owned = csr.max_nnz // nh
    devs = tuple(range(n_floor * nh)) if devs is None else tuple(devs)
    floors = sorted({d // nh for d in devs})
    shape = (n_floor, csr.max_nnz)

    def put(x):
        return torch.from_numpy(x[floors]).to(device)

    return ReplicatedTiles(
        rows=put(csr.rows.reshape(shape)),
        cols=put(csr.cols.reshape(shape)),
        mask=put(csr.mask.reshape(shape)),
        row_ptr=put(csr.row_ptr.astype(np.int32)),
        mask_owned=torch.from_numpy(
            csr.mask.reshape(n_floor * nh, owned)[list(devs)]).to(device),
        host_to_flat=csr.host_to_flat,
        owned_len=owned,
        tile_rows=tile_rows,
        tile_cols=tile_cols,
        nnz=S.nnz,
        grid=(nr, nc, nh),
        nnz_per_floor=csr.counts.reshape(nr, nc),
        devs=devs,
        floor_slot=tuple(floors.index(d // nh) for d in devs),
    )
