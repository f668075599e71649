"""Host-side nonzero bucketing: HostCOO + layout -> padded device tiles
(counterpart of the host half of ``parallel/sharding.py::build_tiles`` and
of ``TileSet``).

Flat value layout, owned by the port: every (device, tile) bucket is a
segment of ``max_nnz`` slots. Inside a segment the real nonzeros come
first, sorted by tile-local row (CSR order, ties in host order), and the
pads sit at the tail. A per-tile ``row_ptr`` gives each row's slot range,
so the CUDA tile kernels walk rows without any permutation on the device.
Pads are inert by the zero-value contract: ``row = col = 0`` and value 0,
so a pad adds nothing to SpMM and its SDDMM output is 0.

A codegen variant (``codegen/variants.py``) that bands adds each tile's
row bands (``codegen/banded.py``) beside the CSR, which it leaves as it
is; ``TileSet.tile`` then returns a :class:`BankedTileView`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_sddmm_tpu_torch.utils.coo import HostCOO


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


@dataclasses.dataclass
class TileSet:
    """Padded struct-of-arrays tiles, ``(slots, T, max_nnz)``: slot ``h``
    holds grid device ``devs[h]`` (``d = i * nc + j``, grid row-major).
    A process that holds every rank holds every device in order; a
    process of one rank holds its own slot only. Host-side fields
    (``host_to_flat``, ``nnz_per_tile``) cover every device."""

    rows: torch.Tensor
    cols: torch.Tensor
    mask: torch.Tensor      # 1 at real nonzeros, 0 at pads
    row_ptr: torch.Tensor   # (slots, T, tile_rows + 1) int32
    host_to_flat: np.ndarray  # [nnz] int64: host nonzero -> flat slot
    tile_rows: int
    tile_cols: int
    nnz: int
    grid: tuple
    nnz_per_tile: np.ndarray  # (n_dev, T)
    #: The variant id that shaped the tiles: a banked variant's, or a
    #: non-banked variant's (the generic CSR, recorded); None without one.
    blk_variant: str | None = None
    #: Host banding (``codegen/banded.Banding``) of a banked variant.
    banding: object = None
    #: Each tile's row bands on the device, ``bands[slot][s]``.
    bands: tuple | None = None
    #: The grid devices held, one a slot (None: every device, in order).
    devs: tuple | None = None

    def __post_init__(self):
        if self.devs is None:
            self.devs = tuple(range(self.grid[0] * self.grid[1]))

    @property
    def n_dev(self) -> int:
        return self.grid[0] * self.grid[1]

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
        if isinstance(host_vals, torch.Tensor):
            host_vals = host_vals.detach().cpu().numpy()
        host_vals = np.asarray(host_vals)
        if host_vals.shape != (self.nnz,):
            raise ValueError(f"expected ({self.nnz},) values, got {host_vals.shape}")
        buf = np.zeros(self.n_dev * self.n_tiles * self.max_nnz, dtype=np.float32)
        buf[self.host_to_flat] = host_vals
        buf = buf.reshape(self.n_dev, self.n_tiles, self.max_nnz)[list(self.devs)]
        return torch.from_numpy(buf).to(self.mask.device)

    def gather_values(self, all_vals: torch.Tensor) -> np.ndarray:
        """Values back in host nonzero order, from the values of every
        device, ``(n_dev, T, max_nnz)``."""
        return all_vals.detach().reshape(-1).cpu().numpy()[self.host_to_flat]


def build_tiles(
    S: HostCOO,
    layout,
    tile_rows: int,
    tile_cols: int,
    device: torch.device,
    min_pad: int = 1,
    variant=None,
    devs=None,
) -> TileSet:
    """Bucket ``S``'s nonzeros by (device, tile), sort each bucket by
    tile-local row and pad every bucket to the largest one's size. Only
    the grid devices ``devs`` (default: all) go to ``device``; the host
    build and ``max_nnz`` cover every device, so each slot has one shape
    whichever process holds it.

    ``variant`` (a ``codegen.KernelVariant``): a banked one adds each
    tile's row bands; a non-banked one keeps the generic CSR. Either way
    the tile set records its id (``blk_variant``), as the JAX build does
    (``parallel/sharding.py:585-596``)."""
    nr, nc = layout.grid
    T = layout.n_tiles
    res = layout(S.rows, S.cols)
    if res.i.size and not (res.i.max() < nr and res.j.max() < nc
                           and res.tile.max() < T):
        raise ValueError("layout produced out-of-grid coordinates")
    if res.local_r.size and (res.local_r.max() >= tile_rows
                             or res.local_c.max() >= tile_cols):
        raise ValueError("layout produced coordinates outside the tile frame")

    n_dev = nr * nc
    n_buckets = n_dev * T
    bucket = (res.i * nc + res.j) * T + res.tile
    row_key = bucket * tile_rows + res.local_r
    # A stable sort is unique, so sorting on ``device`` gives the host
    # sort's permutation; a card sorts the full cell's 33.5M keys in
    # milliseconds, where the host takes tens of seconds.
    order = torch.sort(torch.from_numpy(row_key).to(device), stable=True
                       ).indices.cpu().numpy()
    counts = np.bincount(bucket, minlength=n_buckets)
    max_nnz = max(int(counts.max(initial=0)), min_pad)

    starts = np.zeros(n_buckets, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    sorted_bucket = bucket[order]
    within = np.arange(S.nnz, dtype=np.int64) - starts[sorted_bucket]
    host_to_flat = np.empty(S.nnz, dtype=np.int64)
    host_to_flat[order] = sorted_bucket * max_nnz + within

    total = n_buckets * max_nnz
    rows_flat = np.zeros(total, dtype=np.int32)
    cols_flat = np.zeros(total, dtype=np.int32)
    mask_flat = np.zeros(total, dtype=np.float32)
    rows_flat[host_to_flat] = res.local_r
    cols_flat[host_to_flat] = res.local_c
    mask_flat[host_to_flat] = 1

    row_counts = np.bincount(row_key, minlength=n_buckets * tile_rows)
    row_ptr = np.zeros((n_buckets, tile_rows + 1), dtype=np.int64)
    np.cumsum(row_counts.reshape(n_buckets, tile_rows), axis=1,
              out=row_ptr[:, 1:])

    shape = (n_dev, T, max_nnz)
    devs = tuple(range(n_dev)) if devs is None else tuple(devs)

    def put(x):
        return torch.from_numpy(x[list(devs)]).to(device)

    banding = bands = None
    if variant is not None and variant.banked:
        # Imported here: codegen's kernel module imports this one.
        from distributed_sddmm_tpu_torch.codegen.banded import build_banded

        banding = build_banded(row_ptr, variant)
        bands = tuple(tuple(tuple(b.to(device) for b in banding.tiles[d * T + s])
                            for s in range(T)) for d in devs)

    return TileSet(
        rows=put(rows_flat.reshape(shape)),
        cols=put(cols_flat.reshape(shape)),
        mask=put(mask_flat.reshape(shape)),
        row_ptr=put(row_ptr.astype(np.int32).reshape(n_dev, T, tile_rows + 1)),
        host_to_flat=host_to_flat,
        tile_rows=tile_rows,
        tile_cols=tile_cols,
        nnz=S.nnz,
        grid=(nr, nc),
        nnz_per_tile=counts.reshape(n_dev, T),
        blk_variant=None if variant is None else variant.variant_id,
        banding=banding,
        bands=bands,
        devs=devs,
    )
