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


@dataclasses.dataclass
class TileSet:
    """Padded struct-of-arrays tiles of every device, ``(n_dev, T, max_nnz)``
    with ``n_dev = nr * nc`` in grid row-major order."""

    rows: torch.Tensor
    cols: torch.Tensor
    mask: torch.Tensor      # 1 at real nonzeros, 0 at pads
    row_ptr: torch.Tensor   # (n_dev, T, tile_rows + 1) int32
    host_to_flat: np.ndarray  # [nnz] int64: host nonzero -> flat slot
    tile_rows: int
    tile_cols: int
    nnz: int
    grid: tuple
    nnz_per_tile: np.ndarray  # (n_dev, T)

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

    def tile(self, dev: int, s: int) -> TileView:
        return TileView(self.row_ptr[dev, s], self.rows[dev, s],
                        self.cols[dev, s], self.tile_rows, self.tile_cols)

    def like_values(self, value: float) -> torch.Tensor:
        """``value`` at every real nonzero, 0 at pads."""
        return self.mask * value

    def scatter_values(self, host_vals) -> torch.Tensor:
        """Place a vector in host nonzero order into tile structure."""
        if isinstance(host_vals, torch.Tensor):
            host_vals = host_vals.detach().cpu().numpy()
        host_vals = np.asarray(host_vals)
        if host_vals.shape != (self.nnz,):
            raise ValueError(f"expected ({self.nnz},) values, got {host_vals.shape}")
        buf = np.zeros(int(np.prod(self.shape)), dtype=np.float32)
        buf[self.host_to_flat] = host_vals
        return torch.from_numpy(buf.reshape(self.shape)).to(self.mask.device)

    def gather_values(self, dev_vals: torch.Tensor) -> np.ndarray:
        """Values back in host nonzero order."""
        return dev_vals.detach().reshape(-1).cpu().numpy()[self.host_to_flat]


def build_tiles(
    S: HostCOO,
    layout,
    tile_rows: int,
    tile_cols: int,
    device: torch.device,
    min_pad: int = 1,
) -> TileSet:
    """Bucket ``S``'s nonzeros by (device, tile), sort each bucket by
    tile-local row and pad every bucket to the largest one's size."""
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
    order = np.argsort(row_key, kind="stable")
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

    def put(x):
        return torch.from_numpy(x).to(device)

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
    )
