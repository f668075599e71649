"""The port's tile building against the JAX package's ``TileSet``.

For the same ``HostCOO`` arrays, the port's ``build_tiles`` must give the
JAX package's per-tile nonzero counts and frames, and its own CSR layout
(row-sorted, pads at the tail, a per-tile ``row_ptr``) must round-trip
values in host order.
"""

import numpy as np
import pytest
import torch

import jax

from distributed_sddmm_tpu.parallel import layouts as jax_layouts
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockCyclicColumn
from distributed_sddmm_tpu_torch.parallel.sharding import build_tiles
from distributed_sddmm_tpu_torch.utils import coo as torch_coo

CPU = torch.device("cpu")


def _port_coo(S):
    return torch_coo.HostCOO(S.rows, S.cols, S.vals, S.M, S.N)


@pytest.mark.parametrize("p,c", [(1, 1), (2, 1), (4, 2), (8, 2), (8, 8)])
def test_layout_matches_jax(p, c):
    rng = np.random.default_rng(p * 10 + c)
    M, N = 203, 157
    rows, cols = rng.integers(0, M, 900), rng.integers(0, N, 900)
    want = jax_layouts.ShardedBlockCyclicColumn(M, N, p, c)(rows, cols)
    got = ShardedBlockCyclicColumn(M, N, p, c)(rows, cols)
    for field in ("i", "j", "tile", "local_r", "local_c"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("p,c", [(1, 1), (4, 1), (4, 2)])
def test_tile_counts_and_frames_match_jax(p, c):
    S = JaxCOO.rmat(log_m=7, edge_factor=6, seed=p + c)
    ja = JaxDS(S, R=8, c=c, devices=jax.devices()[:p])
    for tiles, jt, M, N in (
        ("S_tiles", ja.S_tiles, ja.M_pad, ja.N_pad),
        ("ST_tiles", ja.ST_tiles, ja.N_pad, ja.M_pad),
    ):
        src = _port_coo(S) if tiles == "S_tiles" else _port_coo(S.transpose())
        ts = build_tiles(src, ShardedBlockCyclicColumn(M, N, p, c),
                         jt.tile_rows, jt.tile_cols, CPU)
        assert (ts.tile_rows, ts.tile_cols) == (jt.tile_rows, jt.tile_cols)
        assert ts.max_nnz == jt.max_nnz and ts.n_tiles == jt.n_tiles
        want = np.asarray(jt.mask).sum(axis=-1).reshape(p, -1)
        np.testing.assert_array_equal(ts.nnz_per_tile, want)
        np.testing.assert_array_equal(ts.nnz_per_device.reshape(-1),
                                      jt.nnz_per_device.reshape(-1))


def test_scatter_gather_roundtrip_and_csr_invariants():
    S = JaxCOO.rmat(log_m=8, edge_factor=4, seed=3)
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(S.nnz).astype(np.float32)
    M = S.M
    ts = build_tiles(_port_coo(S), ShardedBlockCyclicColumn(M, M, 4, 2),
                     M // 4 * 2, M // 4, CPU)
    dev_vals = ts.scatter_values(vals)
    np.testing.assert_array_equal(ts.gather_values(dev_vals), vals)
    np.testing.assert_array_equal(ts.gather_values(ts.like_values(2.0)),
                                  np.full(S.nnz, 2.0, np.float32))
    assert float(dev_vals[ts.mask == 0].abs().sum()) == 0.0
    for dev in range(ts.rows.shape[0]):
        for s in range(ts.n_tiles):
            n = int(ts.nnz_per_tile[dev, s])
            rp = ts.row_ptr[dev, s].numpy()
            rows = ts.rows[dev, s].numpy()
            assert rp[0] == 0 and rp[-1] == n
            # Row-sorted real slots, each inside its row's slot range.
            np.testing.assert_array_equal(
                rows[:n], np.repeat(np.arange(ts.tile_rows), np.diff(rp)))
            # Pads at the tail: index 0, mask 0.
            assert np.all(rows[n:] == 0) and np.all(ts.cols[dev, s].numpy()[n:] == 0)
            assert np.all(ts.mask[dev, s].numpy()[:n] == 1)
            assert np.all(ts.mask[dev, s].numpy()[n:] == 0)


def test_scatter_values_rejects_wrong_length():
    S = JaxCOO.rmat(log_m=6, edge_factor=4, seed=1)
    ts = build_tiles(_port_coo(S), ShardedBlockCyclicColumn(S.M, S.N, 1, 1),
                     S.M, S.N, CPU)
    with pytest.raises(ValueError):
        ts.scatter_values(np.zeros(S.nnz + 1))


def test_empty_matrix_keeps_static_shape():
    S = torch_coo.HostCOO(np.zeros(0), np.zeros(0), np.zeros(0), 10, 10)
    ts = build_tiles(S, ShardedBlockCyclicColumn(10, 10, 1, 1), 10, 10, CPU)
    assert ts.max_nnz == 1 and int(ts.row_ptr[0, 0, -1]) == 0
    assert ts.gather_values(ts.like_values(1.0)).shape == (0,)


def test_port_coo_helpers_match_jax():
    S = JaxCOO.erdos_renyi(40, 30, 5, seed=2, values="normal")
    P = _port_coo(S)
    for a, b in ((P.transpose(), S.transpose()), (P.sorted_by_row(), S.sorted_by_row())):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
        np.testing.assert_array_equal(a.vals, b.vals)
    dup = torch_coo.HostCOO(np.r_[S.rows, S.rows[:7]], np.r_[S.cols, S.cols[:7]],
                            np.r_[S.vals, S.vals[:7]], S.M, S.N)
    np.testing.assert_array_equal(dup.deduplicated().rows, P.rows)


def test_port_rmat_shape_and_dedup():
    S = torch_coo.HostCOO.rmat(8, 8, seed=0)
    assert S.M == S.N == 256
    keys = S.rows * S.N + S.cols
    assert np.unique(keys).size == S.nnz
    # Uniform initiator: nearly all edges survive deduplication at this
    # density, and every row index is in range.
    assert 0.9 * 256 * 8 < S.nnz <= 256 * 8
    again = torch_coo.HostCOO.rmat(8, 8, seed=0)
    np.testing.assert_array_equal(again.rows, S.rows)
    with pytest.raises(ValueError):
        torch_coo.HostCOO.rmat(4, 2, a=0.5)
