"""The port's banked codegen (variants, row bands, ``BankedCudaKernel``)
against the JAX package's (``codegen/``, ``BankedPallasKernel`` in
interpret mode).

Data rules follow ``tests/test_codegen_kernels.py``: the ``_skewed``,
``_uniform`` and ``_empty`` generators, and integer-valued f32 data
(|values| <= 4, |dense| <= 3, R <= 32, bounded row degrees) on which every
product and partial sum is exact, so any arithmetic difference is a bit
difference. Tolerances:

* variant ids, band assignment and integer data: exact;
* normal data against the float64 oracle: 1e-5 of its max abs value
  (float32 sums in another order: the heavy rows' split re-associates);
* bf16 against the JAX package's bf16: 1e-2 of the max abs value (bf16
  keeps 8 significant bits; the rounding points are the same);
* attention: outputs 1e-5 of their max abs value, weights 1e-6 absolute
  (they lie in [0, 1]); fused against unfused, bit for bit.

The heavy rows are cut at ``SPLIT = 3`` slots here, so they make several
segments, one of them of a length that is a multiple of 3. The CUDA
kernels themselves run only on the card; ``chip_smoke.py`` holds them
against these plain versions there.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_sddmm_tpu import masks as jax_masks
from distributed_sddmm_tpu.autotune.fingerprint import Problem as JaxProblem
from distributed_sddmm_tpu.codegen import BankedPallasKernel
from distributed_sddmm_tpu.codegen import build_banded as jax_build_banded
from distributed_sddmm_tpu.codegen import select_variant as jax_select
from distributed_sddmm_tpu.codegen import variant_from_id as jax_from_id
from distributed_sddmm_tpu.codegen import variant_ids_for as jax_ids_for
from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.ops.blocked import CHUNK
from distributed_sddmm_tpu.ops.pallas_kernels import PallasKernel
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.utils.buckets import pow2_bucket as jax_pow2
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.codegen import (
    BankedCudaKernel, banded, build_banded, make_banked_kernel, select_variant,
    variant_from_id, variant_ids_for,
)
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.ops import cuda_kernels
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import ATTN_NEG
from distributed_sddmm_tpu_torch.parallel.base import realized_kernel_variant
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockCyclicColumn
from distributed_sddmm_tpu_torch.parallel.sharding import (
    BankedTileView, TileView, build_tiles,
)
from distributed_sddmm_tpu_torch.utils import oracle
from distributed_sddmm_tpu_torch.utils.buckets import pow2_bucket
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture
def split3(monkeypatch):
    """Cut heavy rows at 3 slots."""
    monkeypatch.setattr(banded, "SPLIT", 3)


# ---------------------------------------------------------------- data


def _skewed(Mr=1024, Nc=1024, seed=0):
    """A few hub rows and a light tail (``tests/test_codegen_kernels.py``)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([
        rng.integers(0, 16, 1300), rng.integers(16, Mr, 1500)
    ]).astype(np.int64)
    cols = rng.integers(0, Nc, rows.size).astype(np.int64)
    return rows, cols, Mr, Nc


def _uniform(Mr=1024, Nc=896, seed=1):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, Mr, 2000).astype(np.int64)
    cols = rng.integers(0, Nc, 2000).astype(np.int64)
    return rows, cols, Mr, Nc


def _empty(Mr=1024, Nc=768, seed=0):
    return (np.zeros(0, np.int64), np.zeros(0, np.int64), Mr, Nc)


def _bigbird(seed=0):
    S = jax_masks.bigbird(256, 3, n_global=2, n_random=2, seed=seed)
    return S.rows, S.cols, S.M, S.N


def _window(seed=0):
    S = jax_masks.sliding_window(300, 6)
    return S.rows, S.cols, S.M, S.N


def _three_bands(seed=4):
    """All three bands in S and in S^T at ``rb4``: a one-nonzero tail, ten
    mid rows of 12, three heavy rows (36 and 45 slots: multiples of 3) and
    a global column of 48 rows. Deduplicated."""
    rng = np.random.default_rng(seed)
    Mr, Nc = 256, 192
    parts = [(np.arange(Mr), rng.integers(1, Nc, Mr))]
    parts += [(np.full(12, r), rng.choice(np.arange(1, Nc), 12, replace=False))
              for r in range(10, 20)]
    parts += [(np.full(n, r), rng.choice(np.arange(1, Nc), n, replace=False))
              for r, n in ((20, 36), (21, 45), (22, 50))]
    parts += [(np.arange(100, 148), np.zeros(48, np.int64))]
    rows = np.concatenate([p[0] for p in parts]).astype(np.int64)
    cols = np.concatenate([p[1] for p in parts]).astype(np.int64)
    key, idx = np.unique(rows * Nc + cols, return_index=True)
    idx.sort()
    return rows[idx], cols[idx], Mr, Nc


def _hub(seed=5):
    """A one-nonzero tail, mid rows of 12, heavy rows of 33 (with the
    tail's) and 95 slots, a hub row of 420 columns and a hub column of 420
    rows, so that S and S^T each have a heavy row of more than 400 slots.
    Deduplicated."""
    rng = np.random.default_rng(seed)
    Mr, Nc = 512, 480
    parts = [(np.arange(Mr), rng.integers(1, Nc, Mr))]
    parts += [(np.full(12, r), rng.choice(np.arange(1, Nc), 12, replace=False))
              for r in range(10, 20)]
    parts += [(np.full(n, r), rng.choice(np.arange(1, Nc), n, replace=False))
              for r, n in ((20, 32), (21, 95), (22, 420))]
    parts += [(rng.choice(np.arange(30, Mr), 420, replace=False), np.zeros(420, np.int64))]
    rows = np.concatenate([p[0] for p in parts]).astype(np.int64)
    cols = np.concatenate([p[1] for p in parts]).astype(np.int64)
    key, idx = np.unique(rows * Nc + cols, return_index=True)
    idx.sort()
    return rows[idx], cols[idx], Mr, Nc


def _tiles(rows, cols, Mr, Nc, variant):
    S = HostCOO(rows, cols, np.ones(rows.size), Mr, Nc)
    return build_tiles(S, ShardedBlockCyclicColumn(Mr, Nc, 1, 1), Mr, Nc, CPU,
                       variant=variant)


# ---------------------------------------------------------------- variants


PROBLEMS = [(R, npr) for R in (16, 128, 2048) for npr in (2, 32, 200)]


@pytest.mark.parametrize("R,npr", PROBLEMS)
def test_select_variant_equals_jax(R, npr):
    kw = dict(M=4096, N=4096, nnz=4096 * npr, R=R)
    got, want = select_variant(Problem(**kw)), jax_select(JaxProblem(**kw))
    assert got.variant_id == want.variant_id
    assert [dataclasses.astuple(b) for b in got.bands] == [
        dataclasses.astuple(b) for b in want.bands]
    assert got.banked == want.banked
    assert variant_from_id(got.variant_id) == got
    assert variant_ids_for(Problem(**kw)) == jax_ids_for(JaxProblem(**kw))
    assert Problem(**kw).npr_bucket == JaxProblem(**kw).npr_bucket


def test_pow2_bucket_equals_jax():
    for x in (0.0, 1.0, 1.4, 1.5, 5, 6, 22.6, 23, 27.8, 32, 100, 1e6):
        assert pow2_bucket(x) == jax_pow2(x)


@pytest.mark.parametrize("vid", ["v2.rb8.rm", "v999.rb8.rm", "garbage", "v1.rb8.rx",
                                 "v1.rb.rm"])
def test_bad_variant_ids_raise_in_both(vid):
    with pytest.raises(ValueError) as want:
        jax_from_id(vid)
    with pytest.raises(ValueError) as got:
        variant_from_id(vid)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- bands


def _jax_band_of_nonzero(rows, cols, Mr, Nc, variant):
    ban = jax_build_banded(1, np.zeros(rows.size, np.int64), rows, cols, Mr, Nc,
                           variant)
    chunk = (ban.host_to_chunk % (ban.n_chunks * CHUNK)) // CHUNK
    band = np.full(rows.size, -1)
    for i, b in enumerate(ban.bands):
        band[(chunk >= b.c0) & (chunk < b.c1)] = i
    assert np.all(band >= 0)
    return band, len(ban.bands)


@pytest.mark.parametrize("data_fn", [_skewed, _uniform, _empty, _bigbird, _window,
                                     _three_bands])
def test_band_of_every_nonzero_equals_jax(data_fn):
    rows, cols, Mr, Nc = data_fn()
    kw = dict(M=Mr, N=Nc, nnz=max(rows.size, 1), R=32)
    vid = jax_select(JaxProblem(**kw)).variant_id
    assert select_variant(Problem(**kw)).variant_id == vid
    want, n_bands = _jax_band_of_nonzero(rows, cols, Mr, Nc, jax_from_id(vid))
    ts = _tiles(rows, cols, Mr, Nc, variant_from_id(vid))
    assert ts.blk_variant == vid
    assert len(ts.banding.specs) == n_bands
    np.testing.assert_array_equal(ts.banding.band_of_row[0, rows], want)
    # Every tile row belongs to exactly one band's row list.
    bands = ts.tile(0, 0).bands
    listed = np.concatenate([b.rows.numpy() for b in bands])
    np.testing.assert_array_equal(np.sort(listed), np.arange(Mr))
    assert sum(b.n_slots for b in bands) == rows.size


def test_guard_collapses_a_window_mask_and_bigbird_keeps_its_heavy_rows():
    vid = select_variant(Problem(M=300, N=300, nnz=3000, R=32)).variant_id
    rows, cols, Mr, Nc = _window()
    assert len(_tiles(rows, cols, Mr, Nc, variant_from_id(vid)).banding.specs) == 1
    rows, cols, Mr, Nc = _bigbird()
    ts = _tiles(rows, cols, Mr, Nc, select_variant(Problem(Mr, Nc, rows.size, 32)))
    heavy = [b for b in ts.tile(0, 0).bands if b.heavy]
    assert len(heavy) == 1 and heavy[0].rows.tolist() == [0, 1]


@pytest.mark.parametrize("split", [1, 3, 7, 45, 1000])
def test_segments_cover_each_heavy_row_exactly(split):
    rows, cols, Mr, Nc = _three_bands()
    ts = _tiles(rows, cols, Mr, Nc, variant_from_id("v1.rb4.rs"))
    ban = build_banded(ts.row_ptr[:, 0], variant_from_id("v1.rb4.rs"), split=split)
    heavy = ban.tiles[0][-1]
    assert heavy.heavy and heavy.rows.tolist() == [20, 21, 22]
    rp = ts.row_ptr[0, 0].numpy()
    for i, r in enumerate(heavy.rows):
        s0, s1 = heavy.seg_ptr[i], heavy.seg_ptr[i + 1]
        beg, end = heavy.seg_beg[s0:s1], heavy.seg_end[s0:s1]
        assert np.all(heavy.seg_row[s0:s1] == r)
        assert beg[0] == rp[r] and end[-1] == rp[r + 1]
        np.testing.assert_array_equal(beg[1:], end[:-1])
        assert np.all(end - beg >= 1) and np.all(end - beg <= split)
        assert s1 - s0 == -(-(rp[r + 1] - rp[r]) // split)  # no empty last one


def _check_units(band, chunk):
    """The unit table of ``band`` covers every row's segments exactly
    once, in order: short rows (at most chunk // 4 segments) whole and
    first, in row order; then each longer row's chunks of at most
    ``chunk`` segments, consecutive, the k-th starting at seg_ptr + k *
    chunk."""
    seg_ptr = np.asarray(band.seg_ptr, dtype=np.int64)
    n = np.diff(seg_ptr)
    row, beg, end = (np.asarray(a, dtype=np.int64)
                     for a in (band.unit_row, band.unit_beg, band.unit_end))
    assert band.chunk == chunk
    assert np.asarray(band.counters).dtype == np.int32
    np.testing.assert_array_equal(band.counters, np.zeros(band.n_rows))
    short = np.flatnonzero(n <= chunk // 4)
    assert band.n_short == short.size
    np.testing.assert_array_equal(row[:band.n_short], short)
    np.testing.assert_array_equal(beg[:band.n_short], seg_ptr[short])
    np.testing.assert_array_equal(end[:band.n_short], seg_ptr[short + 1])
    covered = np.zeros(int(seg_ptr[-1]), np.int64)
    for u in range(band.n_units):
        covered[beg[u]:end[u]] += 1
    assert np.all(covered == 1)
    chunks = slice(band.n_short, band.n_units)
    assert np.all(np.diff(row[chunks]) >= 0)
    assert np.all((end - beg)[chunks] >= 1) and np.all((end - beg)[chunks] <= chunk)
    for i in np.flatnonzero(n > chunk // 4):
        mine = np.flatnonzero(row[chunks] == i) + band.n_short
        assert mine.size == -(-n[i] // chunk)
        np.testing.assert_array_equal(np.diff(mine), 1)
        np.testing.assert_array_equal(beg[mine], seg_ptr[i] + chunk * np.arange(mine.size))
        assert end[mine[-1]] == seg_ptr[i + 1]


@pytest.mark.parametrize("split,chunk", [(1, 4), (1, 64), (3, 4), (3, 8), (3, 12), (7, 8),
                                         (33, 4)])
def test_reduce_units_cover_each_heavy_row_once_in_order(split, chunk):
    rows, cols, Mr, Nc = _hub()
    ts = _tiles(rows, cols, Mr, Nc, variant_from_id(VID))
    ban = build_banded(ts.row_ptr[:, 0], variant_from_id(VID), split=split, chunk=chunk)
    heavy = ban.tiles[0][-1]
    assert heavy.heavy
    n = np.diff(heavy.seg_ptr)
    # Rows of more than 3 chunks, and at split 33 a row of one segment.
    assert n.max() > 3 * chunk and (split < 33 or n.min() == 1)
    _check_units(heavy, chunk)
    # Moved, then rebuilt at another chunk size from the moved arrays.
    moved = heavy.to(CPU)
    assert torch.equal(moved.unit_row, torch.from_numpy(heavy.unit_row))
    again = dataclasses.replace(moved, chunk=chunk + 4, unit_row=None, unit_beg=None,
                                unit_end=None, counters=None).to(CPU)
    _check_units(dataclasses.replace(again, **{
        k: getattr(again, k).numpy() for k in ("seg_ptr", "unit_row", "unit_beg",
                                               "unit_end", "counters")}), chunk + 4)


def test_reduce_units_edge_cases():
    # No rows; rows without a segment (short); one row of exactly k chunks.
    assert banded.reduce_units(np.zeros(1, np.int64), 8)[0] == 0
    n_short, row, beg, end = banded.reduce_units(np.array([0, 0, 0, 16, 17]), 8)
    assert n_short == 3 and row.tolist() == [0, 1, 3, 2, 2]
    assert beg.tolist() == [0, 0, 16, 0, 8] and end.tolist() == [0, 0, 17, 8, 16]
    with pytest.raises(ValueError, match="chunk"):
        banded.reduce_units(np.array([0, 5]), 3)


def test_non_banked_variant_keeps_the_generic_csr_and_records_its_id():
    rows, cols, Mr, Nc = _uniform()
    ts = _tiles(rows, cols, Mr, Nc, variant_from_id("v1.rb0.rm"))
    assert ts.blk_variant == "v1.rb0.rm" and ts.bands is None
    assert type(ts.tile(0, 0)) is TileView
    plain = _tiles(rows, cols, Mr, Nc, None)
    assert plain.blk_variant is None
    assert torch.equal(plain.row_ptr, ts.row_ptr) and torch.equal(plain.cols, ts.cols)


# ---------------------------------------------------------------- kernels


def _int_state(S, R, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, (S.M, R)).astype(np.float32),
            rng.integers(-3, 4, (S.N, R)).astype(np.float32),
            rng.integers(-4, 5, S.nnz).astype(np.float32))


def _normal_state(S, R, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S.M, R)).astype(np.float32),
            rng.standard_normal((S.N, R)).astype(np.float32),
            rng.standard_normal(S.nnz).astype(np.float32))


def _run_jax(S, R, fusion, kernel, state):
    ja = JaxDS(S, R=R, c=1, fusion_approach=fusion, kernel=kernel,
               devices=jax.devices()[:1])
    A_np, B_np, v = state
    A, B = ja.put_a(A_np), ja.put_b(B_np)
    sv, st = ja.scatter_s_values(v), ja.scatter_st_values(v)
    fa, fa_mid = ja.fused_spmm(A, B, sv, JaxMode.A)
    fb, fb_mid = ja.fused_spmm(A, B, st, JaxMode.B)
    return {
        "sddmmA": ja.gather_s_values(ja.sddmm_a(A, B, sv)),
        "sddmmB": ja.gather_st_values(ja.sddmm_b(A, B, st)),
        "spmmA": ja.host_a(ja.spmm_a(A, B, sv)),
        "spmmB": ja.host_b(ja.spmm_b(A, B, st)),
        "fusedA": ja.host_a(fa), "fusedA_mid": ja.gather_s_values(fa_mid),
        "fusedB": ja.host_b(fb), "fusedB_mid": ja.gather_st_values(fb_mid),
    }, ja.kernel_variant_realized


def _run_port(S, R, fusion, kernel, state, p=1, c=1):
    alg = DenseShift15D(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=R, c=c,
                        fusion_approach=fusion, kernel=kernel, world=LocalWorld(p),
                        device="cpu")
    A_np, B_np, v = state
    A, B = alg.put_a(A_np), alg.put_b(B_np)
    sv, st = alg.scatter_s_values(v), alg.scatter_st_values(v)
    fa, fa_mid = alg.fused_spmm(A, B, sv, MatMode.A)
    fb, fb_mid = alg.fused_spmm(A, B, st, MatMode.B)
    return alg, {
        "sddmmA": alg.gather_s_values(alg.sddmm_a(A, B, sv)),
        "sddmmB": alg.gather_st_values(alg.sddmm_b(A, B, st)),
        "spmmA": alg.host_a(alg.spmm_a(A, B, sv)),
        "spmmB": alg.host_b(alg.spmm_b(A, B, st)),
        "fusedA": alg.host_a(fa), "fusedA_mid": alg.gather_s_values(fa_mid),
        "fusedB": alg.host_b(fb), "fusedB_mid": alg.gather_st_values(fb_mid),
    }


def _three_band_coo():
    rows, cols, Mr, Nc = _three_bands()
    return JaxCOO(rows, cols, np.ones(rows.size), Mr, Nc)


VID = "v1.rb4.rs"


@pytest.mark.parametrize("fusion", [1, 2])
def test_banked_kernel_equals_jax_banked_and_generic_on_integer_data(split3, fusion):
    S, R = _three_band_coo(), 16
    state = _int_state(S, R, seed=fusion)
    want, jax_vid = _run_jax(S, R, fusion, BankedPallasKernel(
        VID, precision="f32", interpret=True), state)
    alg, got = _run_port(S, R, fusion, BankedCudaKernel(VID, "f32", device="cpu"), state)
    _, generic = _run_port(S, R, fusion, CudaTileKernel("f32", device="cpu"), state)
    # Both tile sets fill all three bands, and heavy rows make several
    # segments, one of exact-multiple length.
    for tiles in (alg.S_tiles, alg.ST_tiles):
        bands = tiles.tile(0, 0).bands
        assert [b.heavy for b in bands] == [False, False, True]
        lens = np.diff(tiles.row_ptr[0, 0].numpy())[bands[-1].rows.numpy()]
        assert bands[-1].n_seg > bands[-1].n_rows and np.any(lens % 3 == 0)
    assert alg.kernel_variant_realized == jax_vid == VID
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)
        np.testing.assert_array_equal(got[op], generic[op], err_msg=op)


@pytest.mark.parametrize("fusion", [1, 2])
def test_banked_at_4_ranks_equals_generic_on_integer_data(split3, fusion):
    """(p, c) = (4, 2): each rank's tiles carry their own bands, and the
    banked launches give the generic kernel's bits."""
    rows, cols, Mr, Nc = _hub()
    S, R = JaxCOO(rows, cols, np.ones(rows.size), Mr, Nc), 8
    state = _int_state(S, R, seed=fusion + 30)
    alg, got = _run_port(S, R, fusion, BankedCudaKernel(VID, "f32", device="cpu"), state,
                         p=4, c=2)
    _, generic = _run_port(S, R, fusion, CudaTileKernel("f32", device="cpu"), state,
                           p=4, c=2)
    for tiles in (alg.S_tiles, alg.ST_tiles):
        assert len(tiles.bands) == 4 and all(len(b) == 2 for b in tiles.bands)
        assert any(band.heavy for dev in tiles.bands for t in dev for band in t)
    assert alg.kernel_variant_realized == VID
    for op in generic:
        np.testing.assert_array_equal(got[op], generic[op], err_msg=op)


@pytest.mark.parametrize("fusion", [1, 2])
def test_banked_many_chunk_rows_equal_jax_banked_on_integer_data(split3, monkeypatch,
                                                                  fusion):
    """Heavy rows of more than three pass-2 chunks (a hub row of 420 slots
    at 3 slots a segment and 8 segments a chunk), in S and in S^T."""
    monkeypatch.setattr(banded, "REDUCE_CHUNK", 8)
    rows, cols, Mr, Nc = _hub()
    S, R = JaxCOO(rows, cols, np.ones(rows.size), Mr, Nc), 8
    state = _int_state(S, R, seed=fusion + 20)
    want, _ = _run_jax(S, R, fusion, BankedPallasKernel(
        VID, precision="f32", interpret=True), state)
    alg, got = _run_port(S, R, fusion, BankedCudaKernel(VID, "f32", device="cpu"), state)
    for tiles in (alg.S_tiles, alg.ST_tiles):
        heavy = tiles.tile(0, 0).bands[-1]
        assert heavy.heavy and heavy.chunk == 8
        assert int(torch.diff(heavy.seg_ptr).max()) > 3 * 8
        assert heavy.n_units - heavy.n_short > 3
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)


@pytest.mark.parametrize("fusion", [1, 2])
@pytest.mark.parametrize("M,N", [(30, 23), (23, 41), (64, 17)])
def test_banked_non_square_equals_jax_banked_on_integer_data(split3, M, N, fusion):
    S, R = JaxCOO.erdos_renyi(M, N, 3, seed=M + N), 8
    vid = jax_select(JaxProblem.from_coo(S, R)).variant_id
    state = _int_state(S, R, seed=fusion)
    want, jax_vid = _run_jax(S, R, fusion, BankedPallasKernel(
        vid, precision="f32", interpret=True), state)
    alg, got = _run_port(S, R, fusion, BankedCudaKernel(vid, "f32", device="cpu"), state)
    assert alg.kernel_variant_realized == jax_vid
    for op in want:
        assert got[op].shape == want[op].shape, op
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)


def test_banked_kernel_matches_the_float64_oracle_on_normal_data(split3):
    S, R = _three_band_coo(), 16
    A, B, v = _normal_state(S, R, seed=7)
    _, got = _run_port(S, R, 2, BankedCudaKernel(VID, "f32", device="cpu"), (A, B, v))
    Sv = HostCOO(S.rows, S.cols, v, S.M, S.N)
    A64, B64 = A.astype(np.float64), B.astype(np.float64)
    mid = oracle.sddmm(Sv, A64, B64)
    midB = oracle.sddmm(Sv.transpose(), B64, A64)
    exact = {"sddmmA": mid, "fusedA_mid": mid, "sddmmB": midB, "fusedB_mid": midB,
             "spmmA": oracle.spmm_a(Sv, B64), "spmmB": oracle.spmm_b(Sv, A64),
             "fusedA": oracle.spmm_a(Sv.with_values(mid), B64),
             "fusedB": oracle.spmm_b(Sv.with_values(midB), A64)}
    for op, ref in exact.items():
        assert np.abs(got[op] - ref).max() <= 1e-5 * np.abs(ref).max(), op


def test_banked_bf16_within_1e2_of_jax_bf16(split3):
    """Against the JAX package's bf16 tile kernels: its banked bodies'
    bf16 x bf16 -> f32 dot does not run on the CPU backend, its generic
    ones compute the same function with the same rounding points."""
    S, R = _three_band_coo(), 16
    state = _normal_state(S, R, seed=8)
    want, _ = _run_jax(S, R, 2, PallasKernel(precision="bf16", interpret=True), state)
    _, got = _run_port(S, R, 2, BankedCudaKernel(VID, "bf16", device="cpu"), state)
    for op in want:
        assert np.abs(got[op] - want[op]).max() <= 1e-2 * np.abs(want[op]).max(), op


# ---------------------------------------------------------------- plain versions


@pytest.mark.parametrize("split", [1, 3, None])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_split_plain_versions_equal_the_generic_plain_versions(split, prec):
    """``None``: each heavy row in one segment of its own length."""
    rows, cols, Mr, Nc = _three_bands()
    S = HostCOO(rows, cols, np.ones(rows.size), Mr, Nc)
    ts = _tiles(rows, cols, Mr, Nc, None)
    deg = np.diff(ts.row_ptr[0, 0].numpy())
    ban = build_banded(ts.row_ptr[:, 0], variant_from_id(VID),
                       split=split or int(deg.max()))
    generic = ts.tile(0, 0)
    tile = BankedTileView(*dataclasses.astuple(generic)[:5],
                          bands=tuple(b.to(CPU) for b in ban.tiles[0]))
    A, B, v = _int_state(S, 8, seed=9)
    k = CudaTileKernel(prec, device="cpu")
    bk = BankedCudaKernel(VID, prec, device="cpu")
    at, bt = k.prep(torch.from_numpy(A)), k.prep(torch.from_numpy(B))
    sv = ts.scatter_values(v)[0, 0]
    assert torch.equal(bk.sddmm_tile(tile, sv, at, bt), k.sddmm_tile(generic, sv, at, bt))
    assert torch.equal(bk.spmm_tile(tile, sv, bt), k.spmm_tile(generic, sv, bt))
    for got, want in zip(bk.fused_tile(tile, sv, at, bt), k.fused_tile(generic, sv, at, bt)):
        assert torch.equal(got, want)
    gate = torch.from_numpy((np.random.default_rng(1).random(rows.size) > 0.2)
                            .astype(np.float32))
    gate = ts.scatter_values(gate.numpy())[0, 0]
    gate[generic.row_ptr[21]:generic.row_ptr[22]] = 0  # a fully masked heavy row
    z = ts.scatter_values(np.random.default_rng(2).integers(-3, 4, rows.size)
                          .astype(np.float32))[0, 0]
    m, d = bk.attn_stats_tile(tile, gate, z)
    wm, wd = k.attn_stats_tile(generic, gate, z)
    # The maxima are exact; a split row's denominator rescales its
    # segments' sums of exps, which are not integers: 1e-6 relative.
    assert torch.equal(m, wm)
    torch.testing.assert_close(d, wd, rtol=1e-6, atol=0)
    assert m[21] == ATTN_NEG and d[21] == 0


def test_band_wrappers_write_only_their_band():
    rows, cols, Mr, Nc = _three_bands()
    ts = _tiles(rows, cols, Mr, Nc, variant_from_id(VID))
    tile = ts.tile(0, 0)
    A, B, v = _int_state(HostCOO(rows, cols, np.ones(rows.size), Mr, Nc), 8, seed=3)
    at, bt, sv = torch.from_numpy(A), torch.from_numpy(B), ts.scatter_values(v)[0, 0]
    short = tile.bands[0]
    out = torch.full((tile.n_rows, 8), float("nan"))
    mid = torch.full((tile.cap,), float("nan"))
    cuda_kernels.fused_rows(tile, short, sv, at, bt, out, mid, zero_pads=False)
    mine = torch.zeros(tile.n_rows, dtype=torch.bool)
    mine[short.rows.long()] = True
    assert torch.isfinite(out[mine]).all() and torch.isnan(out[~mine]).all()
    assert int(torch.isfinite(mid).sum()) == short.n_slots


def test_cpu_wrappers_count_no_launch_and_refuse_other_devices():
    rows, cols, Mr, Nc = _three_bands()
    ts = _tiles(rows, cols, Mr, Nc, variant_from_id(VID))
    tile = ts.tile(0, 0)
    sv = ts.like_values(1.0)[0, 0]
    cuda_kernels.reset_launch_counts()
    BankedCudaKernel(VID, "f32", device="cpu").fused_tile(
        tile, sv, torch.ones(Mr, 4), torch.ones(Nc, 4))
    assert set(cuda_kernels.launch_counts().values()) == {0}
    meta = torch.device("meta")
    heavy = tile.bands[-1]
    work = torch.empty(heavy.n_seg, 4, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.split_reduce(heavy, work, torch.empty(Mr, 4, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.attn_stats_split(tile, heavy, torch.empty(tile.cap, device=meta),
                                      torch.empty(tile.cap, device=meta))


# ---------------------------------------------------------------- attention


def _masked_bigbird(seed=3):
    S = jax_masks.bigbird(160, 3, n_global=2, n_random=2, seed=0)
    rng = np.random.default_rng(seed)
    vals = np.ones(S.nnz)
    vals[rng.random(S.nnz) < 0.1] = 0.0
    vals[np.isin(S.rows, [0, 3])] = 0.0  # global row 0 and row 3 fully masked
    return S.with_values(vals)


def _attention(alg_or_ja, A, B, vals_a, vals_b, port: bool):
    out = {}
    for mode, vals, tag in ((MatMode.A, vals_a, "A"), (MatMode.B, vals_b, "B")):
        o, p = alg_or_ja.fused_attention(A, B, vals, mode if port else JaxMode[mode.name])
        if mode == MatMode.A:
            out["out" + tag], out["probs" + tag] = (alg_or_ja.host_a(o),
                                                    alg_or_ja.gather_s_values(p))
        else:
            out["out" + tag], out["probs" + tag] = (alg_or_ja.host_b(o),
                                                    alg_or_ja.gather_st_values(p))
    return out


def test_banked_attention_matches_jax_banked(split3):
    _check_banked_attention()


def test_banked_attention_many_chunk_rows_matches_jax_banked(split3, monkeypatch):
    """The global rows (160 slots, 54 segments) in more than three pass-2
    chunks of 4 segments; global row 0 fully masked."""
    monkeypatch.setattr(banded, "REDUCE_CHUNK", 4)
    heavy = _check_banked_attention()
    assert heavy.chunk == 4 and heavy.n_units - heavy.n_short > 2 * 3


def _check_banked_attention():
    """The banked attention call against the JAX package's on
    :func:`_masked_bigbird`; returns the port's heavy band of S."""
    S, R = _masked_bigbird(), 8
    vid = jax_select(JaxProblem.from_coo(S, R)).variant_id
    rng = np.random.default_rng(11)
    A = rng.standard_normal((S.M, R)).astype(np.float32)
    B = rng.standard_normal((S.N, R)).astype(np.float32)
    v = S.vals.astype(np.float32)
    ja = JaxDS(S, R=R, c=1, fusion_approach=2,
               kernel=BankedPallasKernel(vid, precision="f32", interpret=True),
               devices=jax.devices()[:1])
    want = _attention(ja, ja.put_a(A), ja.put_b(B), ja.scatter_s_values(v),
                      ja.scatter_st_values(v), port=False)
    alg = DenseShift15D(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=R,
                        kernel=BankedCudaKernel(vid, "f32", device="cpu"), device="cpu")
    heavy = alg.S_tiles.tile(0, 0).bands[-1]
    assert heavy.heavy and heavy.rows.tolist() == [0, 1] and heavy.n_seg > 2
    assert alg.ST_tiles.tile(0, 0).bands[-1].rows.tolist() == [0, 1]
    Ap, Bp = alg.put_a(A), alg.put_b(B)
    sv, st = alg.scatter_s_values(v), alg.scatter_st_values(v)
    got = _attention(alg, Ap, Bp, sv, st, port=True)
    for op in want:
        if op.startswith("probs"):
            assert np.abs(got[op] - want[op]).max() <= 1e-6, op
        else:
            assert np.abs(got[op] - want[op]).max() <= 1e-5 * np.abs(want[op]).max(), op
    for dead in (0, 3):
        assert np.all(got["outA"][dead] == 0)
        assert np.all(got["probsA"][S.rows == dead] == 0)
    for vals, mode in ((sv, MatMode.A), (st, MatMode.B)):
        out_f, p_f = alg.fused_attention(Ap, Bp, vals, mode)
        out_u, p_u = alg.attention_unfused(Ap, Bp, vals, mode)
        assert torch.equal(out_f, out_u) and torch.equal(p_f, p_u)
    return heavy


# ---------------------------------------------------------------- CLI


def _er(*extra):
    return ["er", "6", "4", "15d_fusion2", "8", "1", "--device", "cpu", "--trials", "1",
            *extra]


def test_cli_kernel_variant_in_process(tmp_path, capsys):
    out = tmp_path / "rec.jsonl"
    assert cli.main(_er("--kernel-variant", "v1.rb4.rs", "-o", str(out))) == 0
    assert cli.main(_er("--kernel-variant", "v1.rb4.rs", "--kernel", "cuda-bf16",
                        "--app", "attention", "--mask", "bigbird:w=2",
                        "-o", str(out))) == 0
    assert cli.main(_er("-o", str(out))) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(capsys.readouterr().out.strip().splitlines()) == 3
    assert [r["kernel_variant"] for r in recs] == ["v1.rb4.rs", "v1.rb4.rs", None]
    assert [r["kernel"] for r in recs] == ["cuda-f32:v1.rb4.rs", "cuda-bf16:v1.rb4.rs",
                                           "cuda-f32"]
    assert recs[1]["app"] == "attention" and recs[1]["mask"] == "bigbird:w=2"


def test_cli_kernel_variant_refuses_the_torch_kernel():
    with pytest.raises(SystemExit):
        cli.main(_er("--kernel-variant", "v1.rb4.rs", "--kernel", "torch"))
    with pytest.raises(ValueError, match="unparseable"):
        cli.main(_er("--kernel-variant", "v1.rb4"))


def test_cli_kernel_variant_subprocess(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "rec.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_sddmm_tpu_torch.bench",
         *_er("--kernel-variant", "v1.rb4.rs", "-o", str(out))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.strip().splitlines()) == 1
    json.loads(proc.stdout)
    rec = json.loads(out.read_text())
    assert rec["kernel_variant"] == "v1.rb4.rs" and rec["overall_throughput"] > 0


def test_realized_variant_and_factory():
    S = HostCOO(np.array([0, 1, 1]), np.array([1, 0, 1]), np.ones(3), 2, 2)
    k = make_banked_kernel("v1.rb2.rs", precision="f32", device="cpu")
    assert isinstance(k, BankedCudaKernel) and k.variant_id == "v1.rb2.rs"
    alg = DenseShift15D(S, R=4, kernel=k, device="cpu")
    assert realized_kernel_variant(alg) == "v1.rb2.rs"
    generic = DenseShift15D(S, R=4, kernel=CudaTileKernel(device="cpu"), device="cpu")
    assert realized_kernel_variant(generic) is None
    assert realized_kernel_variant(type("K", (), {"kernel": k})()) == "v1.rb2.rs"
