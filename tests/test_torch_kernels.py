"""Plain PyTorch tile ops of the port against the JAX package's Pallas kernels.

The same tile (built as in ``tests/test_pallas_kernels.py``) and the same
numpy inputs go through ``PallasKernel(interpret=True)`` and through the
port's plain versions of its CUDA tile kernels; results are compared in host
nonzero order. Tolerances:

* small-integer data: bit-identical (every product and partial sum is an
  integer below 2**24, so float32 is exact in any summation order);
* standard-normal data: max abs error <= 1e-5 of the reference's max abs
  value (float32 sums taken in another order);
* the bf16 plain path against the f32 plain path: <= 1e-2 of the max abs
  value (bf16 keeps 8 significant bits of each operand and contribution).

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_sddmm_tpu.ops.blocked import CHUNK, build_blocked
from distributed_sddmm_tpu.ops.pallas_kernels import BlockedTile, PallasKernel

from distributed_sddmm_tpu_torch.ops import _build, cuda_kernels
from distributed_sddmm_tpu_torch.ops.cuda_kernels import (
    CudaTileKernel, fused_tile_plain, spmm_tile_plain, sddmm_tile_plain,
)
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockCyclicColumn
from distributed_sddmm_tpu_torch.parallel.sharding import build_tiles
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

MR, NC, NNZ = 700, 500, 3000


def _tiles(seed=0):
    """One random tile in both packages' encodings, from the same arrays."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, MR, NNZ).astype(np.int64)
    cols = rng.integers(0, NC, NNZ).astype(np.int64)
    meta = build_blocked(1, np.zeros(NNZ, np.int64), rows, cols, MR, NC)
    blk = BlockedTile(
        lr=jnp.array(meta.lr[0]), lc=jnp.array(meta.lc[0]),
        meta=jnp.array(meta.meta[0]), bm=meta.bm, bn=meta.bn,
        gr_blocks=meta.gr_blocks, gc_blocks=meta.gc_blocks, group=meta.group,
    )
    S = HostCOO(rows, cols, np.ones(NNZ), MR, NC)
    ts = build_tiles(S, ShardedBlockCyclicColumn(MR, NC, 1, 1), MR, NC,
                     torch.device("cpu"))
    return meta, blk, ts, rng


def _operands(rng, R, kind):
    if kind == "int":
        A = rng.integers(-3, 4, (MR, R)).astype(np.float32)
        B = rng.integers(-3, 4, (NC, R)).astype(np.float32)
        v = rng.integers(-2, 3, NNZ).astype(np.float32)
    else:
        A = rng.standard_normal((MR, R)).astype(np.float32)
        B = rng.standard_normal((NC, R)).astype(np.float32)
        v = rng.standard_normal(NNZ).astype(np.float32)
    return A, B, v


def _jax_ops(meta, blk, A, B, v, precision):
    k = PallasKernel(precision=precision, interpret=True)
    vals = np.zeros(meta.n_chunks * CHUNK, np.float32)
    vals[meta.host_to_chunk] = v
    vj, Aj, Bj = jnp.array(vals), jnp.array(A), jnp.array(B)
    mid = np.asarray(k.sddmm_tile(blk, vj, Aj, Bj))[meta.host_to_chunk]
    out = np.asarray(k.spmm_tile(blk, vj, Bj, MR))
    fo, fm = k.fused_tile(blk, vj, Aj, Bj)
    return mid, out, np.asarray(fo), np.asarray(fm)[meta.host_to_chunk]


def _torch_ops(ts, A, B, v, dtype=torch.float32, budget=None):
    kw = {} if budget is None else {"budget": budget}
    t = ts.tile(0, 0)
    sv = ts.scatter_values(v)[0, 0]
    at, bt = torch.from_numpy(A).to(dtype), torch.from_numpy(B).to(dtype)
    mid = sddmm_tile_plain(t, sv, at, bt, **kw)
    out = spmm_tile_plain(t, sv, bt, **kw)
    fo, fm = fused_tile_plain(t, sv, at, bt, **kw)
    gather = ts.gather_values
    return (gather(mid[None, None]), out.numpy(), fo.numpy(),
            gather(fm[None, None]))


def _assert_close(got, want, rel):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= rel * scale


@pytest.mark.parametrize("R", [8, 20])
def test_plain_bit_identical_to_pallas_on_small_integers(R):
    meta, blk, ts, rng = _tiles()
    A, B, v = _operands(rng, R, "int")
    for got, want in zip(_torch_ops(ts, A, B, v),
                         _jax_ops(meta, blk, A, B, v, "f32")):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R", [8, 20])
def test_plain_matches_pallas_on_normal_data(R):
    meta, blk, ts, rng = _tiles(seed=1)
    A, B, v = _operands(rng, R, "normal")
    for got, want in zip(_torch_ops(ts, A, B, v),
                         _jax_ops(meta, blk, A, B, v, "f32")):
        _assert_close(got, want, 1e-5)


def test_bf16_plain_bit_identical_to_pallas_bf16_on_small_integers():
    """The bf16 rounding points (operands, and each scatter contribution
    before it is added) are the Pallas kernel's: on integer data every
    rounding is deterministic and every sum exact, so the two agree."""
    meta, blk, ts, rng = _tiles(seed=2)
    A, B, v = _operands(rng, 8, "int")
    # Contributions above 256 round in bf16: scale B so that they do.
    B = B * 37
    got = _torch_ops(ts, A, B, v, dtype=torch.bfloat16)
    want = _jax_ops(meta, blk, A, B, v, "bf16")
    assert np.abs(got[1]).max() > 256
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("R", [8, 20])
def test_bf16_plain_within_1e2_of_f32_plain(R):
    _, _, ts, rng = _tiles(seed=3)
    A, B, v = _operands(rng, R, "normal")
    f32 = _torch_ops(ts, A, B, v)
    bf16 = _torch_ops(ts, A, B, v, dtype=torch.bfloat16)
    for got, want in zip(bf16, f32):
        _assert_close(got, want, 1e-2)


def test_segmented_plain_equals_one_pass():
    """A gather budget below the tile's footprint walks the nonzeros in
    segments; on integer data the result is the same bit for bit."""
    _, _, ts, rng = _tiles(seed=4)
    A, B, v = _operands(rng, 20, "int")
    whole = _torch_ops(ts, A, B, v)
    seg = _torch_ops(ts, A, B, v, budget=20 * 97)
    for got, want in zip(seg, whole):
        np.testing.assert_array_equal(got, want)


def test_pads_give_zero_mid_and_no_contribution():
    """Tiles of a 2x2 split hold different nonzero counts, so all but the
    fullest carry pads at their tail."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, MR, NNZ)
    cols = rng.integers(0, NC, NNZ)
    ts = build_tiles(HostCOO(rows, cols, np.ones(NNZ), MR, NC),
                     ShardedBlockCyclicColumn(MR, NC, 2, 1), MR // 2, NC // 2,
                     torch.device("cpu"))
    A, B, v = _operands(rng, 8, "normal")
    sv = ts.scatter_values(v)
    at, bt = torch.from_numpy(A[: MR // 2]), torch.from_numpy(B[: NC // 2])
    n_pads = 0
    for dev in range(2):
        for s in range(2):
            t, pads = ts.tile(dev, s), ts.mask[dev, s] == 0
            n_pads += int(pads.sum())
            mid = sddmm_tile_plain(t, sv[dev, s], at, bt)
            assert torch.all(mid[pads] == 0)
            real = spmm_tile_plain(t, sv[dev, s] * ts.mask[dev, s], bt)
            torch.testing.assert_close(spmm_tile_plain(t, sv[dev, s], bt), real,
                                       rtol=0, atol=0)
    assert n_pads > 0


def test_torch_kernel_flat_protocol_matches_tile_ops():
    _, _, ts, rng = _tiles(seed=6)
    A, B, v = _operands(rng, 8, "int")
    t = ts.tile(0, 0)
    sv = ts.scatter_values(v)[0, 0]
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    for budget in (None, 8 * 101):
        k = TorchKernel(gather_budget=budget)
        torch.testing.assert_close(k.sddmm(t.rows, t.cols, sv, At, Bt),
                                   sddmm_tile_plain(t, sv, At, Bt),
                                   rtol=0, atol=0)
        torch.testing.assert_close(k.spmm(t.rows, t.cols, sv, Bt, MR),
                                   spmm_tile_plain(t, sv, Bt), rtol=0, atol=0)


def test_wrappers_run_plain_on_cpu_without_counting():
    _, _, ts, rng = _tiles(seed=7)
    A, B, v = _operands(rng, 8, "int")
    t = ts.tile(0, 0)
    sv = ts.scatter_values(v)[0, 0]
    k = CudaTileKernel(device="cpu")
    assert k.precision == "f32"
    cuda_kernels.reset_launch_counts()
    at, bt = k.prep(torch.from_numpy(A)), k.prep(torch.from_numpy(B))
    out, mid = k.fused_tile(t, sv, at, bt)
    torch.testing.assert_close(out, fused_tile_plain(t, sv, at, bt)[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(mid, k.sddmm_tile(t, sv, at, bt), rtol=0, atol=0)
    torch.testing.assert_close(k.spmm_tile(t, sv, bt), spmm_tile_plain(t, sv, bt),
                               rtol=0, atol=0)
    assert cuda_kernels.launch_counts() == {
        "sddmm_tile": 0, "spmm_tile": 0, "fused_tile": 0, "attn_stats_tile": 0,
        "attn_norm_tile": 0}


def test_non_cpu_tensor_raises_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is never taken for it."""
    _, _, ts, _ = _tiles(seed=8)
    t = ts.tile(0, 0)
    meta = torch.device("meta")
    sv = torch.empty(t.cap, device=meta)
    at = torch.empty(MR, 8, device=meta)
    bt = torch.empty(NC, 8, device=meta)
    for call in (lambda: cuda_kernels.sddmm_tile(t, sv, at, bt),
                 lambda: cuda_kernels.spmm_tile(t, sv, bt),
                 lambda: cuda_kernels.fused_tile(t, sv, at, bt)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_build_key_tracks_sources_and_flags():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("tile_kernels-") and path.suffix == ".so"
    assert [s.name for s in _build._sources()] == ["attn_kernels.cu",
                                                   "tile_kernels.cu"]
    assert set(_build.SIGNATURES) == set(cuda_kernels.LAUNCHES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_precision_default_and_validation():
    assert CudaTileKernel(device="cpu").precision == "f32"
    assert CudaTileKernel("bf16", device="cpu").prep(
        torch.ones(2, 3)).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        CudaTileKernel("f16", device="cpu")
