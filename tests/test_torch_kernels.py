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

Besides the random tile, an edge tile holds rows of the lengths around
each batch and index chunk of the SpMM walk (``EDGE_LENS``); the plain SpMM
runs there as a whole tile, as a band's row list and as heavy-row
segments with their reduce, each held bit for bit against the Pallas
kernel on small integers, in f32 and in bf16 (R = 100: the scalar path).

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there. What is checked here without
``nvcc`` is the C ABI the ctypes binding assumes: every ``extern "C"``
definition in ``ops/csrc/*.cu`` against ``_build.SIGNATURES``.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_sddmm_tpu.ops.blocked import CHUNK, build_blocked
from distributed_sddmm_tpu.ops.pallas_kernels import BlockedTile, PallasKernel

from distributed_sddmm_tpu_torch.codegen import banded
from distributed_sddmm_tpu_torch.ops import _build, cuda_kernels, serve_kernels
from distributed_sddmm_tpu_torch.ops.cuda_kernels import (
    CudaTileKernel, fused_tile_plain, spmm_rows_plain, spmm_split_plain,
    spmm_tile_plain, sddmm_tile_plain, split_reduce_plain,
)
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockCyclicColumn
from distributed_sddmm_tpu_torch.parallel.sharding import build_tiles
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

MR, NC, NNZ = 700, 500, 3000
#: Row lengths of the edge tile: around each batch (2 to 16 slots) and
#: index chunk (4 to 32 slots) of the SpMM walk, empty rows and a
#: ``window:64`` row. Rows above EDGE_SPLIT slots are the heavy band's,
#: cut into segments of EDGE_SPLIT.
EDGE_LENS = (0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 129)
EDGE_SPLIT = 7


def _tiles(seed=0, lens=None):
    """One tile in both packages' encodings, from the same arrays: random,
    or with row ``37 i`` holding ``lens[i]`` slots on distinct columns."""
    rng = np.random.default_rng(seed)
    if lens is None:
        rows = rng.integers(0, MR, NNZ).astype(np.int64)
        cols = rng.integers(0, NC, NNZ).astype(np.int64)
    else:
        rows = np.repeat(np.arange(len(lens)) * 37, lens).astype(np.int64)
        cols = np.concatenate([rng.choice(NC, n, replace=False) for n in lens])
    meta = build_blocked(1, np.zeros(rows.size, np.int64), rows, cols, MR, NC)
    blk = BlockedTile(
        lr=jnp.array(meta.lr[0]), lc=jnp.array(meta.lc[0]),
        meta=jnp.array(meta.meta[0]), bm=meta.bm, bn=meta.bn,
        gr_blocks=meta.gr_blocks, gc_blocks=meta.gc_blocks, group=meta.group,
    )
    S = HostCOO(rows, cols, np.ones(rows.size), MR, NC)
    ts = build_tiles(S, ShardedBlockCyclicColumn(MR, NC, 1, 1), MR, NC,
                     torch.device("cpu"))
    return meta, blk, ts, rng


def _operands(rng, R, kind, nnz=NNZ):
    if kind == "int":
        A = rng.integers(-3, 4, (MR, R)).astype(np.float32)
        B = rng.integers(-3, 4, (NC, R)).astype(np.float32)
        v = rng.integers(-2, 3, nnz).astype(np.float32)
    else:
        A = rng.standard_normal((MR, R)).astype(np.float32)
        B = rng.standard_normal((NC, R)).astype(np.float32)
        v = rng.standard_normal(nnz).astype(np.float32)
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


def _spmm_kinds(ts, v, B, dtype=torch.float32):
    """The plain SpMM of the tile's other two item kinds: every row as one
    band's row list, and the rows above EDGE_SPLIT slots as its segments
    summed by the split's reduce (the other rows by row list)."""
    t = ts.tile(0, 0)
    sv = ts.scatter_values(v)[0, 0]
    bt = torch.from_numpy(B).to(dtype)
    row_ptr = t.row_ptr.numpy()
    lens = np.diff(row_ptr)
    every = banded.RowBand(None, np.arange(t.n_rows, dtype=np.int32),
                           int(row_ptr[-1])).to("cpu")
    by_rows = torch.full((t.n_rows, B.shape[1]), float("nan"))
    spmm_rows_plain(t, every, sv, bt, by_rows)
    heavy = np.flatnonzero(lens > EDGE_SPLIT).astype(np.int32)
    light = np.flatnonzero(lens <= EDGE_SPLIT).astype(np.int32)
    seg_ptr, owner, beg, end = banded._segments(row_ptr[heavy], row_ptr[heavy + 1],
                                                EDGE_SPLIT)
    hb = banded.RowBand(None, heavy, int(lens[heavy].sum()),
                        seg_ptr=seg_ptr.astype(np.int32), seg_row=heavy[owner],
                        seg_beg=beg.astype(np.int32), seg_end=end.astype(np.int32))
    hb = hb.to("cpu")
    assert hb.n_seg > hb.n_rows > 0
    by_split = torch.full((t.n_rows, B.shape[1]), float("nan"))
    spmm_rows_plain(t, banded.RowBand(None, light, 0).to("cpu"), sv, bt, by_split)
    split_reduce_plain(hb, spmm_split_plain(t, hb, sv, bt), by_split)
    return by_rows.numpy(), by_split.numpy()


def _assert_close(got, want, rel):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= rel * scale


@pytest.mark.parametrize("R,lens,prec", [
    pytest.param(8, None, "f32", id="8"),
    pytest.param(20, None, "f32", id="20"),
    pytest.param(16, EDGE_LENS, "f32", id="edges-16-f32"),
    pytest.param(16, EDGE_LENS, "bf16", id="edges-16-bf16"),
    pytest.param(100, EDGE_LENS, "bf16", id="edges-100-bf16"),
])
def test_plain_bit_identical_to_pallas_on_small_integers(R, lens, prec):
    """The three tile ops, and the SpMM as row list and as split + reduce
    too. In bf16, B is scaled so that contributions round (as in
    :func:`test_bf16_plain_bit_identical_to_pallas_bf16_on_small_integers`)."""
    meta, blk, ts, rng = _tiles(lens=lens)
    A, B, v = _operands(rng, R, "int", int(ts.nnz_per_tile[0, 0]))
    dtype = torch.float32
    if prec == "bf16":
        B, dtype = B * 37, torch.bfloat16
    got = _torch_ops(ts, A, B, v, dtype=dtype)
    want = _jax_ops(meta, blk, A, B, v, prec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g in _spmm_kinds(ts, v, B, dtype):
        np.testing.assert_array_equal(g, want[1])


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
    assert cuda_kernels.launch_counts() == dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    assert cuda_kernels.launch_counts("bf16") == dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    assert {"sddmm_tile", "spmm_tile", "fused_tile", "attn_stats_tile",
            "attn_norm_tile"} <= set(cuda_kernels.LAUNCHES)


def test_launch_counts_split_by_operand_type(monkeypatch):
    """A launch counts once under its wrapper, and under ``"bf16"`` when
    its dense operands were bf16 (a library stub stands in for the card's:
    every entry point returns success)."""
    class Lib:
        def __getattr__(self, fn):
            return lambda *args: 0

    monkeypatch.setattr(cuda_kernels._build, "load", Lib)
    cuda_kernels.reset_launch_counts()
    cuda_kernels._launch("spmm_tile", "spmm_tile", bf16=True)
    cuda_kernels._launch("spmm_tile", "spmm_tile")
    cuda_kernels._launch("split_reduce", "split_reduce")
    zero = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    assert cuda_kernels.launch_counts() == {**zero, "spmm_tile": 2, "split_reduce": 1}
    assert cuda_kernels.launch_counts("bf16") == {**zero, "spmm_tile": 1}
    assert cuda_kernels.launch_counts("f32") == {**zero, "spmm_tile": 1, "split_reduce": 1}
    with pytest.raises(ValueError, match="precision"):
        cuda_kernels.launch_counts("f16")
    cuda_kernels.reset_launch_counts()
    assert cuda_kernels.launch_counts() == cuda_kernels.launch_counts("bf16") == zero


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


def test_build_key_tracks_sources_and_flags(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("tile_kernels-") and path.suffix == ".so"
    assert [s.name for s in _build._sources()] == ["attn_kernels.cu",
                                                   "banked_kernels.cu",
                                                   "serve_kernels.cu",
                                                   "tile_kernels.cu"]
    # Every C entry point has a counted wrapper (the row-list launches
    # share the tile kernels' entry points under counters of their own).
    assert set(_build.SIGNATURES) <= set(cuda_kernels.LAUNCHES) | set(serve_kernels.LAUNCHES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # An edit to the shared header names another library.
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path() == path
    with open(tmp_path / "tile_common.cuh", "a") as f:
        f.write("\n")
    assert _build.library_path() != path


def test_build_source_writes_through_a_temporary_file(monkeypatch, tmp_path):
    """``build_source``: one library a source and flags, moved into place
    whole, reused while the source is unchanged."""
    src = tmp_path / "extra.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    calls = []

    def fake_run_all(cmds):
        (cmd,) = cmds
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        assert out.parent != _build.BUILD_DIR      # never the final name
        out.write_bytes(b"lib")
        calls.append(cmd)
        return ""

    monkeypatch.setattr(_build, "_run_all", fake_run_all)
    path = _build.build_source(src)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("extra-")
    assert path.suffix == ".so" and path.read_bytes() == b"lib"
    assert _build.build_source(src) == path and len(calls) == 1
    src.write_text("// two\n")
    assert _build.build_source(src) != path and len(calls) == 2
    assert sorted(p.name for p in _build.BUILD_DIR.iterdir()) == sorted(
        [path.name, _build.build_source(src).name])


_EXTERN_C = re.compile(r'extern "C"\s+[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)\s*\{')


def _extern_c_definitions() -> list:
    """``(name, [parameter, ...])`` of every ``extern "C"`` definition in
    ``ops/csrc/*.cu``, in file order."""
    defs = []
    for src in _build._sources():
        for m in _EXTERN_C.finditer(src.read_text()):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            defs.append((m.group(1), params))
    return defs


def _ctype(param: str):
    """The ctypes type a C parameter binds with: a pointer (the stream
    too) as ``c_void_p``, an ``int`` as ``c_int``, a ``float`` as
    ``c_float``."""
    if "*" in param:
        return ctypes.c_void_p
    assert param.split()[0] in ("int", "float"), param
    return ctypes.c_int if param.split()[0] == "int" else ctypes.c_float


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES) + ["tile_error_string"])
def test_c_entry_point_matches_its_ctypes_binding(name):
    """The C ABI the ctypes binding assumes: each entry point is defined
    once, with as many parameters as ``_build.SIGNATURES`` lists, pointers
    and ints in the same places (``tile_error_string`` is bound apart, in
    ``_build.load``, as ``[c_int]``)."""
    defs = [params for n, params in _extern_c_definitions() if n == name]
    assert len(defs) == 1, f"{name} is defined {len(defs)} times in ops/csrc"
    want = _build.SIGNATURES.get(name, [ctypes.c_int])
    assert [_ctype(p) for p in defs[0]] == want


def test_every_c_entry_point_is_bound():
    names = [n for n, _ in _extern_c_definitions()]
    assert sorted(names) == sorted([*_build.SIGNATURES, "tile_error_string"])


def test_ptxas_report_reads_registers_and_spills():
    log = (
        "ptxas info    : Compiling entry function '_Z4walkv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4walkv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 72 registers, used 0 barriers, 436 bytes cmem[0]\n"
        "ptxas info    : Function properties for _Z4slabv\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
    )
    assert _build.ptxas_report(log) == {
        "_Z4walkv": {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 72},
        "_Z4slabv": {"stack": 8, "spill_stores": 4, "spill_loads": 12},
    }


def test_every_walk_kernel_is_held_to_no_spill():
    """Phase build of ``chip_smoke.py`` fails on a spill in any kernel
    named in its ``WALK_KERNELS``: every ``__global__`` kernel of the
    shared walks (``ops/csrc/tile_common.cuh``) is named there."""
    import chip_smoke

    text = (_build.CSRC / "tile_common.cuh").read_text()
    walks = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                       text)
    assert {"dot_walk_kernel", "stats_walk_kernel"} <= set(walks)
    assert set(walks) <= set(chip_smoke.WALK_KERNELS)


def test_precision_default_and_validation():
    assert CudaTileKernel(device="cpu").precision == "f32"
    assert CudaTileKernel("bf16", device="cpu").prep(
        torch.ones(2, 3)).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        CudaTileKernel("f16", device="cpu")
