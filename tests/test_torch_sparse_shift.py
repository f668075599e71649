"""The port's ``SparseShift15D`` against the JAX package's, case for case
of ``tests/test_sparse_shift.py``: the port on ``LocalWorld(8)`` on the
CPU, the JAX strategy at the same (p, c) on the forced 8-device mesh
through ``PallasKernel(interpret=True, precision="f32")``. Bit for bit on
integer data, within 1e-5 of the output's max abs value on normal data,
through the generic tile kernel and the banked one (``BankedCudaKernel``,
whose CPU path is its plain version). The JAX suite's
``test_rolled_matches_unrolled`` has no counterpart: the port's rings are
Python loops with no rolled build (``parallel/loops.py``).
"""

import numpy as np
import pytest

import jax

from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.parallel import layouts as jax_layouts
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO
from distributed_sddmm_tpu.parallel.sparse_shift_15d import SparseShift15D as JaxSS
from distributed_sddmm_tpu.utils import oracle as jax_oracle

from _torch_strategy_cases import check_op, data, jax_alg, port_alg, port_coo, problem, run_ops

from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel, banded, select_variant
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockRow
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.utils import oracle

CONFIGS = [1, 2, 4, 8]  # c values at p = 8


def _check(op: str, c: int) -> None:
    check_op(JaxSS, SparseShift15D, op, c, banked=True)


def test_dense_representation_roundtrip():
    S = problem()
    alg = port_alg(SparseShift15D, S, 8, 2)
    A = alg.dummy_initialize(MatMode.A)
    # 8 blocks of p/c = 4 stripes, each 2 of the 8 columns wide.
    assert tuple(A.shape) == alg.dense_shape(MatMode.A) == (8 * 4 * alg.blockAwidth, 2)
    np.testing.assert_array_equal(alg.host_a(A), oracle.dummy_dense(alg.M_pad, 8)[: alg.M])
    X = np.random.default_rng(0).standard_normal((S.M, 8)).astype(np.float32)
    np.testing.assert_array_equal(alg.host_a(alg.put_a(X)), X)
    ja = jax_alg(JaxSS, S, 8, 2)
    np.testing.assert_array_equal(alg.host_a(A), ja.host_a(ja.dummy_initialize(JaxMode.A)))
    # Each rank's block is a contiguous view of the operand.
    for h, blk in enumerate(alg._blocks(A, MatMode.A)):
        assert blk.is_contiguous() and blk.data_ptr() == A[h * blk.shape[0]:].data_ptr()


@pytest.mark.parametrize("c", CONFIGS)
def test_sddmm_a(c):
    _check("sddmmA", c)


@pytest.mark.parametrize("c", [1, 2, 8])
def test_sddmm_b(c):
    _check("sddmmB", c)


@pytest.mark.parametrize("c", CONFIGS)
def test_spmm_a(c):
    _check("spmmA", c)
    _check("spmmA_base", c)


@pytest.mark.parametrize("c", [1, 4])
def test_spmm_b(c):
    _check("spmmB", c)


def test_fused_spmm_chained():
    """The base's fused pair (SDDMM, then SpMM with its values) in both
    modes, and against the float64 oracle."""
    for op in ("fusedA", "fusedA_mid", "fusedB", "fusedB_mid"):
        _check(op, 2)
    S = problem()
    alg = port_alg(SparseShift15D, S, 8, 2)
    A, B = alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B)
    out, _ = alg.fused_spmm(A, B, alg.scatter_s_values(S.vals))
    A_h, B_h = oracle.dummy_dense(alg.M_pad, 8), oracle.dummy_dense(alg.N_pad, 8)
    np.testing.assert_allclose(alg.host_a(out), jax_oracle.fused_spmm_a(S, A_h, B_h),
                               rtol=1e-3, atol=1e-2)
    assert set(alg.metrics) == {"sddmmA", "spmmA"}


def test_overlap_and_flat_kernel_equal_sequential():
    """``overlap=True`` (the tile hops before the step's kernel, the dots
    after it) and the flat ``TorchKernel`` give the sequential tile
    path's bits."""
    S = problem()
    ops = data(S, 8, "normal", seed=7)
    base = run_ops(port_alg(SparseShift15D, S, 8, 2), *ops)
    for kw in ({"overlap": True}, {"kernel": TorchKernel()},
               {"overlap": True, "kernel": CudaTileKernel("f32", device="cpu")}):
        got = run_ops(port_alg(SparseShift15D, S, 8, 2, **kw), *ops)
        for op in base:
            np.testing.assert_array_equal(got[op], base[op], err_msg=f"{op} {kw}")


def test_banked_on_a_skewed_matrix(monkeypatch):
    """A skewed R-mat with heavy rows cut into 3-slot segments: the banked
    kernel's traveling tiles carry their bands (every band kind runs),
    equal to the JAX package bit for bit on integer data."""
    monkeypatch.setattr(banded, "SPLIT", 3)
    S = JaxCOO.rmat(log_m=7, edge_factor=6, a=0.57, b=0.19, c=0.19, d=0.05, seed=2)
    variant = select_variant(Problem.from_coo(port_coo(S), 8))
    k = BankedCudaKernel(variant, "f32", device="cpu")
    alg = port_alg(SparseShift15D, S, 8, 2, kernel=k)
    kinds = {b.heavy for h in range(8) for b in alg.S_tiles.tile(h, 0).bands}
    assert variant.banked and kinds == {False, True}
    ops = data(S, 8, "int", seed=3)
    want = run_ops(jax_alg(JaxSS, S, 8, 2, pallas=False), *ops, jax_side=True)
    got = run_ops(alg, *ops)
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)


def test_cross_algorithm_fingerprints():
    """The fingerprint protocol across algorithms (``scratch.cpp:26-76``),
    in the port, against the JAX package's fingerprints."""
    from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS

    from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D

    S = problem()
    port, ref = [], []
    for cls, jcls, c, kw in ((SparseShift15D, JaxSS, 2, {}),
                             (DenseShift15D, JaxDS, 4, {"fusion_approach": 1}),
                             (DenseShift15D, JaxDS, 1, {"fusion_approach": 2})):
        for alg, modes, fps in ((port_alg(cls, S, 8, c, **kw), MatMode, port),
                                (jcls(S, R=8, c=c, devices=jax.devices(), **kw), JaxMode, ref)):
            A, B = alg.dummy_initialize(modes.A), alg.dummy_initialize(modes.B)
            out = alg.spmm_a(A, B, alg.scatter_s_values(S.vals))
            fps.append(alg.fingerprint(alg.host_a(out)[: S.M]))
    np.testing.assert_allclose(port, port[0], rtol=1e-5)
    np.testing.assert_allclose(port, ref, rtol=1e-5)


def test_r_divisibility_check():
    S = problem()
    with pytest.raises(ValueError, match=r"requires \(p/c\) \| R \(R=7, p/c=8\)"):
        port_alg(SparseShift15D, S, 7, 1)
    with pytest.raises(ValueError, match=r"requires \(p/c\) \| R \(R=7, p/c=8\)"):
        JaxSS(S, R=7, c=1, devices=jax.devices())
    alg = port_alg(SparseShift15D, S, 8, 2)
    with pytest.raises(ValueError):
        alg.set_r_value(6)
    assert alg.r_split and alg.r_split_axis == "rows"
    with pytest.raises(ValueError, match=r"requires c \| p \(p=8, c=3\)"):
        port_alg(SparseShift15D, S, 8, 3)


@pytest.mark.parametrize("p,c", [(1, 1), (4, 2), (8, 1), (8, 8)])
def test_layout_matches_jax(p, c):
    rng = np.random.default_rng(p + c)
    M, N = 203, 157
    rows, cols = rng.integers(0, M, 900), rng.integers(0, N, 900)
    want = jax_layouts.ShardedBlockRow(M, N, p, c)(rows, cols)
    got = ShardedBlockRow(M, N, p, c)(rows, cols)
    for field in ("i", "j", "k", "tile", "local_r", "local_c"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_tiles_and_record_info_match_jax():
    """Tile frames, max_nnz and the per-device nonzero counts the record
    reports are the JAX package's; every tile spans all N_pad columns."""
    S = problem()
    for c in (1, 2):
        alg, ja = port_alg(SparseShift15D, S, 8, c), jax_alg(JaxSS, S, 8, c, pallas=False)
        for mine, theirs in ((alg.S_tiles, ja.S_tiles), (alg.ST_tiles, ja.ST_tiles)):
            assert (mine.tile_rows, mine.tile_cols, mine.max_nnz) == (
                theirs.tile_rows, theirs.tile_cols, theirs.max_nnz)
        assert alg.S_tiles.tile_cols == alg.N_pad
        got, want = alg.json_algorithm_info(), ja.json_algorithm_info()
        for key in want:
            assert got[key] == want[key], key


def test_world_of_one_rank():
    """p = c = 1: no hop, no gather, the whole R in one slice."""
    S = problem()
    ops = data(S, 8, "int", seed=1)
    ja = JaxSS(S, R=8, c=1, devices=jax.devices()[:1])
    want = run_ops(ja, *ops, jax_side=True)
    got = run_ops(SparseShift15D(port_coo(S), 8, world=LocalWorld(1), device="cpu"), *ops)
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)
