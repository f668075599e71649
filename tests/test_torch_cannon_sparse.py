"""The port's ``CannonSparse25D`` against the JAX package's, case for case
of ``tests/test_cannon_sparse.py``: the port on ``LocalWorld(8)`` on the
CPU, the JAX strategy at the same (p, c) on the forced 8-device mesh
through ``PallasKernel(interpret=True, precision="f32")``. Bit for bit on
integer data, within 1e-5 of the output's max abs value on normal data.
These tiles are not bankable (as in the JAX package): a banked kernel
runs its generic walk, the record reports the generic kernel and each
tile set built counts one ``codegen_generic_fallbacks``. The JAX suite's
``test_rolled_matches_unrolled`` has no counterpart: the port's rings are
Python loops with no rolled build (``parallel/loops.py``).
"""

import numpy as np
import pytest
import torch

import jax

from distributed_sddmm_tpu.common import KernelMode as JaxKM
from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.parallel import layouts as jax_layouts
from distributed_sddmm_tpu.parallel.cannon_dense_25d import CannonDense25D as JaxCD
from distributed_sddmm_tpu.parallel.cannon_sparse_25d import CannonSparse25D as JaxCS
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.parallel.sparse_shift_15d import SparseShift15D as JaxSS

from _torch_strategy_cases import check_op, data, jax_alg, port_alg, port_coo, problem, run_ops

from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel
from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.parallel import sharding
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.layouts import Floor2D
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.utils import oracle

CONFIGS = [2, 8]  # c at p = 8: 2x2x2 and 1x1x8


def _check(op: str, c: int) -> None:
    check_op(JaxCS, CannonSparse25D, op, c, banked=False)


def test_requirements():
    S = problem()
    for R, c, match in ((8, 1, r"perfect square \(p=8, c=1\)"),
                        (6, 2, r"sqrt\(p/c\)\*c \| R \(R=6, sqrt\(p/c\)\*c=4")):
        with pytest.raises(ValueError, match=match):
            port_alg(CannonSparse25D, S, R, c)
        with pytest.raises(ValueError, match=match):
            JaxCS(S, R=R, c=c, devices=jax.devices())


def test_skewed_layout_roundtrip():
    """The host converters and the dummy fill agree on the skewed R
    layout, and the resident blocks hold the JAX package's values."""
    S = problem()
    alg, ja = port_alg(CannonSparse25D, S, 8, 2), jax_alg(JaxCS, S, 8, 2, pallas=False)
    A = alg.dummy_initialize(MatMode.A)
    np.testing.assert_array_equal(alg.host_a(A), oracle.dummy_dense(alg.M_pad, 8)[: alg.M])
    X = np.random.default_rng(1).standard_normal((S.M, 8)).astype(np.float32)
    np.testing.assert_array_equal(alg.host_a(alg.put_a(X)), X)
    # Rank (i, j, k) holds rows of block i, the R-slice of stored position
    # j * c + k of the JAX package's skewed (M_pad, R) storage.
    stored = np.asarray(ja.dummy_initialize(JaxMode.A))
    la, lx = 8 // 4, alg.localArows
    for h, (i, j, k) in enumerate(alg.comm.coords):
        q = j * 2 + k
        np.testing.assert_array_equal(alg._blocks(A, MatMode.A)[h].numpy(),
                                      stored[i * lx:(i + 1) * lx, q * la:(q + 1) * la])


def test_transpose_shift_self_inverse():
    S = problem()
    alg = port_alg(CannonSparse25D, S, 8, 2)
    B = alg.dummy_initialize(MatMode.B)
    _, B1 = alg.initial_shift(None, B, KernelMode.SDDMM_A)
    _, B2 = alg.de_shift(None, B1, KernelMode.SDDMM_A)
    assert not torch.equal(B1, B) and torch.equal(B2, B)
    ja = jax_alg(JaxCS, S, 8, 2, pallas=False)
    _, JB1 = ja.initial_shift(None, ja.dummy_initialize(JaxMode.B), JaxKM.SDDMM_A)
    # The shifted operand is no global matrix; compare the resident blocks.
    stored, lx, la = np.asarray(JB1), alg.localBrows, 2
    for h, (i, j, k) in enumerate(alg.comm.coords):
        q = j * 2 + k
        np.testing.assert_array_equal(alg._blocks(B1, MatMode.B)[h].numpy(),
                                      stored[i * lx:(i + 1) * lx, q * la:(q + 1) * la])


@pytest.mark.parametrize("c", CONFIGS)
def test_sddmm_a(c):
    _check("sddmmA", c)


@pytest.mark.parametrize("c", CONFIGS)
def test_sddmm_b(c):
    _check("sddmmB", c)


@pytest.mark.parametrize("c", CONFIGS)
def test_spmm_a(c):
    _check("spmmA", c)
    _check("spmmA_base", c)


@pytest.mark.parametrize("c", CONFIGS)
def test_spmm_b(c):
    _check("spmmB", c)


def test_fused_pair_both_modes():
    for c in CONFIGS:
        for op in ("fusedA", "fusedA_mid", "fusedB", "fusedB_mid"):
            _check(op, c)


def test_fused_and_four_algorithm_fingerprints():
    """The full scratch.cpp protocol: all four algorithms give the same
    spmmA fingerprint from dummy inputs, in the port and in the JAX
    package, and the two agree."""
    S = problem()
    got, want = [], []
    cases = ((CannonSparse25D, JaxCS, 2, "transpose"), (CannonDense25D, JaxCD, 2, "skew"),
             (DenseShift15D, JaxDS, 2, None), (SparseShift15D, JaxSS, 4, None))
    for cls, jcls, c, shift in cases:
        for alg, KM, MM, fps in ((port_alg(cls, S, 8, c), KernelMode, MatMode, got),
                                 (jcls(S, R=8, c=c, devices=jax.devices()), JaxKM, JaxMode,
                                  want)):
            B = alg.dummy_initialize(MM.B)
            if shift == "transpose":
                _, B = alg.initial_shift(None, B, KM.SPMM_A)
            out = alg.spmm_a(alg.like_a_matrix(0.0), B, alg.scatter_s_values(S.vals))
            out, _ = alg.de_shift(out, None, KM.SPMM_A)
            fps.append(alg.fingerprint(alg.host_a(out)[: S.M]))
    np.testing.assert_allclose(got, got[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got[0], oracle.fingerprint(oracle.spmm_a(
        port_coo(S), oracle.dummy_dense(S.N, 8))), rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_layout_matches_jax(n):
    rng = np.random.default_rng(n)
    M, N = 203, 157
    rows, cols = rng.integers(0, M, 900), rng.integers(0, N, 900)
    want = jax_layouts.Floor2D(M, N, n)(rows, cols)
    got = Floor2D(M, N, n)(rows, cols)
    for field in ("i", "j", "k", "tile", "local_r", "local_c"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("c", CONFIGS)
def test_replicated_tiles_roundtrip_matches_jax(c):
    """``ReplicatedTiles``: structure once a floor tile, values in ``c``
    equal slices (``max_nnz = c * owned_len``); scatter then gather gives
    the host values back, as the JAX build's does, with the same padded
    sizes and per-tile counts."""
    S = problem()
    alg, ja = port_alg(CannonSparse25D, S, 8, c), jax_alg(JaxCS, S, 8, c, pallas=False)
    vals = np.random.default_rng(c).standard_normal(S.nnz).astype(np.float32)
    for mine, theirs in ((alg.S_tiles, ja.S_tiles), (alg.ST_tiles, ja.ST_tiles)):
        assert (mine.max_nnz, mine.owned_len) == (theirs.max_nnz, theirs.owned_len)
        assert mine.max_nnz == c * mine.owned_len
        np.testing.assert_array_equal(mine.nnz_per_device, theirs.nnz_per_device)
        np.testing.assert_array_equal(mine.gather_values(mine.scatter_values(vals)), vals)
        np.testing.assert_array_equal(np.asarray(theirs.gather_values(
            theirs.scatter_values(vals))), vals)
        ones = mine.like_values(1.0)
        assert tuple(ones.shape) == (8, mine.owned_len) and float(ones.sum()) == S.nnz
    got, want = alg.json_algorithm_info(), ja.json_algorithm_info()
    for key in want:
        assert got[key] == want[key], key


def test_banked_kernel_runs_generic_and_counts_the_fallback(monkeypatch):
    """A banked kernel: two tile sets built generic, two fallbacks
    counted, the realized variant None; the generic walk's outputs."""
    S = problem()
    monkeypatch.setitem(sharding.COUNTERS, "codegen_generic_fallbacks", 0)
    k = BankedCudaKernel("v1.rb4.rs", "f32", device="cpu")
    alg = port_alg(CannonSparse25D, S, 8, 2, kernel=k)
    assert sharding.COUNTERS["codegen_generic_fallbacks"] == 2
    assert alg.kernel_variant_realized is None
    ops = data(S, 8, "int", seed=2)
    got = run_ops(alg, *ops)
    want = run_ops(jax_alg(JaxCS, S, 8, 2, pallas=False), *ops, jax_side=True)
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)
    port_alg(CannonSparse25D, S, 8, 2)
    assert sharding.COUNTERS["codegen_generic_fallbacks"] == 2


def test_dense_project_and_concat_heads_match_jax():
    """The skewed resident layout through the GAT's width changes:
    ``dense_project`` (unskew, ``X @ W``, skew) and ``concat_heads`` give
    the JAX package's host matrices."""
    S = problem()
    alg, ja = port_alg(CannonSparse25D, S, 8, 2), jax_alg(JaxCS, S, 8, 2, pallas=False)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((S.M, 8)).astype(np.float32)
    W = rng.integers(-2, 3, (8, 16)).astype(np.float32)
    got = alg.dense_project(alg.put_a(X), torch.from_numpy(W), MatMode.A)
    want = ja.dense_project(ja.put_a(X), W, JaxMode.A)
    assert alg.R == ja.R == 16
    np.testing.assert_allclose(alg.host_a(got), ja.host_a(want), rtol=1e-6, atol=1e-6)
    both = alg.concat_heads([got, got], MatMode.A)
    np.testing.assert_array_equal(alg.host_a(both), np.concatenate([alg.host_a(got)] * 2, 1))
