"""The port's ``CannonDense25D`` against the JAX package's, case for case
of ``tests/test_cannon_dense.py``: the port on ``LocalWorld(8)`` on the
CPU, the JAX strategy at the same (p, c) on the forced 8-device mesh
through ``PallasKernel(interpret=True, precision="f32")``. Bit for bit on
integer data, within 1e-5 of the output's max abs value on normal data,
through the generic tile kernel and the banked one. The JAX suite's
``test_rolled_matches_unrolled`` has no counterpart: the port's rings are
Python loops with no rolled build (``parallel/loops.py``).
"""

import numpy as np
import pytest

import jax

from distributed_sddmm_tpu.common import KernelMode as JaxKM
from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.parallel import layouts as jax_layouts
from distributed_sddmm_tpu.parallel.cannon_dense_25d import CannonDense25D as JaxCD
from distributed_sddmm_tpu.utils import oracle as jax_oracle
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from _torch_strategy_cases import check_op, data, jax_alg, port_alg, problem, run_ops

from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel, banded, variant_from_id
from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.layouts import BlockCyclic25D
from distributed_sddmm_tpu_torch.utils import oracle

CONFIGS = [2, 8]  # c at p = 8: 2x2x2 and 1x1x8


def _check(op: str, c: int) -> None:
    check_op(JaxCD, CannonDense25D, op, c, banked=True)


def test_grid_requirements():
    S = problem()
    for R, c, match in ((8, 1, r"perfect square \(p=8, c=1"), (7, 2, r"sqrt\(p/c\) \| R")):
        with pytest.raises(ValueError, match=match):
            port_alg(CannonDense25D, S, R, c)
        with pytest.raises(ValueError, match=match):
            JaxCD(S, R=R, c=c, devices=jax.devices())


def test_skew_roundtrip():
    """The skew moves the moving operand (A in the A-modes, B in the
    B-modes) as the JAX package's does, and de_shift undoes it."""
    S = problem()
    alg, ja = port_alg(CannonDense25D, S, 8, 2), jax_alg(JaxCD, S, 8, 2, pallas=False)
    A, B = alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B)
    A_sk, same = alg.initial_shift(A, B, KernelMode.SDDMM_A)
    assert same is B and not np.array_equal(alg.host_a(A_sk), alg.host_a(A))
    JA = ja.dummy_initialize(JaxMode.A)
    np.testing.assert_array_equal(alg.host_a(A_sk),
                                  ja.host_a(ja.initial_shift(JA, None, JaxKM.SDDMM_A)[0]))
    A_rt, _ = alg.de_shift(A_sk, None, KernelMode.SDDMM_A)
    np.testing.assert_array_equal(alg.host_a(A_rt), oracle.dummy_dense(alg.M_pad, 8)[: alg.M])
    _, B_sk = alg.initial_shift(None, B, KernelMode.SPMM_B)
    _, B_rt = alg.de_shift(None, B_sk, KernelMode.SPMM_B)
    np.testing.assert_array_equal(alg.host_b(B_rt), oracle.dummy_dense(alg.N_pad, 8)[: alg.N])


@pytest.mark.parametrize("c", CONFIGS)
def test_sddmm_a(c):
    _check("sddmmA", c)


@pytest.mark.parametrize("c", CONFIGS)
def test_sddmm_b(c):
    _check("sddmmB", c)


@pytest.mark.parametrize("c", CONFIGS)
def test_spmm_a(c):
    _check("spmmA", c)


@pytest.mark.parametrize("c", CONFIGS)
def test_spmm_b(c):
    _check("spmmB", c)


def test_spmm_accumulates_into_moving_buffer():
    """The rotating output accumulates on top of its initial content, as
    the JAX package's does (``A + S @ B``)."""
    _check("spmmA_base", 2)
    S = problem()
    alg = port_alg(CannonDense25D, S, 8, 2)
    A, B = alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B)
    base, _ = alg.initial_shift(A, None, KernelMode.SPMM_A)
    out, _ = alg.de_shift(alg.spmm_a(base, B, alg.scatter_s_values(S.vals)), None,
                          KernelMode.SPMM_A)
    A_h, B_h = oracle.dummy_dense(alg.M_pad, 8), oracle.dummy_dense(alg.N_pad, 8)
    np.testing.assert_allclose(alg.host_a(out), A_h[: S.M] + jax_oracle.spmm_a(S, B_h),
                               rtol=1e-4, atol=1e-3)


def test_fused_and_fingerprint_parity_with_15d():
    for op in ("fusedA", "fusedA_mid", "fusedB", "fusedB_mid"):
        _check(op, 2)
    S = problem()
    alg = port_alg(CannonDense25D, S, 8, 2)
    A, B = alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B)
    A_sk, _ = alg.initial_shift(A, None, KernelMode.SDDMM_A)
    out, _ = alg.fused_spmm(A_sk, B, alg.scatter_s_values(S.vals))
    out, _ = alg.de_shift(out, None, KernelMode.SPMM_A)
    A_h, B_h = oracle.dummy_dense(alg.M_pad, 8), oracle.dummy_dense(alg.N_pad, 8)
    np.testing.assert_allclose(alg.host_a(out), jax_oracle.fused_spmm_a(S, A_h, B_h),
                               rtol=1e-3, atol=1e-2)
    assert set(alg.metrics) == {"sddmmA", "spmmA"}
    ref = port_alg(DenseShift15D, S, 8, 2)
    out2, _ = ref.fused_spmm(ref.dummy_initialize(MatMode.A), ref.dummy_initialize(MatMode.B),
                             ref.scatter_s_values(S.vals))
    np.testing.assert_allclose(alg.fingerprint(alg.host_a(out)),
                               ref.fingerprint(ref.host_a(out2)), rtol=1e-5)


def test_transposed_values_quirk():
    """The A-ops' values live in S^T's tiles, the B-ops' in S's, in both
    packages: the per-device counts of the tiles they address agree."""
    S = problem()
    alg, ja = port_alg(CannonDense25D, S, 8, 2), jax_alg(JaxCD, S, 8, 2, pallas=False)
    ones = alg.like_s_values(1.0)
    assert tuple(ones.shape) == alg.ST_tiles.shape
    np.testing.assert_array_equal(ones.sum(dim=-1).reshape(-1).numpy(),
                                  np.asarray(ja.like_s_values(1.0)).sum(axis=-1).reshape(-1))
    np.testing.assert_array_equal(alg.like_st_values(1.0).sum(dim=-1).reshape(-1).numpy(),
                                  np.asarray(ja.like_st_values(1.0)).sum(axis=-1).reshape(-1))
    got, want = alg.json_algorithm_info(), ja.json_algorithm_info()
    for key in want:
        assert got[key] == want[key], key


def test_flat_kernel_equals_tile_kernel():
    S = problem()
    ops = data(S, 8, "normal", seed=5)
    base = run_ops(port_alg(CannonDense25D, S, 8, 2), *ops)
    got = run_ops(port_alg(CannonDense25D, S, 8, 2, kernel=TorchKernel()), *ops)
    for op in base:
        np.testing.assert_array_equal(got[op], base[op], err_msg=op)


def test_banked_on_a_skewed_matrix(monkeypatch):
    """Heavy rows cut into 3-slot segments (the short band's threshold 2,
    so that the small swapped tiles have heavy rows): the banked kernel on
    the swapped tiles (its bands are over the rows the SpMM writes)
    travels with its bands, equal to the JAX package on integer data."""
    monkeypatch.setattr(banded, "SPLIT", 3)
    S = JaxCOO.rmat(log_m=7, edge_factor=6, a=0.57, b=0.19, c=0.19, d=0.05, seed=3)
    variant = variant_from_id("v1.rb2.rs")
    alg = port_alg(CannonDense25D, S, 8, 2, kernel=BankedCudaKernel(variant, "f32",
                                                                     device="cpu"))
    kinds = {b.heavy for h in range(8) for t in (alg.S_tiles, alg.ST_tiles)
             for b in t.tile(h, 0).bands}
    assert variant.banked and kinds == {False, True}
    assert alg.kernel_variant_realized == variant.variant_id
    ops = data(S, 8, "int", seed=4)
    want = run_ops(jax_alg(JaxCD, S, 8, 2, pallas=False), *ops, jax_side=True)
    got = run_ops(alg, *ops)
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)


@pytest.mark.parametrize("n,c,skew", [(1, 1, True), (2, 2, True), (2, 2, False), (3, 2, True)])
def test_layout_matches_jax(n, c, skew):
    rng = np.random.default_rng(n * 10 + c)
    M, N = 203, 157
    rows, cols = rng.integers(0, M, 900), rng.integers(0, N, 900)
    want = jax_layouts.BlockCyclic25D(M, N, n, c, skew=skew)(rows, cols)
    got = BlockCyclic25D(M, N, n, c, skew=skew)(rows, cols)
    for field in ("i", "j", "k", "tile", "local_r", "local_c"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
