"""The slice as a whole: the port's ``DenseShift15D`` against the JAX
package's, with ``PallasKernel(interpret=True, precision="f32")``, on one
device (p = c = 1).

The JAX side's state (matrix, dense operands, nonzero values) is carried
across in host order by ``utils/interop.state_from_reference``, so both
packages compute on identical inputs. Outputs are compared in host order:
bit-identical on small-integer data (every sum is an integer below 2**24),
and within 1e-5 of the reference's max abs value on standard-normal data
(float32 sums in another order). Both packages' verify fingerprints agree
with each other within 1e-5 and with the float64 oracle within 1e-4, the
tolerance of the JAX package's own verify protocol.
"""

import numpy as np
import pytest
import torch

import jax

from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.ops.pallas_kernels import PallasKernel
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.utils import verify as jax_verify
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.bench import harness
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.utils import verify
from distributed_sddmm_tpu_torch.utils.interop import state_from_reference


def _jax_alg(S, R, fusion):
    return JaxDS(S, R=R, c=1, fusion_approach=fusion,
                 kernel=PallasKernel(interpret=True, precision="f32"),
                 devices=jax.devices()[:1])


def _data(S, R, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "int":
        A = rng.integers(-3, 4, (S.M, R)).astype(np.float32)
        B = rng.integers(-3, 4, (S.N, R)).astype(np.float32)
        v = rng.integers(-2, 3, S.nnz).astype(np.float32)
    else:
        A = rng.standard_normal((S.M, R)).astype(np.float32)
        B = rng.standard_normal((S.N, R)).astype(np.float32)
        v = rng.standard_normal(S.nnz).astype(np.float32)
    return A, B, v


def _run_jax(ja, S, A_np, B_np, v_np):
    A, B = ja.put_a(A_np), ja.put_b(B_np)
    sv = ja.scatter_s_values(v_np)
    # S^T keeps S's nonzero order, so the same host vector serves both.
    st = ja.scatter_st_values(v_np)
    fa, fa_mid = ja.fused_spmm(A, B, sv, JaxMode.A)
    fb, fb_mid = ja.fused_spmm(A, B, st, JaxMode.B)
    res = {
        "sddmmA": ja.gather_s_values(ja.sddmm_a(A, B, sv)),
        "sddmmB": ja.gather_st_values(ja.sddmm_b(A, B, st)),
        "spmmA": ja.host_a(ja.spmm_a(A, B, sv)),
        "spmmB": ja.host_b(ja.spmm_b(A, B, st)),
        "fusedA": ja.host_a(fa), "fusedA_mid": ja.gather_s_values(fa_mid),
        "fusedB": ja.host_b(fb), "fusedB_mid": ja.gather_st_values(fb_mid),
    }
    state = (ja.host_a(A), ja.host_b(B), ja.gather_s_values(sv))
    return res, state


def _run_port(S, R, fusion, state, kernel=None):
    cs = state_from_reference(S.rows, S.cols, S.vals, S.M, S.N, *state,
                              device="cpu")
    alg = DenseShift15D(cs.S, R=R, c=1, fusion_approach=fusion, kernel=kernel,
                        device="cpu")
    A, B = alg.put_a(cs.A), alg.put_b(cs.B)
    sv = alg.scatter_s_values(cs.s_vals)
    st = alg.scatter_st_values(cs.s_vals)
    fa, fa_mid = alg.fused_spmm(A, B, sv, MatMode.A)
    fb, fb_mid = alg.fused_spmm(A, B, st, MatMode.B)
    return {
        "sddmmA": alg.gather_s_values(alg.sddmm_a(A, B, sv)),
        "sddmmB": alg.gather_st_values(alg.sddmm_b(A, B, st)),
        "spmmA": alg.host_a(alg.spmm_a(A, B, sv)),
        "spmmB": alg.host_b(alg.spmm_b(A, B, st)),
        "fusedA": alg.host_a(fa), "fusedA_mid": alg.gather_s_values(fa_mid),
        "fusedB": alg.host_b(fb), "fusedB_mid": alg.gather_st_values(fb_mid),
    }


@pytest.mark.parametrize("fusion,R,log_m", [(1, 8, 7), (2, 20, 7), (2, 8, 8)])
def test_ops_match_jax_pallas(fusion, R, log_m):
    S = JaxCOO.rmat(log_m=log_m, edge_factor=6, seed=fusion)
    ja = _jax_alg(S, R, fusion)
    for kind in ("int", "normal"):
        want, state = _run_jax(ja, S, *_data(S, R, kind, seed=R + log_m))
        got = _run_port(S, R, fusion, state)
        assert set(got) == set(want)
        for op in want:
            if kind == "int":
                np.testing.assert_array_equal(got[op], want[op], err_msg=op)
            else:
                scale = float(np.abs(want[op]).max())
                assert np.abs(got[op] - want[op]).max() <= 1e-5 * scale, op


NON_SQUARE = [(30, 23), (23, 41), (64, 17)]


@pytest.mark.parametrize("fusion", [1, 2])
@pytest.mark.parametrize("R", [8, 20])
@pytest.mark.parametrize("M,N", NON_SQUARE)
def test_ops_match_jax_pallas_non_square(M, N, R, fusion):
    """As :func:`test_ops_match_jax_pallas`, on Erdos-Renyi matrices with
    M != N (rows and columns padded and sharded differently)."""
    S = JaxCOO.erdos_renyi(M, N, 3, seed=M + N)
    ja = _jax_alg(S, R, fusion)
    for kind in ("int", "normal"):
        want, state = _run_jax(ja, S, *_data(S, R, kind, seed=M * N + R))
        got = _run_port(S, R, fusion, state)
        assert set(got) == set(want)
        for op in want:
            assert got[op].shape == want[op].shape, op
            if kind == "int":
                np.testing.assert_array_equal(got[op], want[op], err_msg=op)
            else:
                scale = float(np.abs(want[op]).max())
                assert np.abs(got[op] - want[op]).max() <= 1e-5 * scale, op


@pytest.mark.parametrize("fusion", [1, 2])
def test_flat_torch_kernel_matches_jax_pallas(fusion):
    """The strategy's flat-protocol path (``TorchKernel``, gather-dot and
    ``index_add_``, segmented past its gather budget) gives the same
    results as the tile path."""
    S = JaxCOO.rmat(log_m=7, edge_factor=6, seed=fusion)
    ja = _jax_alg(S, 8, fusion)
    want, state = _run_jax(ja, S, *_data(S, 8, "int", seed=3))
    for budget in (None, 8 * 61):
        got = _run_port(S, 8, fusion, state, kernel=TorchKernel(budget))
        for op in want:
            np.testing.assert_array_equal(got[op], want[op], err_msg=op)


@pytest.mark.parametrize("fusion", [1, 2])
def test_verify_fingerprints_agree(fusion):
    S = JaxCOO.rmat(log_m=7, edge_factor=8, seed=5)
    R = 8
    want = jax_verify.fingerprint_algorithm(_jax_alg(S, R, fusion), S)
    cs = state_from_reference(S.rows, S.cols, S.vals, S.M, S.N,
                              np.zeros((S.M, R)), np.zeros((S.N, R)),
                              S.vals, device="cpu")
    alg = harness.make_algorithm(f"15d_fusion{fusion}", cs.S, R, device="cpu")
    got = verify.fingerprint_algorithm(alg, cs.S)
    oracle = verify.oracle_fingerprints(cs.S, R)
    assert set(got) == set(want) == set(oracle)
    for op in want:
        np.testing.assert_allclose(got[op], want[op], rtol=1e-5, err_msg=op)
        np.testing.assert_allclose(got[op], oracle[op], rtol=1e-4, err_msg=op)
    np.testing.assert_allclose(
        [oracle[op] for op in oracle],
        [jax_verify.oracle_fingerprints(S, R)[op] for op in oracle], rtol=1e-12)


def test_padding_rows_stay_inert():
    """M not a multiple of anything: M_pad = M at p = 1, and put_a pads
    rows past the host matrix with zeros that host_a strips."""
    S = JaxCOO.erdos_renyi(30, 23, 3, seed=1, values="normal")
    cs = state_from_reference(S.rows, S.cols, S.vals, S.M, S.N,
                              np.ones((S.M, 4)), np.ones((S.N, 4)), S.vals,
                              device="cpu")
    alg = DenseShift15D(cs.S, R=4, device="cpu")
    assert (alg.M_pad, alg.N_pad) == (30, 23)
    A = alg.put_a(np.ones((10, 4)))
    assert float(A[10:].abs().sum()) == 0.0 and alg.host_a(A).shape == (30, 4)


def test_multi_rank_not_ported():
    S = JaxCOO.erdos_renyi(16, 16, 2, seed=0)
    cs = state_from_reference(S.rows, S.cols, S.vals, 16, 16, np.zeros((16, 2)),
                              np.zeros((16, 2)), S.vals, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DenseShift15D(cs.S, R=2, p=4, device="cpu")
    with pytest.raises(ValueError):
        DenseShift15D(cs.S, R=2, fusion_approach=3, device="cpu")
    for name in harness.NOT_PORTED:
        with pytest.raises(NotImplementedError):
            harness.make_algorithm(name, cs.S, 2, device="cpu")


def test_benchmark_record_fields():
    S = JaxCOO.rmat(log_m=6, edge_factor=4, seed=0)
    cs = state_from_reference(S.rows, S.cols, S.vals, S.M, S.N,
                              np.zeros((S.M, 4)), np.zeros((S.N, 4)), S.vals,
                              device="cpu")
    rec = harness.benchmark_algorithm(cs.S, "15d_fusion2", None, fused=True,
                                      R=4, trials=2, device="cpu")
    assert rec["algorithm"] == "15d_fusion2" and rec["device"] == "cpu"
    assert rec["overall_throughput"] > 0 and rec["num_trials"] == 2
    assert rec["metrics"]["fusedSpMM"]["calls"] == 2
    assert rec["alg_info"]["nnz"] == S.nnz
