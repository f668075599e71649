"""The slice as a whole: the port's ``DenseShift15D`` against the JAX
package's, with ``PallasKernel(interpret=True, precision="f32")`` on one
device (p = c = 1), and at p > 1 over a ``LocalWorld`` against the JAX
package on as many devices of its forced CPU mesh (its default XLA kernel;
one case through the Pallas kernel in interpret mode).

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
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
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


def _run_port(S, R, fusion, state, kernel=None, p=1, c=1, overlap=False):
    cs = state_from_reference(S.rows, S.cols, S.vals, S.M, S.N, *state,
                              device="cpu")
    alg = DenseShift15D(cs.S, R=R, c=c, fusion_approach=fusion, kernel=kernel,
                        overlap=overlap, world=LocalWorld(p), device="cpu")
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
    """The grid must split: c | p (the JAX package's ValueError), and
    fusion 3 is refused. Every strategy of the JAX package is ported
    (``NOT_PORTED`` is empty): each name builds, and an unknown one is
    refused with the JAX package's text."""
    S = JaxCOO.erdos_renyi(16, 16, 2, seed=0)
    cs = state_from_reference(S.rows, S.cols, S.vals, 16, 16, np.zeros((16, 2)),
                              np.zeros((16, 2)), S.vals, device="cpu")
    with pytest.raises(ValueError, match=r"requires c \| p \(p=4, c=3\)"):
        DenseShift15D(cs.S, R=2, c=3, world=LocalWorld(4), device="cpu")
    with pytest.raises(ValueError, match=r"requires c \| p"):
        JaxDS(S, R=2, c=3, devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        DenseShift15D(cs.S, R=2, fusion_approach=3, device="cpu")
    assert harness.NOT_PORTED == ()
    for name in harness.ALGORITHM_FACTORIES:
        alg = harness.make_algorithm(name, cs.S, 2, device="cpu")
        assert alg.p == 1 and alg.S_tiles.nnz == S.nnz, name
    with pytest.raises(ValueError, match=r"unknown algorithm 'nope'; available: \['15d_f"):
        harness.make_algorithm("nope", cs.S, 2, device="cpu")


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
    assert (rec["num_processes"], rec["process_index"]) == (1, 0)
    assert rec["fusion"] == "sequential" and rec["alg_info"]["adjacency_mode"] == 1
    rec = harness.benchmark_algorithm(cs.S, "15d_fusion1", None, fused=True, R=4, c=2,
                                      trials=1, device="cpu", world=LocalWorld(4),
                                      overlap=True, breakdown=True)
    assert rec["fusion"] == "overlap" and rec["alg_info"]["p"] == 4
    assert set(rec["perf_stats"]) == {"fusedSpMM", "replication", "ppermute",
                                      "fusedSpMM_total"}
    for app, fused in (("attention", True), ("vanilla", False)):
        with pytest.raises(ValueError, match="--breakdown requires"):
            harness.benchmark_algorithm(cs.S, "15d_fusion2", None, fused=fused, R=4,
                                        app=app, device="cpu", breakdown=True)


# ------------------------------------------------------------- p > 1

GRIDS = [(2, 1), (2, 2), (4, 1), (4, 2), (8, 2), (8, 4)]
_JAX_ALGS: dict = {}


def _multi_matrix():
    return JaxCOO.rmat(log_m=7, edge_factor=6, seed=11)


def _jax_multi(p, c, fusion, kernel=None):
    """The JAX strategy on ``p`` devices of the forced CPU mesh, kept for
    the module: its programs compile once per configuration."""
    key = (p, c, fusion, kernel is None)
    if key not in _JAX_ALGS:
        _JAX_ALGS[key] = JaxDS(_multi_matrix(), R=8, c=c, fusion_approach=fusion,
                               kernel=kernel, devices=jax.devices()[:p])
    return _JAX_ALGS[key]


def _compare(got, want, kind):
    assert set(got) == set(want)
    for op in want:
        assert got[op].shape == want[op].shape, op
        if kind == "int":
            np.testing.assert_array_equal(got[op], want[op], err_msg=op)
        else:
            scale = float(np.abs(want[op]).max())
            assert np.abs(got[op] - want[op]).max() <= 1e-5 * scale, op


@pytest.mark.parametrize("p,c", GRIDS)
def test_ops_match_jax_at_p_ranks(p, c):
    """Every op, A and B modes, fusion 1 and 2, sequential and overlapped,
    against the JAX package at the same (p, c): bit for bit on integer
    data, within 1e-5 of the largest magnitude on normal data."""
    S = _multi_matrix()
    for kind in ("int", "normal"):
        want, state = _run_jax(_jax_multi(p, c, 2), S, *_data(S, 8, kind, seed=p + c))
        fused1, _ = _run_jax(_jax_multi(p, c, 1), S, *_data(S, 8, kind, seed=p + c))
        for fusion in (1, 2):
            ref = dict(want, **{k: v for k, v in fused1.items() if k.startswith("fused")}
                       ) if fusion == 1 else want
            for overlap in (False, True):
                got = _run_port(S, 8, fusion, state, CudaTileKernel("f32", device="cpu"),
                                p=p, c=c, overlap=overlap)
                _compare(got, ref, kind)
        flat = _run_port(S, 8, 2, state, TorchKernel(), p=p, c=c)
        _compare(flat, want, kind)


def test_ops_match_jax_pallas_at_p_ranks():
    """The one case through the JAX package's Pallas kernels (interpret
    mode) at p > 1: (p, c) = (4, 2), fusion 2, integer data."""
    S = _multi_matrix()
    ja = _jax_multi(4, 2, 2, PallasKernel(interpret=True, precision="f32"))
    want, state = _run_jax(ja, S, *_data(S, 8, "int", seed=42))
    for overlap in (False, True):
        got = _run_port(S, 8, 2, state, p=4, c=2, overlap=overlap)
        _compare(got, want, "int")


@pytest.mark.parametrize("p,c", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (8, 1), (8, 2)])
def test_verify_fingerprints_agree_at_p_ranks(p, c):
    S = _multi_matrix()
    want = jax_verify.fingerprint_algorithm(_jax_multi(p, c, 2), S)
    oracle = verify.oracle_fingerprints(S, 8)
    for fusion in (1, 2):
        alg = harness.make_algorithm(f"15d_fusion{fusion}", S, 8, c=c,
                                     world=LocalWorld(p), device="cpu")
        assert alg.p == p and alg.grid.dims == (p // c, c, 1)
        got = verify.fingerprint_algorithm(alg, S)
        for op in want:
            np.testing.assert_allclose(got[op], want[op], rtol=1e-5, err_msg=op)
            np.testing.assert_allclose(got[op], oracle[op], rtol=1e-4, err_msg=op)


class _CountingKernel(CudaTileKernel):
    """The bf16 tile kernel, counting its ``prep`` casts."""

    preps = 0

    def prep(self, X):
        _CountingKernel.preps += 1
        return super().prep(X)


def test_bf16_ring_prepares_each_moving_block_once():
    """The ring carries each rank's moving block in the kernel's type,
    cast once before the ring: the result equals, bit for bit, a ring that
    hops the float32 block and casts it at every step (written out here
    from the layout: at step s rank (i, j) holds the block of rank
    ((i - s) mod nr, j))."""
    S, (p, c) = _multi_matrix(), (4, 2)
    nr = p // c
    A, B, v = _data(S, 8, "normal", seed=9)
    k = _CountingKernel("bf16", device="cpu")
    alg = DenseShift15D(S, R=8, c=c, kernel=k, world=LocalWorld(p), device="cpu")
    At, Bt, sv = alg.put_a(A), alg.put_b(B), alg.scatter_s_values(v)
    _CountingKernel.preps = 0
    out, mid = alg.fused_spmm(At, Bt, sv)
    # One moving block a rank, one stationary frame a grid row (its c
    # ranks share the gathered frame).
    assert _CountingKernel.preps == p + nr
    la, lb = alg.localArows, alg.localBrows
    want_out = torch.zeros_like(out)
    for h, (i, j, _) in enumerate(alg.comm.coords):
        at = k.prep(At[i * c * la:(i + 1) * c * la])
        acc = None
        for s in range(nr):
            b = ((i - s) % nr) * c + j
            part, m = k.fused_tile(alg.S_tiles.tile(h, s), sv[h, s], at,
                                   k.prep(Bt[b * lb:(b + 1) * lb]))
            assert torch.equal(m, mid[h, s])
            acc = part if acc is None else acc + part
        for jj in range(c):
            blk = (i * c + jj) * la
            want_out[blk:blk + la] += acc[jj * la:(jj + 1) * la]
    assert torch.equal(out, want_out)


def test_comm_profile_equals_jax():
    """Word counts are the JAX package's; bytes are float32 but the
    ring's, which moves the blocks in the kernel's type."""
    S = _multi_matrix()
    ja = _jax_multi(4, 2, 2)
    ops = ("fusedSpMM", "fusedSpMMB", "fusedAttn", "fusedAttnB", "sddmmA",
           "sddmmB", "spmmA", "spmmB", "other")
    for prec, ring_bytes in (("f32", 4), ("bf16", 2)):
        alg = DenseShift15D(S, R=8, c=2, kernel=CudaTileKernel(prec, device="cpu"),
                            world=LocalWorld(4), device="cpu")
        for op in ops:
            got, want = alg.comm_profile(op, pairs=3), ja.comm_profile(op, pairs=3)
            assert len(got) == len(want), op
            for g, w in zip(got, want):
                for key in ("collective", "axis", "count", "words", "in_model"):
                    assert g[key] == w[key], (op, key)
                width = ring_bytes if g["collective"] == "ppermute" else 4
                assert g["bytes"] == g["words"] * width == (
                    w["bytes"] * width // 4), (op, g)


def test_dense_blocks_are_views_of_the_global_operand():
    """A rank's dense block is rows ``[(i * c + j) * localArows, ...)`` of
    the global operand (the JAX package's ``P(("rows", "cols"))``)."""
    S = _multi_matrix()
    alg = DenseShift15D(S, R=8, c=2, world=LocalWorld(8), adjacency=3, device="cpu")
    A = alg.dummy_initialize(MatMode.A)
    assert alg.blocks == list(range(8))
    for (i, j, _), blk in zip(alg.comm.coords, alg._blocks(A, MatMode.A)):
        b = i * 2 + j
        assert blk.data_ptr() == A[b * alg.localArows:].data_ptr()
    info = alg.json_algorithm_info()
    assert info["adjacency_mode"] == 3 and info["dim_values"] == [4, 2]
    assert info["p"] == 8 and len(info["nnz_procs"]) == 8
