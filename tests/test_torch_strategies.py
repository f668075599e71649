"""The four strategies together: every grid (including 3 x 3 Cannon grids,
which the JAX package's 8-device mesh cannot hold) equal, bit for bit on
integer data, to ``DenseShift15D`` on one rank; the verify fingerprints
and the communication profiles of the three R-split strategies equal to
the JAX package's; and the apps on 3 x 3 grids (ALS half-steps and the
GAT forward pass, on their per-op paths) equal to the dense shift's on
one rank."""

import numpy as np
import pytest

import jax

from distributed_sddmm_tpu.parallel.cannon_dense_25d import CannonDense25D as JaxCD
from distributed_sddmm_tpu.parallel.cannon_sparse_25d import CannonSparse25D as JaxCS
from distributed_sddmm_tpu.parallel.sparse_shift_15d import SparseShift15D as JaxSS
from distributed_sddmm_tpu.utils import verify as jax_verify
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from _torch_strategy_cases import data, port_coo, run_ops

from distributed_sddmm_tpu_torch.bench import harness
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.models.gat import GAT, GATLayer
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.utils import verify

R = 12  # divisible by every R-split width below
GRIDS = {
    "15d_sparse": [(3, 1), (4, 2), (6, 2), (9, 3)],
    "25d_dense_replicate": [(1, 1), (4, 1), (8, 2), (9, 1), (18, 2)],
    "25d_sparse_replicate": [(4, 1), (8, 2), (9, 1), (18, 2)],
}
JAX_CLASSES = {"15d_sparse": JaxSS, "25d_dense_replicate": JaxCD,
               "25d_sparse_replicate": JaxCS}
_BASE: dict = {}


def _matrix():
    return JaxCOO.rmat(log_m=7, edge_factor=6, seed=4)


def _base():
    if not _BASE:
        S = _matrix()
        _BASE["ops"] = data(S, R, "int", seed=11)
        _BASE["out"] = run_ops(DenseShift15D(port_coo(S), R, world=LocalWorld(1),
                                             device="cpu"), *_BASE["ops"])
    return _BASE["ops"], _BASE["out"]


@pytest.mark.parametrize("name,p,c", [(n, p, c) for n, grids in GRIDS.items()
                                      for p, c in grids])
def test_grids_equal_one_rank(name, p, c):
    """Every op in A and B modes on operands of small integers: the same
    bits as ``DenseShift15D`` on one rank (M = 128 pads to a multiple of
    every grid; p = 9 and 18 give 3 x 3 grids, where Cannon's skew and
    the transpose shift are no longer their own inverse). The Cannon
    strategies' spmmA adds its rotating output's initial content."""
    ops, want = _base()
    alg = harness.make_algorithm(name, port_coo(_matrix()), R, c=c, world=LocalWorld(p),
                                 kernel=CudaTileKernel("f32", device="cpu"), device="cpu")
    got = run_ops(alg, *ops)
    if name.startswith("25d"):
        want = dict(want, spmmA_base=ops[0] + want["spmmA"])
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=f"{name} ({p},{c}) {op}")


@pytest.mark.parametrize("name,c", [("15d_sparse", 2), ("15d_sparse", 8),
                                    ("25d_dense_replicate", 2), ("25d_dense_replicate", 8),
                                    ("25d_sparse_replicate", 2)])
def test_verify_fingerprints_agree_with_jax(name, c):
    """The verify protocol at p = 8 against the JAX package's (rtol 1e-5)
    and the float64 oracle (1e-4, the verify tolerance)."""
    S = _matrix()
    want = jax_verify.fingerprint_algorithm(
        JAX_CLASSES[name](S, R=8, c=c, devices=jax.devices()), S)
    alg = harness.make_algorithm(name, port_coo(S), 8, c=c, world=LocalWorld(8),
                                 device="cpu")
    got = verify.fingerprint_algorithm(alg, port_coo(S))
    oracle = verify.oracle_fingerprints(port_coo(S), 8)
    assert set(got) == set(want) == set(oracle)
    for op in want:
        np.testing.assert_allclose(got[op], want[op], rtol=1e-5, err_msg=op)
        np.testing.assert_allclose(got[op], oracle[op], rtol=1e-4, err_msg=op)


@pytest.mark.parametrize("name,p,c", [("15d_sparse", 8, 2), ("15d_sparse", 4, 1),
                                      ("25d_dense_replicate", 8, 2),
                                      ("25d_dense_replicate", 4, 1),
                                      ("25d_sparse_replicate", 8, 2),
                                      ("25d_sparse_replicate", 8, 8)])
def test_comm_profile_equals_jax(name, p, c):
    """The JAX base's modeled entry (``tools/costmodel.py``): the same
    words and bytes for every op, at two widths."""
    S = _matrix()
    ja = JAX_CLASSES[name](S, R=8, c=c, devices=jax.devices()[:p])
    alg = harness.make_algorithm(name, port_coo(S), 8, c=c, world=LocalWorld(p),
                                 device="cpu")
    ops = ("fusedSpMM", "fusedSpMMB", "fusedAttn", "sddmmA", "sddmmB", "spmmA", "spmmB",
           "cgStep", "gatLayer", "other")
    for width in (8, 16):
        alg.set_r_value(width)
        ja.set_r_value(width)
        for op in ops:
            assert alg.comm_profile(op, pairs=3) == ja.comm_profile(op, pairs=3), (op, width)
    assert alg.comm_profile("fusedSpMM")[0]["words"] > 0


@pytest.mark.parametrize("name,p,c", [("15d_sparse", 9, 3), ("25d_dense_replicate", 9, 1),
                                      ("25d_sparse_replicate", 9, 1)])
def test_apps_on_three_by_three_grids_equal_one_rank(name, p, c):
    """ALS and GAT run on the other three strategies through the public
    ops (no ``cgStep`` or ``gatLayer`` unit) with their shifts and, for
    ALS, the R-split dots: at p = 9, where a wrong skew direction or a
    row's dot summed once per holder shows, an ALS step from the same
    state and a two-layer GAT forward from the same weights equal the
    dense shift's on one rank within float32 rounding (1e-5 of the max
    abs value)."""
    S = JaxCOO.erdos_renyi(63, 63, 4, seed=1)
    one = DenseShift15D(port_coo(S), R, world=LocalWorld(1), device="cpu")
    alg = harness.make_algorithm(name, port_coo(S), R, c=c, world=LocalWorld(p),
                                 device="cpu")
    factors = []
    for a in (one, alg):
        als = DistributedALS(a, seed=2)
        assert als._unit == (a is one)
        als.run_cg(1, cg_iters=4)
        factors.append((a.host_a(als.A), a.host_b(als.B)))
    for want, got in zip(*factors):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    outs = []
    for a in (one, alg):
        gat = GAT([GATLayer(R, 6, 2), GATLayer(R, 6, 2)], a, seed=4)
        outs.append(a.host_a(gat.forward()))
    assert set(alg.metrics) >= {"sddmmA", "spmmA"} and "gatLayer" not in alg.metrics
    assert np.abs(outs[1] - outs[0]).max() <= 1e-5 * np.abs(outs[0]).max()
