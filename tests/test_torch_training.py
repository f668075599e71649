"""Gradients through the port's strategies (``ops/autograd.py``) and GAT
training, against the JAX package's ``jax.grad`` (``tests/test_training.py``).

Every tile op of the port's tile kernels is a ``torch.autograd.Function``
whose backward ports the JAX custom VJPs' formulas; on the CPU its forward
and its SDDMM- and SpMM-shaped backward terms run the kernels' plain
versions. The same seeded numpy operands go through both packages; grads
come back in host order (``host_a``, ``host_b``, ``gather_s_values``), so
pad slots, whose value grads the two packages' tile layouts place
differently, never enter a comparison. Tolerance: the JAX test's, 1e-5 of
``max|x| + 1`` of the JAX grad. The JAX side runs its ``XlaKernel`` and its
``PallasKernel(precision="f32", interpret=True)``, on its forced 8-device
CPU mesh; the 3 x 3 Cannon grids (p = 9, more ranks than that mesh) are
held against the JAX strategy at p = 1. GAT training: 8 SGD steps at lr
0.02 from the JAX GAT's weights, losses step by step within 1e-4
relative (float32 sums in other orders, compounded over the steps).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from distributed_sddmm_tpu.common import KernelMode as JaxKM
from distributed_sddmm_tpu.common import MatMode as JaxMM
from distributed_sddmm_tpu.models.gat import GAT as JaxGAT
from distributed_sddmm_tpu.models.gat import GATLayer as JaxLayer
from distributed_sddmm_tpu.ops.kernels import XlaKernel
from distributed_sddmm_tpu.ops.pallas_kernels import PallasKernel
from distributed_sddmm_tpu.parallel.cannon_dense_25d import CannonDense25D as JaxCD
from distributed_sddmm_tpu.parallel.cannon_sparse_25d import CannonSparse25D as JaxCS
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.parallel.sparse_shift_15d import SparseShift15D as JaxSS
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel, banded, variant_from_id
from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.models.gat import GAT, GATLayer
from distributed_sddmm_tpu_torch.ops import autograd as tile_autograd
from distributed_sddmm_tpu_torch.ops import cuda_kernels
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.comm import DistWorld, LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.mesh import AXES
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.interop import gat_weights_from_reference

R = 8
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-4
PAIRS = {"dense_shift": (JaxDS, DenseShift15D), "sparse_shift": (JaxSS, SparseShift15D),
         "cannon_dense": (JaxCD, CannonDense25D), "cannon_sparse": (JaxCS, CannonSparse25D)}
#: The grid of each strategy in ``tests/test_training.py`` / ``tests/test_als.py``.
GRIDS = {"dense_shift": (8, 2), "sparse_shift": (8, 2), "cannon_dense": (8, 2),
         "cannon_sparse": (8, 2)}
_JAX_GRADS: dict = {}


def _problem():
    """``tests/test_training.py``'s matrix: ER 120 x 100, 4 a row, normal
    values."""
    return JaxCOO.erdos_renyi(120, 100, 4, seed=0, values="normal")


def _hub(seed=4):
    """A skewed matrix (the Graph500 R-mat's shape at a size where every
    band fills at ``v1.rb4.rs``): a one-nonzero tail, mid rows of 12,
    heavy rows of 60-90 slots and two hub columns of 64 rows each."""
    rng = np.random.default_rng(seed)
    M, N = 128, 96
    parts = [(np.arange(M), rng.integers(0, N, M))]
    parts += [(np.full(12, r), rng.choice(N, 12, replace=False)) for r in range(10, 30)]
    parts += [(np.full(n, r), rng.choice(N, n, replace=False))
              for r, n in ((40, 60), (41, 80), (70, 90), (100, 70))]
    parts += [(np.arange(0, M, 2), np.full(M // 2, 5)), (np.arange(1, M, 2), np.full(M // 2, 50))]
    rows = np.concatenate([q[0] for q in parts])
    cols = np.concatenate([q[1] for q in parts])
    _, idx = np.unique(rows * N + cols, return_index=True)
    idx.sort()
    return JaxCOO(rows[idx], cols[idx], np.ones(idx.size, np.float32), M, N)


def _operands(S, R=R, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S.M, R)).astype(np.float32),
            rng.standard_normal((S.N, R)).astype(np.float32),
            rng.standard_normal(S.nnz).astype(np.float32))


def _loss(alg, A, B, v, op, KM, MM):
    """``sum(out^2) + sum(mid)`` of the fused pair, or ``sum(x^2)`` of one
    op, with the shifts the strategy asks for (either package)."""
    if op == "spmm":
        z, b = alg.initial_shift(alg.like_a_matrix(0.0), B, KM.SPMM_A)
        out = alg.de_shift(alg.spmm_a(z, b, v), None, KM.SPMM_A)[0]
        return (out * out).sum()
    a, b = alg.initial_shift(A, B, KM.SDDMM_A)
    if op == "sddmm":
        mid = alg.sddmm_a(a, b, v)
        return (mid * mid).sum()
    out, mid = alg.fused_spmm(a, b, v, MM.A)
    out = alg.de_shift(out, None, KM.SPMM_A)[0]
    return (out * out).sum() + mid.sum()


def jax_grads(name, S, p, c, op="fused", kernel="xla", R=R):
    """``(gA, gB, g_sv)`` in host order from ``jax.grad``, computed once a
    test process."""
    key = (name, id(S), p, c, op, kernel, R)
    if key not in _JAX_GRADS:
        k = XlaKernel() if kernel == "xla" else PallasKernel(precision="f32", interpret=True)
        alg = PAIRS[name][0](S, R=R, c=c, kernel=k, devices=jax.devices()[:p])
        A_np, B_np, v_np = _operands(S, R)
        A, B, sv = alg.put_a(A_np), alg.put_b(B_np), alg.scatter_s_values(v_np)
        g = jax.grad(lambda A, B, v: _loss(alg, A, B, v, op, JaxKM, JaxMM),
                     argnums=(0, 1, 2))(A, B, sv)
        _JAX_GRADS[key] = (S, (alg.host_a(g[0]), alg.host_b(g[1]), alg.gather_s_values(g[2])))
    return _JAX_GRADS[key][1]


def port_grads(name, S, p, c, op="fused", kernel=None, R=R):
    alg = PAIRS[name][1](HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=R, c=c,
                         world=LocalWorld(p), kernel=kernel, device="cpu")
    A_np, B_np, v_np = _operands(S, R)
    A = alg.put_a(A_np).requires_grad_()
    B = alg.put_b(B_np).requires_grad_()
    sv = alg.scatter_s_values(v_np).requires_grad_()
    _loss(alg, A, B, sv, op, KernelMode, MatMode).backward()
    grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in (A, B, sv)]
    return alg, (alg.host_a(grads[0]), alg.host_b(grads[1]), alg.gather_s_values(grads[2]))


def _close(got, want, what):
    for name, x, y in zip(("gA", "gB", "g_sv"), want, got):
        scale = float(np.abs(x).max()) + 1
        np.testing.assert_allclose(y / scale, x / scale, atol=GRAD_TOL,
                                   err_msg=f"{what} {name}")


# ------------------------------------------------------------- gradients


def test_grad_matches_numerical():
    """``tests/test_training.py::test_grad_matches_numerical`` on the port's
    dense shift at (8, 2): central differences of the float32 loss."""
    S = _problem()
    alg = DenseShift15D(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=R, c=2,
                        world=LocalWorld(8), device="cpu")
    A_np, B_np, _ = _operands(S)
    sv = alg.like_s_values(1.0)

    def loss(A):
        return _loss(alg, A, alg.put_b(B_np), sv, "fused", KernelMode, MatMode)

    A = alg.put_a(A_np).requires_grad_()
    loss(A).backward()
    gA = alg.host_a(A.grad)
    eps = 1e-2
    for i, j in [(0, 0), (17, 3)]:
        Ap, Am = A_np.copy(), A_np.copy()
        Ap[i, j] += eps
        Am[i, j] -= eps
        with torch.no_grad():
            num = (float(loss(alg.put_a(Ap))) - float(loss(alg.put_a(Am)))) / (2 * eps)
        assert abs(gA[i, j] - num) / (abs(num) + 1) < 5e-2, (gA[i, j], num)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_fused_pair_grads_match_jax_dense_shift(kernel):
    """The fused pair's ``(gA, gB, g_sv)`` at (8, 2) against the JAX
    package's through its XLA kernel and its Pallas kernel (interpret)."""
    S = _problem()
    want = jax_grads("dense_shift", S, 8, 2, kernel=kernel)
    alg, got = port_grads("dense_shift", S, 8, 2)
    _close(got, want, f"dense shift vs jax {kernel}")


@pytest.mark.parametrize("name", ["sparse_shift", "cannon_dense", "cannon_sparse"])
def test_fused_pair_grads_match_jax_r_split(name):
    """Each R-split strategy at its ``tests/test_als.py`` grid, with its
    shifts around the ops: the tile moves round the ring (sparse shift,
    Cannon dense), Cannon dense swaps its CSR and operands."""
    S = _problem()
    p, c = GRIDS[name]
    _close(port_grads(name, S, p, c)[1], jax_grads(name, S, p, c), name)


@pytest.mark.parametrize("name", ["cannon_dense", "cannon_sparse"])
def test_fused_pair_grads_on_a_three_by_three_grid(name):
    """p = 9 (3 x 3, c = 1, R = 12 so that 3 splits it), where a skew's
    direction shows (on a 2 x 2 grid each skew is its own inverse), against
    the JAX strategy at p = 1."""
    S = _problem()
    _close(port_grads(name, S, 9, 1, R=12)[1], jax_grads(name, S, 1, 1, R=12),
           f"{name} 3x3")


@pytest.mark.parametrize("op", ["sddmm", "spmm"])
@pytest.mark.parametrize("name", list(PAIRS))
def test_single_op_grads_match_jax(name, op):
    """The SDDMM and the SpMM alone (``test_pallas_unfused_op_grads``),
    every strategy at its grid."""
    S = _problem()
    p, c = GRIDS[name]
    _close(port_grads(name, S, p, c, op=op)[1], jax_grads(name, S, p, c, op=op),
           f"{name} {op}")


@pytest.mark.parametrize("name,p", [("dense_shift", 1), ("sparse_shift", 4),
                                    ("cannon_dense", 4)])
def test_banked_grads_match_jax(name, p, monkeypatch):
    """The banked kernel (``v1.rb4.rs`` on a skewed matrix, heavy rows cut
    at 3 slots so that pass 1 and pass 2 both run), forward and backward:
    grads equal JAX's, and the generic kernel's within the tolerance."""
    monkeypatch.setattr(banded, "SPLIT", 3)
    S = _hub()
    kernel = BankedCudaKernel(variant_from_id("v1.rb4.rs"), "f32", device="cpu")
    alg, got = port_grads(name, S, p, 1, kernel=kernel)
    tiles = alg.ST_tiles if name == "cannon_dense" else alg.S_tiles
    bands = [b for h in range(p) for b in tiles.tile(h, 0).bands]
    assert alg.kernel_variant_realized == "v1.rb4.rs" and any(b.heavy for b in bands)
    _close(got, jax_grads(name, S, p, 1), f"{name} banked")
    _close(got, port_grads(name, S, p, 1)[1], f"{name} banked vs generic")


def test_backward_runs_the_tile_ops_of_the_design(monkeypatch):
    """At p = 1 the fused pair's backward is two SDDMM calls and one SpMM
    call of the kernel object on float32 operands (bf16 forward); a call
    that asks for no grad does not build the graph; the flat protocol is
    differentiable by construction and equals the tile kernel's grads."""
    S = _problem()
    calls = []
    for op in ("sddmm_tile", "spmm_tile", "fused_tile"):
        real = getattr(cuda_kernels.CudaTileKernel, op)

        def spy(self, tile, *args, _op=op, _real=real):
            calls.append((_op, tuple(a.dtype for a in args[1:])))
            return _real(self, tile, *args)

        monkeypatch.setattr(cuda_kernels.CudaTileKernel, op, spy)
    kern = cuda_kernels.CudaTileKernel("bf16", device="cpu")
    alg, got = port_grads("dense_shift", S, 1, 1, kernel=kern)
    assert calls == [("fused_tile", (torch.bfloat16, torch.bfloat16)),
                     ("sddmm_tile", (torch.float32, torch.float32)),
                     ("sddmm_tile", (torch.float32, torch.float32)),
                     ("spmm_tile", (torch.float32,))]
    A = alg.put_a(_operands(S)[0]).requires_grad_()
    with torch.no_grad():
        out, _ = alg.fused_spmm(A, alg.put_b(_operands(S)[1]), alg.like_s_values(1.0))
    assert out.grad_fn is None
    monkeypatch.undo()
    _, flat = port_grads("dense_shift", S, 1, 1, kernel=TorchKernel())
    _, tiled = port_grads("dense_shift", S, 1, 1)
    _close(flat, tiled, "flat vs tile")
    assert issubclass(tile_autograd.FusedTile, torch.autograd.Function)


def test_dist_world_refuses_grads(tmp_path):
    """A strategy on a ``DistWorld`` asked for a grad raises (its
    collectives are not differentiable); without one it runs."""
    S = _problem()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        alg = DenseShift15D(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=R,
                            world=DistWorld(), device="cpu")
        A_np, B_np, _ = _operands(S)
        A, B = alg.put_a(A_np), alg.put_b(B_np)
        out, _ = alg.fused_spmm(A, B, alg.like_s_values(1.0))
        assert out.shape == A.shape and out.grad_fn is None
        with pytest.raises(NotImplementedError, match="queue A item 18"):
            alg.fused_spmm(A.requires_grad_(), B, alg.like_s_values(1.0))
        with pytest.raises(NotImplementedError, match="DistWorld"):
            alg.comm.all_reduce([torch.ones(3, requires_grad=True)], AXES)
        with torch.no_grad():
            assert alg.comm.all_reduce([torch.ones(3, requires_grad=True)], AXES)[0].sum() == 3
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- GAT training


def _train_jax(loss_fn, weights, steps=8, lr=0.02):
    losses = []
    for _ in range(steps):
        value, g = jax.value_and_grad(loss_fn)(weights)
        weights = tuple(w - lr * gw for w, gw in zip(weights, g))
        losses.append(float(value))
    return losses + [float(loss_fn(weights))]


def _train_port(loss_fn, weights, steps=8, lr=0.02):
    losses = []
    for _ in range(steps):
        value = loss_fn(weights)
        g = torch.autograd.grad(value, weights)
        weights = tuple((w - lr * gw).detach().requires_grad_() for w, gw in zip(weights, g))
        losses.append(float(value.detach()))
    with torch.no_grad():
        return losses + [float(loss_fn(weights))]


@pytest.mark.parametrize("name,p,c", [("dense_shift", 1, 1), ("sparse_shift", 8, 2),
                                      ("cannon_dense", 8, 2), ("cannon_sparse", 8, 2)])
def test_gat_training_matches_jax(name, p, c):
    """``test_gat_loss_decreases`` in both packages from the JAX GAT's
    weights: one layer of 2 heads of 8 features, MSE against a fixed
    N(0, 0.1) target, 8 plain SGD steps at lr 0.02; the losses agree step
    by step and the last is below 0.9 x the first."""
    S = JaxCOO.erdos_renyi(64, 64, 4, seed=2)
    jcls, pcls = PAIRS[name]
    ja = jcls(S, R=8, c=c, devices=jax.devices()[:p])
    jgat = JaxGAT([JaxLayer(input_features=8, features_per_head=8, num_heads=2)], ja)
    rng = np.random.default_rng(0)
    X_np = rng.standard_normal((S.M, 8)).astype(np.float32)
    T_np = rng.standard_normal((S.M, 16)).astype(np.float32) * 0.1
    ja.set_r_value(8)
    jX = ja.put_a(X_np)
    ja.set_r_value(16)
    jT = ja.put_a(T_np)

    def jax_loss(weights):
        jgat.layers[0].weights = list(weights)
        return jnp.mean((jgat.forward(jX) - jT) ** 2)

    start = [np.asarray(w) for w in jgat.layers[0].weights]
    want = _train_jax(jax_loss, tuple(jgat.layers[0].weights))

    alg = pcls(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=8, c=c, world=LocalWorld(p),
               device="cpu")
    gat = GAT([GATLayer(input_features=8, features_per_head=8, num_heads=2)], alg)
    alg.set_r_value(8)
    X = alg.put_a(X_np)
    alg.set_r_value(16)
    T = alg.put_a(T_np)

    def loss(weights):
        gat.layers[0].weights = list(weights)
        return torch.mean((gat.forward(X) - T) ** 2)

    weights = tuple(w.requires_grad_() for w in gat_weights_from_reference([start], "cpu")[0])
    got = _train_port(loss, weights)
    assert np.isfinite(got).all(), got
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < 0.9 * got[0], got
