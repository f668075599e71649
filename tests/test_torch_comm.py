"""The comm layer (``parallel/comm.py``): ``LocalWorld``'s collectives as
list operations, and ``DistWorld`` over four gloo processes equal to
``LocalWorld`` bit for bit.

The four processes are spawned once (``torch.multiprocessing``, a
``file://`` rendezvous under the test's ``tmp_path``, so parallel test
workers never share an address). In them every collective, for two
adjacencies and every axis, and ``GridSpec.self_test`` are held against a
``LocalWorld`` of the same grid; then the verify protocol runs at (p, c)
= (4, 1) and (4, 2), fusion 2, sequential and overlapped, and its
fingerprints must equal ``LocalWorld``'s exactly. Exact equality holds for
these sums: the operands of the collectives are small integers, and the
reductions of the verify run add two partials (c = 2), which commute.
A second spawn runs ALS with a checkpoint store at (4, 2) and resumes it.
A third runs the R-split strategies on four processes: ``CannonDense25D``
(2 x 2, generic and banked, whose moving tiles travel packed and take their
bands from the host banding), ``SparseShift15D`` (sequential and
overlapped) and ``CannonSparse25D`` (2 x 2, and 1 x 1 x 4, whose fiber
gather and reduce-scatter cross processes): every op on integer operands
equal to ``LocalWorld``'s bit for bit. A fourth runs an ALS step on each
R-split strategy, whose CG dots are all-reduced over the R-split group
(``batch_dot``), stores it and resumes it, against a ``LocalWorld``
within float32 rounding (the partial dots add in another order).

This module imports no JAX: the spawned processes import it to find
their entry point.
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_sddmm_tpu_torch.autotune import PlanCache, Problem, get_plan
from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel
from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.models.gat import GAT, GATLayer
from distributed_sddmm_tpu_torch.parallel import comm as comm_mod
from distributed_sddmm_tpu_torch.parallel.comm import (
    DistWorld, LocalWorld, backend_for, world_from_env,
)
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.mesh import make_grid
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.parallel.wire import WirePolicy
from distributed_sddmm_tpu_torch.resilience import CheckpointStore
from distributed_sddmm_tpu_torch.utils import verify
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

AXES = ("rows", "cols", ("rows", "cols"), ("cols", "rows"), "layers",
        ("rows", "layers"), ("cols", "layers"))
VERIFY = [(1, False), (2, False), (2, True)]  # (c, overlap) at p = 4


def _blocks(n, seed, shape=(4, 3)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
            for _ in range(n)]


def _matrix():
    return HostCOO.rmat(7, 6, seed=3)


def spawn(worker, tmp_path, *args, timeout: float = 240) -> None:
    """Run ``worker(rank, init, out_dir, *args)`` in four processes (a
    ``file://`` rendezvous under ``tmp_path``); a process that has not
    finished after ``timeout`` seconds fails the test instead of hanging
    it, and one that exits non-zero raises."""
    ctx = mp.spawn(worker, args=(str(tmp_path / "init"), str(tmp_path), *args), nprocs=4,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the gloo processes did not finish in {timeout:.0f} s")


def _worker(rank: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=4)
    res = {}
    try:
        for adjacency in (1, 3):
            for dims in ((2, 2, 1), (4, 1, 1)):
                grid = make_grid(*dims, adjacency=adjacency)
                dc = DistWorld().comm(grid, "cpu")
                lc = LocalWorld(4).comm(grid, "cpu")
                h = lc.coords.index(dc.coords[0])
                xs = _blocks(4, seed=adjacency)
                ok = {"coords": dc.ranks == [rank] and lc.ranks[h] == rank,
                      "self_test": grid.self_test(dc)}
                for axis in AXES:
                    n = int(np.prod([grid.dims[("rows", "cols", "layers").index(a)]
                                     for a in ((axis,) if isinstance(axis, str) else axis)]))
                    big = _blocks(4, seed=7, shape=(2 * n, 3))
                    tag = "/".join((axis,) if isinstance(axis, str) else axis)
                    ok[f"gather {tag}"] = torch.equal(dc.all_gather([xs[h]], axis)[0],
                                                      lc.all_gather(xs, axis)[h])
                    ok[f"scatter {tag}"] = torch.equal(dc.reduce_scatter([big[h]], axis)[0],
                                                       lc.reduce_scatter(big, axis)[h])
                    for op in ("sum", "max"):
                        ok[f"{op} {tag}"] = torch.equal(dc.all_reduce([xs[h]], axis, op)[0],
                                                        lc.all_reduce(xs, axis, op)[h])
                for axis in ("rows", "cols"):
                    n = grid.dims[("rows", "cols").index(axis)]
                    for q, perm in enumerate(([(k, (k + 1) % n) for k in range(n)],
                                              [(0, n - 1)])):
                        ok[f"hop {axis} {q}"] = torch.equal(
                            dc.ppermute([xs[h]], axis, perm)[0], lc.ppermute(xs, axis, perm)[h])
                res[f"adjacency {adjacency} grid {dims}"] = ok
        S = _matrix()
        for c, overlap in VERIFY:
            alg = DenseShift15D(S, 8, c=c, overlap=overlap, world=DistWorld(), device="cpu")
            assert tuple(alg.S_tiles.rows.shape[:1]) == (1,)  # its own slot only
            res[f"verify c={c} overlap={overlap}"] = verify.fingerprint_algorithm(alg, S)
    finally:
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def test_dist_world_over_gloo_equals_local_world(tmp_path):
    spawn(_worker, tmp_path)
    S = _matrix()
    for rank in range(4):
        res = json.loads((tmp_path / f"rank{rank}.json").read_text())
        for where, checks in res.items():
            if where.startswith("verify"):
                continue
            assert len(checks) == 2 + 4 * len(AXES) + 4, where
            assert all(checks.values()), (rank, where,
                                          [k for k, v in checks.items() if not v])
        for c, overlap in VERIFY:
            want = verify.fingerprint_algorithm(
                DenseShift15D(S, 8, c=c, world=LocalWorld(4), device="cpu"), S)
            assert res[f"verify c={c} overlap={overlap}"] == want, (rank, c, overlap)


def _als_worker(rank: int, init: str, out_dir: str) -> None:
    """Two ALS steps at (4, 2) over gloo into a checkpoint store, then a
    fresh model resumed from it for a third step."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=4)
    try:
        alg = DenseShift15D(_matrix(), 8, c=2, world=DistWorld(), device="cpu")
        store = CheckpointStore(f"{out_dir}/ckpt")
        DistributedALS(alg, seed=0).run_cg(2, cg_iters=3, checkpoint=store)
        resumed = DistributedALS(alg, seed=0)
        resumed.run_cg(3, cg_iters=3, checkpoint=store, resume=True)
        np.save(f"{out_dir}/B{rank}.npy", resumed.item_factors())
    finally:
        dist.destroy_process_group()


def test_als_checkpoints_over_gloo(tmp_path):
    """Under a world of processes the factors are gathered, process 0 writes
    the JAX package's padded operands, and every process resumes from
    them: equal, bit for bit, to the same steps on a ``LocalWorld``."""
    spawn(_als_worker, tmp_path)
    alg = DenseShift15D(_matrix(), 8, c=2, world=LocalWorld(4), device="cpu")
    want = DistributedALS(alg, seed=0)
    want.run_cg(2, cg_iters=3)
    store = CheckpointStore(tmp_path / "ckpt")
    assert store.steps() == [1, 2, 3]
    two = store.load(2)
    assert np.array_equal(two["A"], want.A.numpy()) and np.array_equal(two["B"], want.B.numpy())
    want.run_cg(1, cg_iters=3)
    for rank in range(4):
        assert np.array_equal(np.load(tmp_path / f"B{rank}.npy"), want.item_factors()), rank


# R-split strategies at p = 4: (class, c, keyword arguments, banked).
STRATEGIES = (("cannon_dense", CannonDense25D, 1, {}, False),
              ("cannon_dense_banked", CannonDense25D, 1, {}, True),
              ("sparse_shift", SparseShift15D, 2, {}, False),
              ("sparse_shift_overlap", SparseShift15D, 1, {"overlap": True}, False),
              ("cannon_sparse", CannonSparse25D, 1, {}, False),
              ("cannon_sparse_fiber", CannonSparse25D, 4, {}, False))


def _strategy(cls, c, kw, banked, world):
    kernel = BankedCudaKernel("v1.rb2.rs", "f32", device="cpu") if banked else None
    return cls(_matrix(), 8, c=c, kernel=kernel, world=world, device="cpu", **kw)


def _int_outputs(alg) -> dict:
    """Every op on small-integer operands (``utils/verify.op_outputs``)."""
    S = _matrix()
    rng = np.random.default_rng(5)
    return verify.op_outputs(alg, rng.integers(-3, 4, (S.M, 8)).astype(np.float32),
                             rng.integers(-3, 4, (S.N, 8)).astype(np.float32),
                             rng.integers(-2, 3, S.nnz).astype(np.float32))


def _strategies_worker(rank: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=4)
    try:
        for name, cls, c, kw, banked in STRATEGIES:
            alg = _strategy(cls, c, kw, banked, DistWorld())
            np.savez(f"{out_dir}/{name}{rank}.npz", **_int_outputs(alg))
    finally:
        dist.destroy_process_group()


def test_r_split_strategies_over_gloo_equal_local_world(tmp_path):
    spawn(_strategies_worker, tmp_path)
    for name, cls, c, kw, banked in STRATEGIES:
        alg = _strategy(cls, c, kw, banked, LocalWorld(4))
        assert alg.kernel_variant_realized == ("v1.rb2.rs" if banked else None)
        want = _int_outputs(alg)
        for rank in range(4):
            got = np.load(tmp_path / f"{name}{rank}.npz")
            assert set(got.files) == set(want)
            for op in want:
                np.testing.assert_array_equal(got[op], want[op], err_msg=f"{name} {op} {rank}")


# The bf16 wire at p = 4: (name, class, c, policy); the dense shift's
# reduce-scatter sums two ranks' partials in bf16 under the override.
WIRE_STRATEGIES = (("dense_shift", DenseShift15D, 2, "bf16"),
                   ("dense_shift_reduce", DenseShift15D, 2,
                    WirePolicy("bf16", (("reduce", "bf16"),))),
                   ("sparse_shift", SparseShift15D, 2, "bf16"),
                   ("cannon_dense", CannonDense25D, 1, "bf16"),
                   ("cannon_sparse_fiber", CannonSparse25D, 4, "bf16"))


def _wire_worker(rank: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=4)
    try:
        for name, cls, c, policy in WIRE_STRATEGIES:
            alg = cls(_matrix(), 8, c=c, world=DistWorld(), device="cpu", wire=policy)
            np.savez(f"{out_dir}/wire_{name}{rank}.npz", **_int_outputs(alg))
        # Every process follows process 0's plan; process 0 alone stores it.
        plan = get_plan(Problem.from_coo(_matrix(), 8), DistWorld(), device="cpu",
                        mode="model", cache=PlanCache(f"{out_dir}/plans"))
        with open(f"{out_dir}/plan{rank}.json", "w") as f:
            json.dump(plan.to_dict(), f)
    finally:
        dist.destroy_process_group()


# R-split ALS at p = 4: (name, class, c).
ALS_R_SPLIT = (("sparse_shift", SparseShift15D, 1), ("cannon_dense", CannonDense25D, 1),
               ("cannon_sparse", CannonSparse25D, 1), ("cannon_sparse_fiber", CannonSparse25D, 4))


def _als_r_split_worker(rank: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=4)
    try:
        for name, cls, c in ALS_R_SPLIT:
            alg = cls(_matrix(), 8, c=c, world=DistWorld(), device="cpu")
            store = CheckpointStore(f"{out_dir}/{name}")
            DistributedALS(alg, seed=0).run_cg(1, cg_iters=3, checkpoint=store)
            resumed = DistributedALS(alg, seed=0)
            resumed.run_cg(2, cg_iters=3, checkpoint=store, resume=True)
            np.savez(f"{out_dir}/{name}{rank}.npz", A=alg.host_a(resumed.A),
                     B=resumed.item_factors(), r=resumed.compute_residual())
    finally:
        dist.destroy_process_group()


def test_r_split_als_over_gloo_matches_local_world(tmp_path):
    spawn(_als_r_split_worker, tmp_path)
    for name, cls, c in ALS_R_SPLIT:
        alg = cls(_matrix(), 8, c=c, world=LocalWorld(4), device="cpu")
        want = DistributedALS(alg, seed=0)
        want.run_cg(2, cg_iters=3)
        wa, wb = alg.host_a(want.A), want.item_factors()
        assert CheckpointStore(tmp_path / name).steps() == [1, 2]
        for rank in range(4):
            got = np.load(tmp_path / f"{name}{rank}.npz")
            for x, y in ((got["A"], wa), (got["B"], wb)):
                assert np.abs(x - y).max() <= 1e-5 * np.abs(y).max(), (name, rank)
            assert float(got["r"]) == pytest.approx(want.compute_residual(), rel=1e-4)


# ------------------------------------------------ gradients between processes
#
# Each ``DistComm`` collective under grad runs in an autograd node whose
# backward is its adjoint over the same group. ``_grads_worker`` takes, on
# four gloo processes: each collective's grad (two grids, every axis, axis
# tuples out of order, a hop with a rank nobody sends to); the sddmm, spmm
# and fused grads of the four strategies at (4, 1); and one GAT training
# step on the dense shift at p = 4 (the local MSE terms' weight grads
# summed over the processes), each on ``kind`` data: "int" (small
# integers, and for the GAT a LeakyReLU slope of 0.5, so that every sum is
# exact and equal to a ``LocalWorld``'s bit for bit) or "normal" (N(0, 1),
# held against ``jax.grad`` in ``tests/test_torch_training.py``, whose
# parent process runs the JAX side).

GRAD_R = 8
GRAD_OPS = ("sddmm", "spmm", "fused")
GRAD_STRATEGIES = {"dense_shift": DenseShift15D, "sparse_shift": SparseShift15D,
                   "cannon_dense": CannonDense25D, "cannon_sparse": CannonSparse25D}
GRAD_GRIDS = ((2, 2, 1), (4, 1, 1))
#: The GAT of ``test_gat_training_matches_jax``: one layer of 2 heads of
#: 8 features; LeakyReLU slope by data kind.
GAT_ALPHA = {"int": 0.5, "normal": 0.2}


def grad_operands(S, kind: str, R: int = GRAD_R) -> tuple:
    """``(A, B, vals)`` float32 on the host: small integers (``int``) or
    N(0, 1) from ``default_rng(1)`` in the order
    ``tests/test_torch_training.py::_operands`` draws them."""
    if kind == "int":
        rng = np.random.default_rng(5)
        return (rng.integers(-3, 4, (S.M, R)).astype(np.float32),
                rng.integers(-3, 4, (S.N, R)).astype(np.float32),
                rng.integers(-2, 3, S.nnz).astype(np.float32))
    rng = np.random.default_rng(1)
    return (rng.standard_normal((S.M, R)).astype(np.float32),
            rng.standard_normal((S.N, R)).astype(np.float32),
            rng.standard_normal(S.nnz).astype(np.float32))


def op_grads(alg, S, op: str, kind: str) -> tuple:
    """``(gA, gB, g_sv)`` in host order of ``sum(out^2) + sum(mid)`` of the
    fused pair, or ``sum(x^2)`` of the one op, with the strategy's
    shifts (``tests/test_torch_training.py::_loss``). Under a world of
    processes the loss is this process's term of the sum over processes."""
    A_np, B_np, v_np = grad_operands(S, kind)
    A = alg.put_a(A_np).requires_grad_()
    B = alg.put_b(B_np).requires_grad_()
    sv = alg.scatter_s_values(v_np).requires_grad_()
    if op == "spmm":
        z, b = alg.initial_shift(alg.like_a_matrix(0.0), B, KernelMode.SPMM_A)
        out = alg.de_shift(alg.spmm_a(z, b, sv), None, KernelMode.SPMM_A)[0]
        loss = (out * out).sum()
    elif op == "sddmm":
        a, b = alg.initial_shift(A, B, KernelMode.SDDMM_A)
        mid = alg.sddmm_a(a, b, sv)
        loss = (mid * mid).sum()
    else:
        a, b = alg.initial_shift(A, B, KernelMode.SDDMM_A)
        out, mid = alg.fused_spmm(a, b, sv, MatMode.A)
        out = alg.de_shift(out, None, KernelMode.SPMM_A)[0]
        loss = (out * out).sum() + mid.sum()
    loss.backward()
    grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in (A, B, sv)]
    return alg.host_a(grads[0]), alg.host_b(grads[1]), alg.gather_s_values(grads[2])


def gat_data(M: int, kind: str) -> tuple:
    """The GAT step's input ``X`` (M x 8), target ``T`` (M x 16) and two
    head weights (8 x 8), float32 on the host."""
    rng = np.random.default_rng(9)
    if kind == "int":
        return (rng.integers(-1, 2, (M, 8)).astype(np.float32),
                rng.integers(-2, 3, (M, 16)).astype(np.float32),
                [rng.integers(-1, 2, (8, 8)).astype(np.float32) for _ in range(2)])
    return (rng.standard_normal((M, 8)).astype(np.float32),
            (rng.standard_normal((M, 16)) * 0.1).astype(np.float32),
            [(rng.standard_normal((8, 8)) / np.sqrt(8)).astype(np.float32)
             for _ in range(2)])


def gat_step(alg, kind: str) -> dict:
    """One SGD step (lr 0.02) of ``sum((GAT(X) - T)^2)``: the loss, the
    weight grads and the stepped weights. Under a world of processes each
    process's loss term and weight grads are summed over the processes."""
    X_np, T_np, w_np = gat_data(alg.M, kind)
    gat = GAT([GATLayer(input_features=8, features_per_head=8, num_heads=2)], alg,
              leaky_relu_alpha=GAT_ALPHA[kind])
    alg.set_r_value(8)
    X = alg.put_a(X_np)
    alg.set_r_value(16)
    T = alg.put_a(T_np)
    weights = [torch.from_numpy(w).requires_grad_() for w in w_np]
    gat.layers[0].weights = weights
    loss = ((gat.forward(X) - T) ** 2).sum()
    grads = torch.autograd.grad(loss, weights)
    loss = loss.detach()
    if not alg.comm.in_process:
        for t in (loss, *grads):
            dist.all_reduce(t)
    return {"loss": loss.numpy(), **{f"g{h}": g.numpy() for h, g in enumerate(grads)},
            **{f"w{h}": (w - 0.02 * g).detach().numpy()
               for h, (w, g) in enumerate(zip(weights, grads))}}


def collective_grads(comm, xs: list, h=None) -> dict:
    """``x.grad`` of ``sum(y * w)`` for each collective's output ``y``,
    with integer weights ``w`` drawn by rank. ``xs`` are every held
    rank's inputs (a ``LocalComm``'s) or this process's one; ``h`` is its
    rank's index among all ranks (None: all held)."""
    grid = comm.grid
    ranks = list(range(len(xs))) if h is None else [h]

    def grad(fn, shape_of):
        ins = [x.clone().requires_grad_() for x in xs]
        ys = fn(ins)
        loss = sum((y * _weights(shape_of(y), r)).sum() for y, r in zip(ys, ranks))
        loss.backward()
        return [torch.zeros_like(x) if x.grad is None else x.grad for x in ins]

    out = {}
    for axis in AXES:
        tag = "/".join((axis,) if isinstance(axis, str) else axis)
        n = int(np.prod([grid.dims[("rows", "cols", "layers").index(a)]
                         for a in ((axis,) if isinstance(axis, str) else axis)]))
        big = [x.repeat(n, 1) for x in xs]
        out[f"gather {tag}"] = grad(lambda ins: comm.all_gather(ins, axis), _shape)
        out[f"sum {tag}"] = grad(lambda ins: comm.all_reduce(ins, axis, "sum"), _shape)
        ins = [x.clone().requires_grad_() for x in big]
        ys = comm.reduce_scatter(ins, axis)
        sum((y * _weights(y.shape, r)).sum() for y, r in zip(ys, ranks)).backward()
        out[f"scatter {tag}"] = [x.grad for x in ins]
    for axis in ("rows", "cols"):
        n = grid.dims[("rows", "cols").index(axis)]
        for q, perm in enumerate(([(k, (k + 1) % n) for k in range(n)], [(0, n - 1)])):
            out[f"hop {axis} {q}"] = grad(lambda ins: comm.ppermute(ins, axis, perm), _shape)
    return out


def _shape(y):
    return y.shape


def _weights(shape, rank: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(100 + rank).integers(-3, 4, tuple(shape))
                            .astype(np.float32))


def _grads_worker(rank: int, init: str, out_dir: str, kind: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=4)
    res = {}
    try:
        if kind == "int":
            for dims in GRAD_GRIDS:
                grid = make_grid(*dims)
                dc = DistWorld().comm(grid, "cpu")
                h = LocalWorld(4).comm(grid, "cpu").coords.index(dc.coords[0])
                for what, (g,) in collective_grads(dc, [_blocks(4, 3)[h]], h).items():
                    res[f"{dims}|{what}"] = g.numpy()
        S = _matrix()
        for name, cls in GRAD_STRATEGIES.items():
            alg = cls(S, GRAD_R, c=1, world=DistWorld(), device="cpu")
            for op in GRAD_OPS:
                for part, g in zip(("gA", "gB", "g_sv"), op_grads(alg, S, op, kind)):
                    res[f"{name}|{op}|{part}"] = g
        alg = DenseShift15D(S, 8, c=1, world=DistWorld(), device="cpu")
        for k, v in gat_step(alg, kind).items():
            res[f"gat|{k}"] = v
    finally:
        np.savez(f"{out_dir}/grads{rank}.npz", **res)
        dist.destroy_process_group()


def spawn_grads(tmp_path, kind: str) -> list:
    """``_grads_worker`` on four gloo processes; each rank's results."""
    spawn(_grads_worker, tmp_path, kind)
    return [dict(np.load(tmp_path / f"grads{rank}.npz")) for rank in range(4)]


@pytest.fixture(scope="module")
def int_grads(tmp_path_factory):
    return spawn_grads(tmp_path_factory.mktemp("grads"), "int")


@pytest.mark.parametrize("dims", GRAD_GRIDS)
def test_collective_grads_over_gloo_equal_local_world(int_grads, dims):
    grid = make_grid(*dims)
    lc = LocalWorld(4).comm(grid, "cpu")
    want = collective_grads(lc, _blocks(4, 3))
    assert len(want) == 3 * len(AXES) + 4
    for rank in range(4):
        h = lc.ranks.index(rank)
        for what, gs in want.items():
            np.testing.assert_array_equal(int_grads[rank][f"{dims}|{what}"], gs[h].numpy(),
                                          err_msg=f"{dims} {what} rank {rank}")
    # The one-way hop: the rank that sends to nobody gets a zero grad.
    sender_free = [h for h, c in enumerate(lc.coords) if c[0] != 0]
    assert all(not want["hop rows 1"][h].any() for h in sender_free)


@pytest.mark.parametrize("name", list(GRAD_STRATEGIES))
def test_strategy_grads_over_gloo_equal_local_world(int_grads, name):
    """The sddmm, spmm and fused grads at (4, 1) on integer operands,
    every process's equal to a ``LocalWorld(4)``'s bit for bit."""
    S = _matrix()
    alg = GRAD_STRATEGIES[name](S, GRAD_R, c=1, world=LocalWorld(4), device="cpu")
    for op in GRAD_OPS:
        want = op_grads(alg, S, op, "int")
        for rank in range(4):
            for part, w in zip(("gA", "gB", "g_sv"), want):
                np.testing.assert_array_equal(int_grads[rank][f"{name}|{op}|{part}"], w,
                                              err_msg=f"{name} {op} {part} rank {rank}")


def test_gat_step_over_gloo_equals_local_world(int_grads):
    want = gat_step(DenseShift15D(_matrix(), 8, c=1, world=LocalWorld(4), device="cpu"),
                    "int")
    assert want["loss"] > 0 and np.abs(want["g0"]).max() > 0
    for rank in range(4):
        for k, v in want.items():
            np.testing.assert_array_equal(int_grads[rank][f"gat|{k}"], v,
                                          err_msg=f"gat {k} rank {rank}")


def test_max_refuses_a_grad_and_a_hop_under_grad_is_a_new_tensor(tmp_path):
    """Over one gloo process: ``all_reduce("max")`` refuses a grad (no path
    differentiates it) and runs without one; a hop under grad returns a
    new tensor, never its input, and differentiates to the identity."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        comm = DistWorld().comm(make_grid(1, 1, 1), "cpu")
        x = torch.ones(3, requires_grad=True)
        with pytest.raises(NotImplementedError, match="all_reduce\\('max'\\)"):
            comm.all_reduce([x], "rows", "max")
        with torch.no_grad():
            assert torch.equal(comm.all_reduce([x], "rows", "max")[0], torch.ones(3))
        x2 = x * 2
        (y,) = comm.ppermute_start([x2], "rows", [(0, 0)])()
        assert y is not x2 and y.requires_grad and torch.equal(y, x2)
        y.sum().backward()
        assert torch.equal(x.grad, torch.full((3,), 2.0))
        assert comm.counts["ppermute"] == 2  # the hop and its adjoint
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- LocalWorld alone


def test_local_collectives_are_list_operations():
    comm = LocalWorld(4).comm(make_grid(2, 2, 1, adjacency=3), "cpu")
    assert comm.in_process and comm.coords == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert comm.ranks == [0, 1, 2, 3]
    xs = _blocks(4, seed=0)
    # A hop rotates the list along rows (i -> i + 1) and copies nothing.
    hopped = comm.ppermute(xs, "rows", [(0, 1), (1, 0)])
    assert [id(y) for y in hopped] == [id(xs[2]), id(xs[3]), id(xs[0]), id(xs[1])]
    # A rank nobody sends to gets zeros.
    one_way = comm.ppermute(xs, "cols", [(0, 1)])
    assert one_way[1] is xs[0] and torch.equal(one_way[0], torch.zeros(4, 3))
    gathered = comm.all_gather(xs, "cols")
    assert torch.equal(gathered[2], torch.cat([xs[2], xs[3]])) and gathered[2] is gathered[3]
    assert torch.equal(comm.all_gather(xs, ("cols", "rows"))[0],
                       torch.cat([xs[0], xs[2], xs[1], xs[3]]))
    big = _blocks(4, seed=1, shape=(4, 3))
    scattered = comm.reduce_scatter(big, "rows")
    total = big[1] + big[3]
    assert torch.equal(scattered[1], total[:2]) and torch.equal(scattered[3], total[2:])
    assert torch.equal(comm.all_reduce(xs, "cols", "max")[0], torch.maximum(xs[0], xs[1]))
    assert comm.counts == {"ppermute": 2, "all_gather": 2, "reduce_scatter": 1,
                           "all_reduce": 1}
    comm.reset_counts()
    assert set(comm.counts.values()) == {0}


def test_local_collectives_refuse_bad_input():
    comm = LocalWorld(4).comm(make_grid(2, 2, 1), "cpu")
    with pytest.raises(ValueError, match="unknown grid axis"):
        comm.all_gather(_blocks(4, 0), "depth")
    with pytest.raises(ValueError, match="does not split"):
        comm.reduce_scatter(_blocks(4, 0, shape=(3, 2)), "cols")
    with pytest.raises(ValueError, match="at least one rank"):
        LocalWorld(0)


def test_nccl_needs_cuda_and_dist_world_needs_a_group():
    assert backend_for(torch.device("cpu")) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
            backend_for(torch.device("cuda"))
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            DistWorld()


def test_world_from_env(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv(comm_mod.LOCAL_RANKS_ENV, raising=False)
    assert world_from_env("cpu").p == 1
    monkeypatch.setenv(comm_mod.LOCAL_RANKS_ENV, "4")
    world = world_from_env("cpu")
    assert isinstance(world, LocalWorld) and world.p == 4
    assert (world.num_processes, world.process_index) == (1, 0)
    S = _matrix()
    assert DenseShift15D(S, 4, c=2, device="cpu").grid.dims == (2, 2, 1)
