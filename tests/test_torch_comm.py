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

from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.parallel import comm as comm_mod
from distributed_sddmm_tpu_torch.parallel.comm import (
    DistWorld, LocalWorld, backend_for, world_from_env,
)
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.mesh import make_grid
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
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
    return HostCOO.rmat(7, 6, np.random.default_rng(3))


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
    ctx = mp.spawn(_worker, args=(str(tmp_path / "init"), str(tmp_path)), nprocs=4,
                   join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the gloo processes did not finish in 240 s")
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
    ctx = mp.spawn(_als_worker, args=(str(tmp_path / "init"), str(tmp_path)), nprocs=4,
                   join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the gloo processes did not finish in 240 s")
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
    ctx = mp.spawn(_strategies_worker, args=(str(tmp_path / "init"), str(tmp_path)),
                   nprocs=4, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the gloo processes did not finish in 240 s")
    for name, cls, c, kw, banked in STRATEGIES:
        alg = _strategy(cls, c, kw, banked, LocalWorld(4))
        assert alg.kernel_variant_realized == ("v1.rb2.rs" if banked else None)
        want = _int_outputs(alg)
        for rank in range(4):
            got = np.load(tmp_path / f"{name}{rank}.npz")
            assert set(got.files) == set(want)
            for op in want:
                np.testing.assert_array_equal(got[op], want[op], err_msg=f"{name} {op} {rank}")


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
    ctx = mp.spawn(_als_r_split_worker, args=(str(tmp_path / "init"), str(tmp_path)),
                   nprocs=4, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the gloo processes did not finish in 240 s")
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
