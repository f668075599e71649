"""The port's ALS-CG (``models/als.py``, ``models/serial_als.py``) against
the JAX package's.

The two packages draw their ground truth and initial factors from
different generators, so parity runs on carried state: the JAX model's
observations (S and S^T orders) and initial factors cross over through
``utils/interop.als_state_from_reference``. Sums run in other orders and
CG divides, so nothing here is bit-equal across packages. Tolerances:
one half-step (10 CG iterations) from the same state within 1e-4 of the
factors' max abs value, and the residual after each of 3 further steps
within 1e-3 relative. The JAX side runs on its forced CPU mesh
(``tests/conftest.py``) with its default kernel, and once through
``PallasKernel(interpret=True, precision="f32")``.

The three R-split strategies (``SparseShift15D``, ``CannonDense25D``,
``CannonSparse25D``) run the per-op CG path (the Gram operator through
the public ops, with their shifts; the per-row dots summed over the
R-split blocks by ``batch_dot``) and are held to the JAX package's
half-steps and trajectory at its ``tests/test_als.py`` grid (8, 2), and to
its residual protocol.

Also here: the four ``tests/test_als.py`` protocol tests on the port's
``DenseShift15D``, the divergence ladder (``SDDMM_TORCH_GUARDS``), and
checkpoints within the port and across the packages.
"""

import logging

import numpy as np
import pytest
import torch

import jax

from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.models.als import DistributedALS as JaxALS
from distributed_sddmm_tpu.models.serial_als import SerialALS as JaxSerialALS
from distributed_sddmm_tpu.ops.pallas_kernels import PallasKernel
from distributed_sddmm_tpu.parallel.cannon_dense_25d import CannonDense25D as JaxCD
from distributed_sddmm_tpu.parallel.cannon_sparse_25d import CannonSparse25D as JaxCS
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.parallel.sparse_shift_15d import SparseShift15D as JaxSS
from distributed_sddmm_tpu.resilience import CheckpointStore as JaxStore
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.models import als as als_mod
from distributed_sddmm_tpu_torch.models.als import CGDivergence, DistributedALS
from distributed_sddmm_tpu_torch.models.serial_als import SerialALS
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.resilience import CheckpointStore, NumericalFault, guards
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.interop import als_state_from_reference

HALF_STEP_TOL = 1e-4
RESIDUAL_RTOL = 1e-3
#: The R-split strategies of ``tests/test_als.py``, both packages' classes.
R_SPLIT = {"sparse_shift": (JaxSS, SparseShift15D), "cannon_dense": (JaxCD, CannonDense25D),
           "cannon_sparse": (JaxCS, CannonSparse25D)}


def _problem(M=48, N=32, seed=0):
    return JaxCOO.erdos_renyi(M, N, 5, seed=seed)


def _port_coo(S) -> HostCOO:
    return HostCOO(S.rows, S.cols, S.vals, S.M, S.N)


def _alg(S, p=1, c=1, fusion=2, R=8):
    return DenseShift15D(_port_coo(S), R=R, c=c, fusion_approach=fusion,
                         world=LocalWorld(p), device="cpu")


def _r_split(name, S, p=8, c=2):
    """The port's R-split strategy ``name`` over ``p`` logical ranks."""
    return R_SPLIT[name][1](_port_coo(S), R=8, c=c, world=LocalWorld(p), device="cpu")


def _carry(jals):
    ja = jals.d_ops
    return als_state_from_reference(
        ja.host_a(jals.A), ja.host_b(jals.B), ja.gather_s_values(jals.ground_truth),
        ja.gather_st_values(jals.ground_truth_transpose))


def _close(got, want, tol=HALF_STEP_TOL):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("strategy,p,c,fusion", [
    pytest.param("dense_shift", 1, 1, 2, id="1-1-2"),
    pytest.param("dense_shift", 8, 1, 1, id="8-1-1"),
    pytest.param("dense_shift", 8, 2, 2, id="8-2-2"),
    pytest.param("sparse_shift", 8, 2, None, id="sparse_shift-8-2"),
    pytest.param("cannon_dense", 8, 2, None, id="cannon_dense-8-2"),
    pytest.param("cannon_sparse", 8, 2, None, id="cannon_sparse-8-2")])
def test_half_steps_and_trajectory_match_jax(strategy, p, c, fusion):
    """From the JAX model's state: the A and B half-steps' factors (the CG
    iterates after 10 iterations) and the residual of 3 further steps. The
    dense shift runs a CG iteration as one ``cgStep``; the R-split
    strategies run the per-op path, the public ops' counters as the JAX
    package's per-op path counts them."""
    S = _problem()
    if strategy == "dense_shift":
        ja = JaxDS(S, R=8, c=c, fusion_approach=fusion, devices=jax.devices()[:p])
        alg = _alg(S, p, c, fusion)
    else:
        ja = R_SPLIT[strategy][0](S, R=8, c=c, devices=jax.devices()[:p])
        alg = _r_split(strategy, S, p, c)
    jals = JaxALS(ja, seed=0)
    jals.initialize_embeddings()
    als = _carry(jals).model(alg)
    assert als.compute_residual() == pytest.approx(jals.compute_residual(), rel=1e-6)
    jals.cg_optimizer(JaxMode.A, 10)
    als.cg_optimizer(MatMode.A, 10)
    _close(alg.host_a(als.A), ja.host_a(jals.A))
    jals.cg_optimizer(JaxMode.B, 10)
    als.cg_optimizer(MatMode.B, 10)
    _close(alg.host_b(als.B), ja.host_b(jals.B))
    for _ in range(3):
        jals.run_cg(1, cg_iters=10)
        als.run_cg(1, cg_iters=10)
        assert als.compute_residual() == pytest.approx(jals.compute_residual(),
                                                       rel=RESIDUAL_RTOL)
    if strategy == "dense_shift":
        assert set(alg.metrics) == {"spmmA", "spmmB", "fusedSpMM", "cgStep", "sddmmA"}
        assert alg.metrics["cgStep"]["calls"] == 2 * 10 * 4
    else:
        # Each half-step: a right-hand side and 11 Gram products (each an
        # sddmm and an spmm); one sddmmA a residual.
        calls = {k: v["calls"] for k, v in alg.metrics.items()}
        assert calls == {"spmmA": 4 * 12, "sddmmA": 4 * 11 + 4, "spmmB": 4 * 12,
                         "sddmmB": 4 * 11}


def test_half_step_matches_jax_pallas_interpret():
    """The JAX side through its Pallas kernel in interpret mode (p = 1)."""
    S = _problem()
    ja = JaxDS(S, R=8, c=1, fusion_approach=2, devices=jax.devices()[:1],
               kernel=PallasKernel(interpret=True, precision="f32"))
    jals = JaxALS(ja, seed=0)
    jals.initialize_embeddings()
    alg = _alg(S)
    als = _carry(jals).model(alg)
    for jm, mode, host in ((JaxMode.A, MatMode.A, "host_a"), (JaxMode.B, MatMode.B, "host_b")):
        jals.cg_optimizer(jm, 5)
        als.cg_optimizer(mode, 5)
        want = getattr(ja, host)(jals.A if jm == JaxMode.A else jals.B)
        _close(getattr(alg, host)(als.A if mode == MatMode.A else als.B), want)


def test_cg_paths_follow_the_strategy(monkeypatch):
    """The dense shift times every CG iteration as one ``cgStep``: the
    public fused pair inside it runs untimed, so its counter shows only
    each half-step's initial residual. The timing changes nothing
    computed: with the unit off, the same solve shows the per-op counters
    (each iteration's Gram product through the public fused pair) and
    lands on the same factors; an R-split strategy shows the per-op
    counters by itself."""
    alg = _alg(_problem(), 4, 2)
    als = DistributedALS(alg, seed=3)
    als.run_cg(2, cg_iters=4)
    assert alg.metrics["cgStep"]["calls"] == 2 * 2 * 4
    assert alg.metrics["fusedSpMM"]["calls"] == 2 * 2
    per_op = _alg(_problem(), 4, 2)
    forced = DistributedALS(per_op, seed=3)
    monkeypatch.setattr(forced, "_unit", False)
    forced.run_cg(2, cg_iters=4)
    assert "cgStep" not in per_op.metrics
    assert per_op.metrics["fusedSpMM"]["calls"] == 2 * 2 * (4 + 1)
    _close(per_op.host_a(forced.A), alg.host_a(als.A), 1e-6)
    _close(per_op.host_b(forced.B), alg.host_b(als.B), 1e-6)
    assert not DistributedALS(_r_split("cannon_sparse", _problem()), seed=3)._unit


def test_serial_als_matches_jax_serial():
    """Both packages' float64 solvers draw from the same numpy generator."""
    S = _problem()
    mine, theirs = SerialALS(_port_coo(S), 8, seed=4), JaxSerialALS(S, 8, seed=4)
    np.testing.assert_allclose(mine.ground_truth, theirs.ground_truth, rtol=1e-12)
    for model in (mine, theirs):
        model.run_cg(2, cg_iters=5)
    np.testing.assert_allclose(mine.A, theirs.A, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(mine.B, theirs.B, rtol=1e-9, atol=1e-12)
    assert mine.compute_residual() == pytest.approx(theirs.compute_residual(), rel=1e-8)


def test_distributed_matches_serial_oracle():
    """From the same host factors and observations, the float32 solver's
    residual after 2 steps is within 5% of the float64 solver's."""
    S = _port_coo(_problem())
    serial = SerialALS(S, 8, seed=1)
    alg = _alg(_problem(), 8, 2)
    als = DistributedALS(alg, artificial_groundtruth=False,
                         ground_truth_vals=serial.ground_truth,
                         ground_truth_vals_transpose=S.with_values(serial.ground_truth)
                         .transpose().vals)
    als.A, als.B = alg.put_a(serial.A.astype(np.float32)), alg.put_b(serial.B.astype(np.float32))
    serial.run_cg(2, cg_iters=10)
    als.run_cg(2, cg_iters=10)
    assert als.compute_residual() <= 1.05 * serial.compute_residual()
    _close(alg.host_a(als.A), serial.A, 1e-3)


def test_residual_counts_nonzeros_only():
    """M_pad > M at p = 8: the residual is the float64 norm over the real
    nonzeros, and the item factors come back without padding."""
    S = JaxCOO.erdos_renyi(45, 30, 4, seed=2)
    alg = _alg(S, 8, 2)
    assert (alg.M_pad, alg.N_pad) == (48, 32)
    als = DistributedALS(alg, seed=2)
    als.initialize_embeddings()
    A, B = alg.host_a(als.A).astype(np.float64), alg.host_b(als.B).astype(np.float64)
    pred = np.einsum("kr,kr->k", A[S.rows], B[S.cols])
    gt = alg.gather_s_values(als.ground_truth).astype(np.float64)
    assert als.compute_residual() == pytest.approx(np.linalg.norm(pred - gt), rel=1e-6)
    assert als.item_factors().shape == (30, 8)
    with pytest.raises(ValueError, match="no factors yet"):
        DistributedALS(alg).item_factors()


# --------------------------------------------- the protocol of test_als.py


@pytest.mark.parametrize("strategy,c,fusion", [
    pytest.param("dense_shift", 2, 2, id="2-2"), pytest.param("dense_shift", 1, 1, id="1-1"),
    pytest.param("sparse_shift", 2, None, id="sparse_shift-2"),
    pytest.param("cannon_dense", 2, None, id="cannon_dense-2"),
    pytest.param("cannon_sparse", 2, None, id="cannon_sparse-2")])
def test_als_residual_decreases(strategy, c, fusion):
    S = _problem()
    alg = _alg(S, 8, c, fusion) if strategy == "dense_shift" else _r_split(strategy, S, 8, c)
    als = DistributedALS(alg, seed=0)
    als.initialize_embeddings()
    r0 = als.compute_residual()
    als.run_cg(1, cg_iters=5)
    r1 = als.compute_residual()
    als.run_cg(1, cg_iters=5)
    r2 = als.compute_residual()
    assert r1 < r0 * 0.5, (r0, r1, r2)
    assert r2 < r1 * 1.01, (r0, r1, r2)


def test_als_converges_close_to_zero():
    als = DistributedALS(_alg(_problem(), 8, 2), seed=1)
    als.initialize_embeddings()
    als.run_cg(4, cg_iters=10)
    r = als.compute_residual()
    assert r < 1e-3 * als.d_ops.S_tiles.nnz ** 0.5 or r < 1e-2


def test_als_real_ground_truth_values():
    S = _problem()
    obs = np.random.default_rng(2).standard_normal(S.nnz) * 0.01
    als = DistributedALS(_alg(S), artificial_groundtruth=False, ground_truth_vals=obs,
                         ground_truth_vals_transpose=S.with_values(obs).transpose().vals)
    als.initialize_embeddings()
    r0 = als.compute_residual()
    als.run_cg(1, cg_iters=8)
    assert als.compute_residual() < r0


def test_als_requires_ground_truth_vals():
    S = _problem()
    with pytest.raises(ValueError):
        DistributedALS(_alg(S), artificial_groundtruth=False)
    als = DistributedALS(_alg(S), artificial_groundtruth=False,
                         ground_truth_vals=np.random.default_rng(3).standard_normal(S.nnz))
    als.initialize_embeddings()
    with pytest.raises(ValueError, match="transposed ground-truth"):
        als.cg_optimizer(MatMode.B, 1)


# ------------------------------------------------------------------ ladder


def _poison(monkeypatch, alg, times: int) -> list:
    """Make the strategy's public fused pair return NaN for its next
    ``times`` calls outside a ``cgStep`` (on the dense shift: the Gram
    operator of each half-step's initial residual); returns the list of
    poisoned calls."""
    real, hits = alg.fused_spmm, []

    def fused(*args, **kw):
        out, mid = real(*args, **kw)
        if not alg._timing and len(hits) < times:
            hits.append(1)
            out = torch.full_like(out, float("nan"))
        return out, mid

    monkeypatch.setattr(alg, "fused_spmm", fused)
    return hits


def test_poisoned_gram_operator_restarts_damped_and_succeeds(monkeypatch, caplog):
    monkeypatch.setenv(guards.GUARDS_ENV, "1")
    alg = _alg(_problem(), 4, 2)
    als = DistributedALS(alg, seed=0)
    als.initialize_embeddings()
    r0 = als.compute_residual()
    before = als.A.clone()
    hits = _poison(monkeypatch, alg, 1)
    lams = []
    real_run = als._cg_run
    monkeypatch.setattr(als, "_cg_run", lambda mode, n, lam: lams.append(lam) or
                        real_run(mode, n, lam))
    with caplog.at_level(logging.WARNING, logger="als"):
        als.cg_optimizer(MatMode.A, 10)
    assert hits == [1] and lams == [1e-6, 1e-6 * als.damp_factor]
    assert "damped-λ restart" in caplog.text
    assert bool(torch.isfinite(als.A).all()) and not torch.equal(als.A, before)
    als.cg_optimizer(MatMode.B, 10)
    assert als.compute_residual() < 0.5 * r0 and als.degraded is None


def test_poisoned_twice_degrades_to_serial(monkeypatch):
    monkeypatch.setenv(guards.GUARDS_ENV, "1")
    S = _problem()
    alg = _alg(S, 4, 2)
    als = DistributedALS(alg, seed=0, S_host=_port_coo(S))
    als.initialize_embeddings()
    r0 = als.compute_residual()
    _poison(monkeypatch, alg, 2)
    als.run_cg(2, cg_iters=5)
    assert als.degraded == "serial"
    assert bool(torch.isfinite(als.A).all()) and als.compute_residual() < 0.5 * r0

    bare = DistributedALS(alg, seed=0)
    bare.initialize_embeddings()
    _poison(monkeypatch, alg, 2)
    with pytest.raises(NumericalFault, match="no S_host"):
        bare.run_cg(1, cg_iters=5)
    with pytest.raises(CGDivergence):
        _poison(monkeypatch, alg, 2)
        bare.cg_optimizer(MatMode.A, 5)


def test_poisoned_twice_on_the_card_raises_instead_of_degrading(monkeypatch):
    """The serial rung runs only for a strategy on the CPU: on the card the
    second failure raises, naming both ridges, and the factors stay the
    pre-step ones (the card's own run of this is ``chip_smoke.py``'s
    ``als_protocol``)."""
    monkeypatch.setenv(guards.GUARDS_ENV, "1")
    S = _problem()
    alg = _alg(S, 4, 2)
    als = DistributedALS(alg, seed=0, S_host=_port_coo(S))
    als.initialize_embeddings()
    A0, B0 = als.A.clone(), als.B.clone()
    _poison(monkeypatch, alg, 2)
    with pytest.raises(CGDivergence) as failed:
        als.cg_optimizer(MatMode.A, 5)
    monkeypatch.setattr(alg, "device", torch.device("cuda"))
    with pytest.raises(NumericalFault, match=r"no host fallback") as raised:
        als.degrade_to_serial(2, 5, cause=failed.value)
    assert "λ=1e-06" in str(raised.value) and "damped λ=0.001" in str(raised.value)
    assert als.degraded is None and torch.equal(als.A, A0) and torch.equal(als.B, B0)


def test_guard_is_off_by_default(monkeypatch):
    """Without the env knob nothing checks the residual: a poisoned Gram
    operator walks NaN into the factors (the JAX package's default too,
    absent a fault plan). ``guard=True`` turns the ladder on per model."""
    monkeypatch.delenv(guards.GUARDS_ENV, raising=False)
    alg = _alg(_problem())
    als = DistributedALS(alg, seed=0)
    als.initialize_embeddings()
    assert not als._guard_active()
    _poison(monkeypatch, alg, 1)
    als.cg_optimizer(MatMode.A, 3)
    assert not bool(torch.isfinite(als.A).all())
    guarded = DistributedALS(alg, seed=0, guard=True)
    guarded.initialize_embeddings()
    _poison(monkeypatch, alg, 1)
    guarded.cg_optimizer(MatMode.A, 3)
    assert bool(torch.isfinite(guarded.A).all())
    monkeypatch.setenv(guards.GUARDS_ENV, "1")
    assert als._guard_active()


# ------------------------------------------------------------- checkpoints


def _make_als():
    S = _problem()
    return DistributedALS(_alg(S, 8, 2), seed=0, S_host=_port_coo(S))


class _Killed(Exception):
    pass


def test_als_kill_and_resume_bit_identical(tmp_path, monkeypatch):
    """A run killed in step 3 (after steps 1 and 2 were stored) and resumed
    ends with the factors of an uninterrupted run, bit for bit."""
    als = _make_als()
    als.run_cg(4, cg_iters=5)
    want_A, want_B = als.A.clone(), als.B.clone()

    store = CheckpointStore(tmp_path)
    crashed = _make_als()
    real, calls = crashed.cg_optimizer, []

    def dies_in_step_3(mode, n):
        calls.append(mode)
        if len(calls) == 5:
            raise _Killed
        real(mode, n)

    monkeypatch.setattr(crashed, "cg_optimizer", dies_in_step_3)
    with pytest.raises(_Killed):
        crashed.run_cg(4, cg_iters=5, checkpoint=store, checkpoint_every=1)
    assert store.load_latest()[0] == 2

    resumed = _make_als()
    resumed.run_cg(4, cg_iters=5, checkpoint=store, checkpoint_every=1, resume=True)
    assert torch.equal(resumed.A, want_A) and torch.equal(resumed.B, want_B)
    assert store.steps() == [2, 3, 4]
    assert resumed.compute_residual() < 1e-2


def test_als_resume_with_empty_store_is_fresh_start(tmp_path):
    als = _make_als()
    als.run_cg(1, cg_iters=3, checkpoint=CheckpointStore(tmp_path), resume=True)
    assert als.A is not None and CheckpointStore(tmp_path).load_latest()[0] == 1


def test_als_ignores_foreign_kind_and_other_shapes(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(9, {"w_0_0": np.zeros((4, 4), np.float32)}, meta={"kind": "gat"})
    assert _make_als().restore_checkpoint(store) == 0
    store.save(10, {"A": np.zeros((48, 4), np.float32), "B": np.zeros((32, 4), np.float32)},
               meta={"kind": "als"})
    assert _make_als().restore_checkpoint(store) == 0
    store.save(11, {"A": np.ones((48, 8), np.float32), "B": np.ones((32, 8), np.float32)},
               meta={"kind": "als"})
    als = _make_als()
    assert als.restore_checkpoint(store) == 11 and float(als.A.sum()) == 48 * 8


def test_jax_checkpoint_resumes_in_the_port_and_back(tmp_path):
    """The JAX model stores step 1; the port, given the same observations,
    resumes there and runs step 2, landing within the half-step tolerance
    of the JAX package's uninterrupted step 2. The port's step-2 store
    resumes in the JAX model, whose step 3 the port's own step 3 matches."""
    S = _problem()
    ja = JaxDS(S, R=8, c=2, fusion_approach=2, devices=jax.devices()[:8])
    jstore = JaxStore(tmp_path / "jax")
    jals = JaxALS(ja, seed=0)
    jals.initialize_embeddings()
    state = _carry(jals)
    jals.run_cg(1, cg_iters=10, checkpoint=jstore)

    alg = _alg(S, 8, 2)
    als = state.model(alg)
    pstore = CheckpointStore(tmp_path / "jax")
    als.run_cg(2, cg_iters=10, checkpoint=pstore, resume=True)
    assert pstore.steps() == [1, 2]
    want = JaxALS(ja, seed=0)
    want.run_cg(2, cg_iters=10)
    _close(alg.host_a(als.A), ja.host_a(want.A))
    _close(alg.host_b(als.B), ja.host_b(want.B))

    back = JaxALS(ja, seed=0)
    back.run_cg(3, cg_iters=10, checkpoint=JaxStore(tmp_path / "jax"), resume=True)
    als.run_cg(1, cg_iters=10)  # the port's own step 3
    _close(alg.host_a(als.A), ja.host_a(back.A))
    assert back.compute_residual() == pytest.approx(als.compute_residual(), rel=RESIDUAL_RTOL)


def test_r_split_ladder_and_checkpoints(tmp_path, monkeypatch):
    """On the per-op path (``CannonSparse25D``, whose columns are skewed):
    a poisoned Gram operator restarts damped and succeeds; a run killed
    after step 1 and resumed from its store (the factors in global order)
    ends on the uninterrupted run's factors bit for bit."""
    monkeypatch.setenv(guards.GUARDS_ENV, "1")
    S = _problem()
    alg = _r_split("cannon_sparse", S)
    als = DistributedALS(alg, seed=0)
    als.initialize_embeddings()
    r0 = als.compute_residual()
    hits = _poison(monkeypatch, alg, 1)
    als.cg_optimizer(MatMode.A, 10)
    als.cg_optimizer(MatMode.B, 10)
    assert hits == [1] and als.compute_residual() < 0.5 * r0
    monkeypatch.undo()

    whole = DistributedALS(alg, seed=0)
    whole.run_cg(2, cg_iters=5)
    store = CheckpointStore(tmp_path)
    DistributedALS(alg, seed=0).run_cg(1, cg_iters=5, checkpoint=store)
    _, arrays, _ = store.load_latest()
    first = DistributedALS(alg, seed=0)
    first.run_cg(1, cg_iters=5)
    np.testing.assert_array_equal(arrays["A"][: S.M], alg.host_a(first.A))
    resumed = DistributedALS(alg, seed=0)
    resumed.run_cg(2, cg_iters=5, checkpoint=store, resume=True)
    assert store.steps() == [1, 2]
    assert torch.equal(resumed.A, whole.A) and torch.equal(resumed.B, whole.B)


def test_ladder_logs_under_the_als_logger(caplog, monkeypatch):
    """The JAX package's trace events become ``logging`` under ``"als"``:
    the degradation is logged as a warning, its cause as an error."""
    monkeypatch.setenv(guards.GUARDS_ENV, "1")
    S = _problem()
    alg = _alg(S)
    als = DistributedALS(alg, seed=0, S_host=_port_coo(S))
    als.initialize_embeddings()
    _poison(monkeypatch, alg, 2)
    with caplog.at_level(logging.WARNING, logger="als"):
        als.run_cg(1, cg_iters=3)
    levels = {r.levelname for r in caplog.records if r.name == "als"}
    assert levels == {"WARNING", "ERROR"} and "serial solver" in caplog.text
    assert als_mod.EPS == 1e-8
