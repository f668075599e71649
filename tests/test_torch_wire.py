"""The port's wire-precision layer (``parallel/wire.py`` and the casts of
``parallel/loops.py``) against the JAX package's (``tests/test_wire.py``).

* The policy resolves, labels and refuses exactly as the JAX package's,
  over every role-override map of both comm dtypes.
* The f32 wire is the identity: no cast, no copy, every op bit-identical
  to a strategy built without ``wire=``.
* The bf16 wire on all four strategies at p = 8 on a ``LocalWorld``
  rounds where the JAX package's rounds on its forced 8-device CPU mesh
  (its XLA kernel): bit-equal on integer data, within 1e-5 of the JAX
  output's max abs value on N(0, 1) data (float32 sums in other orders),
  and within the JAX suite's bf16 bound of float64; its grads within the
  gradient suite's 1e-5 of ``jax.grad``; ``comm_profile`` bytes equal the
  JAX package's; over four gloo processes (bf16 payloads through gloo,
  the ``reduce=bf16`` override too) equal to ``LocalWorld(4)``, where
  the autotuner's plan is process 0's in every process.
"""

import itertools
import json

import numpy as np
import pytest
import torch

import jax

from distributed_sddmm_tpu.parallel import wire as jax_wire
from distributed_sddmm_tpu.parallel.cannon_dense_25d import CannonDense25D as JaxCD
from distributed_sddmm_tpu.parallel.cannon_sparse_25d import CannonSparse25D as JaxCS
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.parallel.sparse_shift_15d import SparseShift15D as JaxSS

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.parallel import loops
from distributed_sddmm_tpu_torch.parallel import wire
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.mesh import make_grid
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.utils import oracle

import _torch_strategy_cases as cases
import test_torch_comm as gloo
from test_torch_training import _close, _loss, _operands, _problem

R = 8
#: The JAX suite's documented bf16 bound: normalized L2 error of an op's
#: output against float64 (one rounding a read-only payload, f32 sums).
BF16_REL_ERR_BOUND = 2e-2
PAIRS = {"dense_shift": (JaxDS, DenseShift15D), "sparse_shift": (JaxSS, SparseShift15D),
         "cannon_dense": (JaxCD, CannonDense25D), "cannon_sparse": (JaxCS, CannonSparse25D)}
#: (strategy, c) at p = 8: every c the strategy takes there up to 2.
CASES = [("dense_shift", 1), ("dense_shift", 2), ("sparse_shift", 1), ("sparse_shift", 2),
         ("cannon_dense", 2), ("cannon_sparse", 2)]
_RUNS: dict = {}

# ------------------------------------------------------------ the policy

_OVERRIDE_MAPS = [
    tuple((role, dt) for role, dt in zip(wire.ROLES, choice) if dt is not None)
    for choice in itertools.product((None, "f32", "bf16"), repeat=len(wire.ROLES))
]


@pytest.mark.parametrize("comm_dtype", ["f32", "bf16"])
def test_policy_resolution_equals_jax(comm_dtype):
    """Every role-override map: the same realized roles, bytes, name,
    label and key segment as the JAX package's policy."""
    assert wire.ROLES == jax_wire.ROLES and wire.WIRE_DTYPES == jax_wire.WIRE_DTYPES
    for overrides in _OVERRIDE_MAPS:
        got = wire.WirePolicy(comm_dtype, overrides)
        want = jax_wire.WirePolicy(comm_dtype, overrides)
        assert got.realized() == want.realized(), overrides
        assert [got.bytes_for(r) for r in wire.ROLES] == [want.bytes_for(r)
                                                          for r in wire.ROLES]
        assert (got.name, got.label, got.key_segment()) == (want.name, want.label,
                                                            want.key_segment()), overrides
    assert wire.BF16.realized() == {"gather": "bf16", "ring": "bf16",
                                    "ring_accum": "f32", "reduce": "f32"}


def test_policy_errors_and_environment_equal_jax(monkeypatch):
    """The same refusals as the JAX package's; the port's process default
    reads only the ``SDDMM_TORCH_`` knobs."""
    for mod in (wire, jax_wire):
        for bad in (lambda: mod.WirePolicy("fp8"),
                    lambda: mod.WirePolicy("bf16", (("warp", "bf16"),)),
                    lambda: mod.WirePolicy("bf16", (("ring", "fp8"),)),
                    lambda: mod.BF16.dtype_for("warp")):
            with pytest.raises(ValueError):
                bad()
        with pytest.raises(TypeError):
            mod.wire_policy(16)
    assert wire.wire_policy(wire.BF16) is wire.BF16 and wire.wire_policy("bf16") == wire.BF16
    for k in ("SDDMM_TORCH_WIRE", "SDDMM_TORCH_WIRE_OVERRIDES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DSDDMM_WIRE", "bf16")
    assert wire.wire_policy(None) == wire.F32
    monkeypatch.setenv("SDDMM_TORCH_WIRE", "bf16")
    monkeypatch.setenv("SDDMM_TORCH_WIRE_OVERRIDES", "reduce=bf16, ring=f32")
    env = wire.wire_policy(None)
    assert env == wire.WirePolicy("bf16", (("reduce", "bf16"), ("ring", "f32")))
    assert env.label == "bf16.reduce=bf16.ring=f32"
    S = cases.port_coo(cases.problem())
    assert DenseShift15D(S, R=R, world=LocalWorld(2), device="cpu").wire == env


# ------------------------------------------------------- the f32 identity


def test_f32_wire_casts_and_copies_nothing():
    """``wire="f32"`` hands the comm's own results back: the hop's blocks
    are the senders' tensors, the gather's block the comm's."""
    comm = LocalWorld(4).comm(make_grid(4, 1, 1), "cpu")
    xs = [torch.full((2, 3), float(h)) for h in range(4)]
    ys = loops.abl_ppermute(comm, xs, "rows", loops.ring_perm(4), "f32")()
    assert all(y is xs[(h - 1) % 4] for h, y in enumerate(ys))
    gs = loops.abl_all_gather(comm, xs, "rows", 4, "f32")
    assert all(g is gs[0] and g.dtype == torch.float32 for g in gs)
    down = loops.abl_ppermute(comm, xs, "rows", loops.ring_perm(4), "bf16")()
    assert all(y.dtype == torch.float32 and y is not xs[(h - 1) % 4]
               for h, y in enumerate(down))
    ints = [torch.arange(3) + h for h in range(4)]
    assert loops.abl_ppermute(comm, ints, "rows", loops.ring_perm(4), "bf16")()[1] is ints[0]
    shared = loops.abl_all_gather(comm, xs, "rows", 4, "bf16")
    assert all(g is shared[0] for g in shared)  # one cast of the shared block


@pytest.mark.parametrize("name", list(PAIRS))
def test_f32_wire_is_bit_identical_to_no_wire(name):
    S = cases.problem()
    ops = cases.data(S, R, "normal", seed=3)
    plain = cases.run_ops(cases.port_alg(PAIRS[name][1], S, R, 2), *ops)
    f32 = cases.port_alg(PAIRS[name][1], S, R, 2, wire="f32")
    assert f32.wire == wire.F32 and f32.wire.label == "f32"
    got = cases.run_ops(f32, *ops)
    for op in plain:
        np.testing.assert_array_equal(got[op], plain[op], err_msg=op)


# --------------------------------------------------------- the bf16 wire


def _runs(name: str, c: int, kind: str) -> tuple:
    """``(port bf16, JAX bf16, port f32)`` outputs of every op at (8, c)."""
    key = (name, c, kind)
    if key not in _RUNS:
        S = cases.problem()
        ops = cases.data(S, R, kind, seed=c)
        jax_cls, port_cls = PAIRS[name]
        want = cases.run_ops(cases.jax_alg(jax_cls, S, R, c, pallas=False, wire="bf16"), *ops,
                             jax_side=True)
        got = cases.run_ops(cases.port_alg(port_cls, S, R, c, wire="bf16"), *ops)
        f32 = cases.run_ops(cases.port_alg(port_cls, S, R, c), *ops)
        _RUNS[key] = (got, want, f32)
    return _RUNS[key]


@pytest.mark.parametrize("name,c", CASES)
def test_bf16_wire_equals_jax_bit_for_bit_on_integers(name, c):
    got, want, _ = _runs(name, c, "int")
    assert set(got) == set(want)
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)


@pytest.mark.parametrize("name,c", CASES)
def test_bf16_wire_on_normal_data(name, c):
    """Within 1e-5 of the JAX bf16 wire's max abs value (the same
    roundings, float32 sums in other orders), different from the f32
    wire (the casts ran), and within the bf16 bound of float64."""
    got, want, f32 = _runs(name, c, "normal")
    for op in want:
        assert np.abs(got[op] - want[op]).max() <= 1e-5 * float(np.abs(want[op]).max()), op
    assert any(not np.array_equal(got[op], f32[op]) for op in got)
    S = cases.port_coo(cases.problem())
    A, B, v = cases.data(cases.problem(), R, "normal", seed=c)
    ref = S.with_values(v.astype(np.float64))
    mid = oracle.sddmm(ref, A.astype(np.float64), B.astype(np.float64))
    for op, exact in (("sddmmA", mid), ("fusedA", oracle.spmm_a(S.with_values(mid), B))):
        err = np.linalg.norm(got[op] - exact) / np.linalg.norm(exact)
        assert err < BF16_REL_ERR_BOUND, (op, err)


@pytest.mark.parametrize("name", list(PAIRS))
def test_bf16_wire_grads_match_jax(name):
    """The fused pair's grads at (8, 2) under the bf16 wire (cotangents
    cross in bf16 on both sides) within 1e-5 of ``jax.grad``'s."""
    S = _problem()
    jax_cls, port_cls = PAIRS[name]
    A_np, B_np, v_np = _operands(S)
    j = jax_cls(S, R=R, c=2, devices=jax.devices()[:8], wire="bf16")
    g = jax.grad(lambda A, B, v: _loss(j, A, B, v, "fused", cases.JaxKM, cases.JaxMM),
                 argnums=(0, 1, 2))(j.put_a(A_np), j.put_b(B_np), j.scatter_s_values(v_np))
    want = (j.host_a(g[0]), j.host_b(g[1]), j.gather_s_values(g[2]))
    alg = port_cls(cases.port_coo(S), R=R, c=2, world=LocalWorld(8), device="cpu", wire="bf16")
    A = alg.put_a(A_np).requires_grad_()
    B = alg.put_b(B_np).requires_grad_()
    sv = alg.scatter_s_values(v_np).requires_grad_()
    _loss(alg, A, B, sv, "fused", KernelMode, MatMode).backward()
    _close((alg.host_a(A.grad), alg.host_b(B.grad), alg.gather_s_values(sv.grad)), want,
           f"bf16 wire {name}")


@pytest.mark.parametrize("name", list(PAIRS))
def test_comm_profile_bytes_equal_jax(name):
    """Words and bytes of every collective the port prices, under the
    bf16 wire and a ``reduce=bf16`` override, equal the JAX package's."""
    S = cases.problem()
    jax_cls, port_cls = PAIRS[name]
    for policy in ("bf16", wire.WirePolicy("bf16", (("reduce", "bf16"),))):
        jpol = policy if isinstance(policy, str) else jax_wire.WirePolicy(
            policy.comm_dtype, policy.overrides)
        j = jax_cls(S, R=R, c=2, devices=jax.devices()[:8], wire=jpol)
        alg = cases.port_alg(port_cls, S, R, 2, wire=policy)
        for op in ("fusedSpMM", "fusedSpMMB", "sddmmA", "sddmmB", "spmmA", "spmmB"):
            got, want = alg.comm_profile(op), j.comm_profile(op)
            assert got, op
            assert [(e["words"], e["bytes"], e["in_model"]) for e in got] == \
                [(e["words"], e["bytes"], e["in_model"]) for e in want], op


def test_bf16_wire_over_gloo_equals_local_world(tmp_path):
    """Four gloo processes (bf16 payloads through gloo's gathers, hops and,
    under the ``reduce=bf16`` override, reduce-scatters) give every op's
    outputs of a ``LocalWorld(4)`` bit for bit, on integer data."""
    gloo.spawn(gloo._wire_worker, tmp_path)
    for name, cls, c, policy in gloo.WIRE_STRATEGIES:
        want = gloo._int_outputs(cls(gloo._matrix(), 8, c=c, world=LocalWorld(4),
                                     device="cpu", wire=policy))
        for rank in range(4):
            got = np.load(tmp_path / f"wire_{name}{rank}.npz")
            for op in want:
                np.testing.assert_array_equal(got[op], want[op], err_msg=f"{name} {op} {rank}")
    # The autotuner under the same processes: one plan, one cache file.
    plans = [json.loads((tmp_path / f"plan{rank}.json").read_text()) for rank in range(4)]
    assert all(plan == plans[0] for plan in plans) and plans[0]["source"] == "model"
    assert [f.name for f in (tmp_path / "plans").iterdir()] == \
        [plans[0]["fingerprint_key"] + ".json"]
