"""The port's fault injection (``resilience/faults.py``) against the JAX
package's, and its retry path (``parallel/base.py::_resilient_call``).

Exact comparisons throughout: the same plans parse to the same specs,
fire on the same calls (the SHA-256 rule), corrupt the same elements (the
Weyl index sequence) and garble the same text in both packages. A
one-shot fault at an op's ``execute:`` or ``output:`` site, or at
``output:cgStep`` in ALS, heals through the retry to the clean run's
bits, with the JAX run's ``faults_fired`` and retries, at p = 4 (the
port's ``LocalWorld``, the JAX package's first four CPU devices). An
``als:cg_iter`` error stops ALS in both packages on the same call, and
resuming from the checkpoint store ends on the clean run's bits.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from distributed_sddmm_tpu.models.als import DistributedALS as JaxALS
from distributed_sddmm_tpu.parallel.cannon_sparse_25d import CannonSparse25D as JaxCS
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.parallel.sparse_shift_15d import SparseShift15D as JaxSS
from distributed_sddmm_tpu.resilience import faults as jax_faults
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.obs import metrics
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.resilience import CheckpointStore, faults, guards
from distributed_sddmm_tpu_torch.resilience.faults import (
    FaultError, FaultPlan, FaultSpec, InjectedFault, InjectedOOM, InjectedTimeout,
    fault_plan,
)
from distributed_sddmm_tpu_torch.resilience.guards import NumericalFault
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.verify import fingerprint_algorithm


@pytest.fixture(autouse=True)
def _no_plans(monkeypatch):
    """Neither package's plan outlives a test, and no environment plan or
    guard knob leaks in."""
    for name in ("SDDMM_TORCH_FAULTS", "SDDMM_TORCH_GUARDS", "SDDMM_TORCH_GUARD_MODE",
                 "SDDMM_TORCH_EXEC_RETRIES", "DSDDMM_FAULTS", "DSDDMM_GUARDS"):
        monkeypatch.delenv(name, raising=False)
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _spec_dicts(plan) -> list:
    return [{"site": s.site, "kind": s.kind, "at": s.at, "prob": s.prob, "param": s.param}
            for s in plan.specs]


# ------------------------------------------------------------ plan format

SPECS = [{"site": "execute:*", "kind": "timeout", "at": [0, 3]},
         {"site": "output:fused*", "kind": "nan", "prob": 0.3, "param": 0.2},
         {"site": "write:*.json", "kind": "garble", "prob": 0.5}]


@pytest.mark.parametrize("form", ["json-list", "at-path", "seed-specs", "seed-specs-dict",
                                  "list", "shorthand"])
def test_from_spec_formats_match_jax(form, tmp_path):
    spec = {
        "json-list": json.dumps(SPECS),
        "at-path": None,
        "seed-specs": json.dumps({"seed": 7, "specs": SPECS}),
        "seed-specs-dict": {"seed": 7, "specs": SPECS},
        "list": SPECS,
        "shorthand": "delay,nan,skew,garble",
    }[form]
    if form == "at-path":
        path = tmp_path / "plan.json"
        path.write_text(json.dumps({"seed": 3, "specs": SPECS}))
        spec = f"@{path}"
    got, want = FaultPlan.from_spec(spec), jax_faults.FaultPlan.from_spec(spec)
    assert got.seed == want.seed
    assert _spec_dicts(got) == _spec_dicts(want) and got.specs
    if form == "shorthand":
        assert [s.site for s in got.specs] == ["execute:*", "output:*", "comm:*", "write:*"]
    with pytest.raises(ValueError):
        FaultSpec(site="x", kind="meltdown")


# ---------------------------------------------------------------- firing

SITES = ["execute:fusedSpMM", "output:fusedSpMM", "execute:cgStep", "output:sddmmA",
         "comm:fusedSpMM", "write:latest.json", "als:cg_iter"]


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_fires_sequences_match_jax(seed):
    """Interleaved calls at several sites, probabilistic and indexed rules:
    each call fires the same kinds, and the event lists are equal."""
    specs = [{"site": "execute:*", "kind": "error", "prob": 0.25},
             {"site": "output:*", "kind": "nan", "prob": 0.4, "param": 0.1},
             {"site": "*:fusedSpMM", "kind": "delay", "at": [2, 5], "param": 0.0},
             {"site": "als:*", "kind": "timeout", "prob": 0.5},
             {"site": "write:*", "kind": "truncate", "prob": 0.3, "param": 0.5},
             {"site": "comm:*", "kind": "skew", "prob": 0.6, "param": 2.0}]
    got = FaultPlan.from_spec({"seed": seed, "specs": specs})
    want = jax_faults.FaultPlan.from_spec({"seed": seed, "specs": specs})
    rng = np.random.default_rng(seed)
    for site in rng.choice(SITES, size=300):
        assert ([s.kind for s in got.fires(str(site))]
                == [s.kind for s in want.fires(str(site))])
    assert got.events == want.events and len(got.events) > 50
    for site in SITES:
        assert got.call_count(site) == want.call_count(site)


# -------------------------------------------------------------- the hooks


@pytest.mark.parametrize("shape,param,seed,kind", [
    ((100,), 0.01, 0, "nan"), ((37, 5), 0.2, 3, "inf"), ((64, 64), 0.05, 9, "nan"),
    ((3,), 0.9, 1, "inf"), ((1,), 0.5, 2, "nan")])
def test_corrupt_outputs_positions_match_jax(shape, param, seed, kind):
    """The positions and values of the corrupted elements of a (tensor,
    tensor, int tensor) output equal the JAX package's numpy path's; the
    input is not written and the int leaf passes through."""
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(7)
    ints = np.arange(4)
    spec = {"seed": seed, "specs": [{"site": "output:op", "kind": kind, "at": [1],
                                     "param": param}]}
    with fault_plan(FaultPlan.from_spec(spec)):
        ta = torch.from_numpy(a.copy())
        assert faults.corrupt_outputs("output:op", ta) is ta  # call 0: nothing
        got = faults.corrupt_outputs("output:op", (ta, torch.from_numpy(b),
                                                   torch.from_numpy(ints)))
    with jax_faults.fault_plan(jax_faults.FaultPlan.from_spec(spec)):
        jax_faults.corrupt_outputs("output:op", a)
        want = jax_faults.corrupt_outputs("output:op", (a, b, ints))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(ta, torch.from_numpy(a))
    assert int((~torch.isfinite(got[0])).sum()) == len(faults.corrupt_indices(a.size, param,
                                                                              0))


@pytest.mark.parametrize("kind,param", [("garble", 0.01), ("truncate", 0.3),
                                        ("truncate", 2.0)])
def test_garble_and_truncate_match_jax(kind, param):
    text = json.dumps({"step": 3, "digest": "ab" * 20, "meta": list(range(30))})
    spec = [{"site": "write:*", "kind": kind, "at": [0, 2], "param": param}]
    with fault_plan(FaultPlan.from_spec(spec)):
        got = [faults.garble_text("write:latest.json", text) for _ in range(3)]
    with jax_faults.fault_plan(jax_faults.FaultPlan.from_spec(spec)):
        want = [jax_faults.garble_text("write:latest.json", text) for _ in range(3)]
    assert got == want and got[1] == text and got[0] != text


def test_write_fault_garbles_the_checkpoint_pointer(tmp_path):
    """The write hook of ``utils/atomic.py`` (site ``write:<file>``): a
    truncated ``latest.json`` reads as a miss and resume scans back to the
    step file, as in the JAX package."""
    store = CheckpointStore(tmp_path)
    spec = [{"site": "write:latest.json", "kind": "truncate", "at": [0], "param": 0.5}]
    with fault_plan(FaultPlan.from_spec(spec)) as plan:
        store.save(1, {"A": np.ones(3, np.float32)})
    assert plan.events == [("write:latest.json", "truncate", 0)]
    with pytest.raises(json.JSONDecodeError):
        json.loads((tmp_path / "latest.json").read_text())
    step, arrays, meta = store.load_latest()
    assert step == 1 and meta == {} and np.array_equal(arrays["A"], np.ones(3))


def test_exception_types_and_hooks():
    assert issubclass(InjectedTimeout, TimeoutError) and issubclass(InjectedTimeout, FaultError)
    assert issubclass(InjectedOOM, MemoryError) and issubclass(InjectedOOM, FaultError)
    assert issubclass(InjectedFault, RuntimeError) and not issubclass(InjectedFault, TimeoutError)
    for kind, exc in (("timeout", InjectedTimeout), ("oom", InjectedOOM),
                      ("error", InjectedFault)):
        with fault_plan(FaultPlan([FaultSpec(site="execute:x", kind=kind, at=(1,))])) as plan:
            faults.maybe_raise("execute:x")
            with pytest.raises(exc, match="execute:x"):
                faults.maybe_raise("execute:x")
            faults.maybe_raise("execute:y")
        assert plan.events == [("execute:x", kind, 1)]
    with fault_plan(FaultPlan([FaultSpec(site="execute:x", kind="delay", at=(0,),
                                         param=0.05)])):
        t0 = time.perf_counter()
        faults.maybe_raise("execute:x")
        assert time.perf_counter() - t0 >= 0.05
    with fault_plan(FaultPlan([FaultSpec(site="comm:*", kind="skew", prob=1.0, param=2.0)])):
        assert faults.scale_value("comm:fusedSpMM", 3.0) == 6.0
    assert faults.scale_value("comm:fusedSpMM", 3.0) == 3.0  # no plan: identity
    code = ("from distributed_sddmm_tpu_torch.resilience import faults\n"
            "faults.install(faults.FaultPlan.from_spec("
            "'[{\"site\": \"worker:*\", \"kind\": \"kill\", \"at\": [0]}]'))\n"
            "faults.maybe_kill('worker:0')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", code], env=env, timeout=60)
    assert proc.returncode == faults.KILL_EXIT_CODE


def test_guards_follow_the_plan(monkeypatch):
    assert not guards.enabled()
    with fault_plan(FaultPlan([])):
        assert guards.enabled()
        monkeypatch.setenv(guards.GUARDS_ENV, "0")
        assert not guards.enabled()


def test_env_plan_reaches_the_hooks(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV, json.dumps(
        [{"site": "execute:a", "kind": "error", "at": [0]}]))
    monkeypatch.setattr(faults, "_env_checked", False)
    with pytest.raises(InjectedFault):
        faults.maybe_raise("execute:a")
    faults.clear()
    monkeypatch.setenv(faults.FAULTS_ENV, "{not json")
    monkeypatch.setattr(faults, "_env_checked", False)
    assert faults.active() is None  # a malformed plan is logged and ignored


# ---------------------------------------------- strategies, p = 4, JAX runs


def _problem():
    return JaxCOO.erdos_renyi(48, 32, 5, seed=0)


def _port_coo(S) -> HostCOO:
    return HostCOO(S.rows, S.cols, S.vals, S.M, S.N)


STRATS = {
    "15d_fusion2": (lambda S: JaxDS(S, R=8, c=2, devices=jax.devices()[:4]),
                    lambda S: DenseShift15D(_port_coo(S), R=8, c=2, world=LocalWorld(4),
                                            device="cpu")),
    "15d_sparse": (lambda S: JaxSS(S, R=8, c=2, devices=jax.devices()[:4]),
                   lambda S: SparseShift15D(_port_coo(S), R=8, c=2, world=LocalWorld(4),
                                            device="cpu")),
    "25d_sparse": (lambda S: JaxCS(S, R=8, c=1, devices=jax.devices()[:4]),
                   lambda S: CannonSparse25D(_port_coo(S), R=8, c=1, world=LocalWorld(4),
                                             device="cpu")),
}

ONE_SHOT = {
    "execute-error": [{"site": "execute:fusedSpMM", "kind": "error", "at": [0]},
                      {"site": "execute:sddmmA", "kind": "error", "at": [0]}],
    "execute-timeout": [{"site": "execute:s*", "kind": "timeout", "at": [0]}],
    "output-nan": [{"site": "output:*", "kind": "nan", "at": [0], "param": 0.2}],
    "output-inf-spmm": [{"site": "output:spmm*", "kind": "inf", "at": [0]}],
}


def _retries(metric_dict) -> dict:
    return {op: int(m["retries"]) for op, m in metric_dict.items()}


@pytest.mark.parametrize("plan_id", list(ONE_SHOT))
@pytest.mark.parametrize("strategy", list(STRATS))
def test_one_shot_op_faults_heal_to_clean_bits_like_jax(strategy, plan_id):
    S = _problem()
    mk_jax, mk_port = STRATS[strategy]
    clean = fingerprint_algorithm(mk_port(S), _port_coo(S))
    spec = {"seed": 0, "specs": ONE_SHOT[plan_id]}
    alg = mk_port(S)
    before = metrics.GLOBAL.get("exec_retries")
    with fault_plan(FaultPlan.from_spec(spec)) as plan:
        got = fingerprint_algorithm(alg, _port_coo(S))
    ja = mk_jax(S)
    from distributed_sddmm_tpu.utils.verify import fingerprint_algorithm as jax_fp

    with jax_faults.fault_plan(jax_faults.FaultPlan.from_spec(spec)) as jplan:
        jax_fp(ja, S)
    assert got == clean
    assert plan.events == jplan.events and plan.events
    assert _retries(alg.metrics.to_dict()) == _retries(ja.metrics.to_dict())
    assert metrics.GLOBAL.get("exec_retries") - before == sum(_retries(alg.metrics).values())
    assert all(m["overhead_s"] > 0 for m in alg.metrics.values() if m["retries"])


def test_persistent_faults_raise_typed_errors():
    S = _problem()
    for spec, exc in (({"site": "execute:*", "kind": "timeout", "prob": 1.0}, TimeoutError),
                      ({"site": "output:*", "kind": "nan", "prob": 1.0}, NumericalFault)):
        alg = STRATS["15d_fusion2"][1](S)
        with fault_plan(FaultPlan.from_spec([spec])) as plan:
            with pytest.raises(exc):
                fingerprint_algorithm(alg, _port_coo(S))
        assert len(plan.events) == 2  # the attempt and its one retry


def test_real_timeouts_retry_on_the_cpu_then_raise(monkeypatch):
    """``SDDMM_TORCH_EXEC_TIMEOUT`` bounds each attempt: on the CPU a real
    ``CallTimeout`` retries once like an injected fault, then raises (on
    the card it raises at once: the abandoned thread still owns the
    stream)."""
    from distributed_sddmm_tpu_torch.resilience.retry import CallTimeout

    monkeypatch.setenv(guards.GUARDS_ENV, "1")
    monkeypatch.setenv("SDDMM_TORCH_EXEC_TIMEOUT", "0.05")
    alg = STRATS["15d_fusion2"][1](_problem())
    before = metrics.GLOBAL.get("exec_retries")
    with pytest.raises(CallTimeout, match="execute:slowOp"):
        alg._timed("slowOp", time.sleep, 0.3)
    assert metrics.GLOBAL.get("exec_retries") == before + 1
    assert alg._timed("fastOp", lambda: torch.ones(2)).sum() == 2
    assert alg.metrics["fastOp"]["retries"] == 0


def test_repair_mode_keeps_the_run_finite(monkeypatch):
    monkeypatch.setenv(guards.GUARD_MODE_ENV, "repair")
    S = _problem()
    alg = STRATS["15d_fusion2"][1](S)
    with fault_plan(FaultPlan.from_spec([{"site": "output:*", "kind": "nan", "prob": 1.0}])):
        fps = fingerprint_algorithm(alg, _port_coo(S))
    assert all(np.isfinite(v) for v in fps.values())
    assert all(m["retries"] == 0 for m in alg.metrics.values())


# ------------------------------------------------------------ ALS, p = 4

ALS_PLANS = {
    "output-cgStep": [{"site": "output:cgStep", "kind": "nan", "at": [4]}],
    "execute-cgStep": [{"site": "execute:cgStep", "kind": "error", "at": [2, 7]}],
    "output-fused-and-rhs": [{"site": "output:fusedSpMM", "kind": "nan", "at": [1]},
                             {"site": "output:spmmA", "kind": "inf", "at": [0]}],
    "output-spmm-r-split": [{"site": "output:spmmA", "kind": "nan", "at": [3]},
                            {"site": "execute:sddmmB", "kind": "oom", "at": [1]}],
}


def _als_pair(strategy: str):
    S = _problem()
    mk_jax, mk_port = STRATS[strategy]
    return S, (lambda: JaxALS(mk_jax(S), seed=0)), (lambda: DistributedALS(mk_port(S), seed=0))


@pytest.mark.parametrize("plan_id,strategy", [
    ("output-cgStep", "15d_fusion2"), ("execute-cgStep", "15d_fusion2"),
    ("output-fused-and-rhs", "15d_fusion2"), ("output-spmm-r-split", "25d_sparse")])
def test_als_one_shot_faults_keep_the_clean_bits(plan_id, strategy):
    """A faulted ALS run equals the clean run bit for bit: the retried
    ``cgStep`` starts from the carries it was given, although the port
    updates them in place when no retry can happen. The events and the
    per-op retries equal the JAX run's."""
    S, mk_jax, mk_port = _als_pair(strategy)
    clean = mk_port()
    clean.run_cg(2, cg_iters=5)
    spec = {"seed": 0, "specs": ALS_PLANS[plan_id]}
    als = mk_port()
    with fault_plan(FaultPlan.from_spec(spec)) as plan:
        als.run_cg(2, cg_iters=5)
    jals = mk_jax()
    with jax_faults.fault_plan(jax_faults.FaultPlan.from_spec(spec)) as jplan:
        jals.run_cg(2, cg_iters=5)
    assert torch.equal(als.A, clean.A) and torch.equal(als.B, clean.B)
    assert als.compute_residual() == clean.compute_residual()
    assert plan.events == jplan.events and plan.events
    got, want = _retries(als.d_ops.metrics.to_dict()), _retries(jals.d_ops.metrics.to_dict())
    assert got == want and sum(got.values()) == len(plan.events)


def test_als_cg_iter_fault_stops_both_and_resume_is_exact(tmp_path):
    """``als:cg_iter`` error at call 7 (step 1's A half-step, 3 CG
    iterations a half-step): both packages raise on the same call; the
    port resumes from its store to the clean run's bits."""
    S, mk_jax, mk_port = _als_pair("15d_fusion2")
    spec = [{"site": "als:cg_iter", "kind": "error", "at": [7]}]
    store = CheckpointStore(tmp_path)
    crashed = mk_port()
    with fault_plan(FaultPlan.from_spec(spec)) as plan:
        with pytest.raises(InjectedFault):
            crashed.run_cg(3, cg_iters=3, checkpoint=store)
    with jax_faults.fault_plan(jax_faults.FaultPlan.from_spec(spec)) as jplan:
        with pytest.raises(jax_faults.InjectedFault):
            mk_jax().run_cg(3, cg_iters=3)
    assert plan.events == jplan.events == [("als:cg_iter", "error", 7)]
    assert store.steps() == [1]
    resumed = mk_port()
    resumed.run_cg(3, cg_iters=3, checkpoint=store, resume=True)
    clean = mk_port()
    clean.run_cg(3, cg_iters=3)
    assert torch.equal(resumed.A, clean.A) and torch.equal(resumed.B, clean.B)


def test_als_step_fault_site_fires_before_each_step():
    _, _, mk_port = _als_pair("15d_fusion2")
    als = mk_port()
    with fault_plan(FaultPlan.from_spec([{"site": "als:step", "kind": "error", "at": [1]}])):
        with pytest.raises(InjectedFault, match="als:step"):
            als.run_cg(3, cg_iters=2)
        assert faults.active().call_count("als:step") == 2
        assert faults.active().call_count("als:cg_iter") == 4


def test_unfaulted_resilient_update_equals_in_place():
    """With guards on (the resilient path) the CG carries are updated out
    of place; the factors equal the in-place run's bit for bit."""
    _, _, mk_port = _als_pair("15d_fusion2")
    plain = mk_port()
    plain.run_cg(2, cg_iters=5)
    guarded = mk_port()
    with fault_plan(FaultPlan([])):
        assert guarded.d_ops.resilient()
        guarded.run_cg(2, cg_iters=5)
    assert torch.equal(plain.A, guarded.A) and torch.equal(plain.B, guarded.B)
    assert guarded.d_ops.metrics["cgStep"]["calls"] == 2 * 2 * 5
