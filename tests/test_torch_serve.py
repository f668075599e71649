"""The serving layer of the port (``serve/``, ``ops/serve_kernels.py``,
``bench serve``) on the CPU, against the JAX package's.

The contract throughout, the JAX package's: a request's reply is a function
of its payload alone, not of arrival order, micro-batch composition, batch
bucket or padding, bit for bit. The JAX ``tests/test_serve.py`` classes
run here as cases of the port. Parity: each workload against the JAX
one on the same factors, weights or context (moved across as numpy arrays
through the strategies' ``put_a``/``put_b`` and the GAT weights' interop),
within stated tolerances: the fold-in ``x`` and the ALS scores within 1e-4
of the reference's max abs value (a 0.1-ridge Gram amplifies float32
rounding), the top-k ids equal but for swaps inside such a near-tie, the
GAT and attention scores within 1e-5. The plain versions of the three serve
kernels are held to float64 versions of their formulas. Sizes are the JAX
tests': ``erdos_renyi(64, 48, 6, seed=0, values="normal")``, R = 8, p = 1
and (8, 2).
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_sddmm_tpu.models.als import DistributedALS as JaxALS
from distributed_sddmm_tpu.models.gat import GAT as JaxGAT
from distributed_sddmm_tpu.models.gat import GATLayer as JaxLayer
from distributed_sddmm_tpu.obs.telemetry import LatencyHistogram as JaxHistogram
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.programs import keys as jax_keys
from distributed_sddmm_tpu.serve import ALSFoldInTopK as JaxFoldIn
from distributed_sddmm_tpu.serve import AttentionTokenScore as JaxAttention
from distributed_sddmm_tpu.serve import GATNodeScore as JaxNodeScore
from distributed_sddmm_tpu.serve import SLOSpec as JaxSLOSpec
from distributed_sddmm_tpu.serve.workloads import _chol_solve
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.autotune.fingerprint import serve_code_hash
from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.models.gat import GAT, GATLayer
from distributed_sddmm_tpu_torch.obs import regress
from distributed_sddmm_tpu_torch.obs import watchdog as obs_watchdog
from distributed_sddmm_tpu_torch.obs.store import RunStore
from distributed_sddmm_tpu_torch.obs.telemetry import LatencyHistogram
from distributed_sddmm_tpu_torch.ops import serve_kernels
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.programs import keys
from distributed_sddmm_tpu_torch.resilience import FaultPlan, FaultSpec, fault_plan
from distributed_sddmm_tpu_torch.resilience.faults import InjectedFault
from distributed_sddmm_tpu_torch.resilience.guards import NumericalFault
from distributed_sddmm_tpu_torch.serve import (
    ALSFoldInTopK, AttentionTokenScore, GATNodeScore, RequestError, RequestQueue,
    ServingEngine, ShedError, SLOSpec, bucket_for, percentile, run_load,
)
from distributed_sddmm_tpu_torch.serve import slo as slo_mod
from distributed_sddmm_tpu_torch.serve.workloads import top_k
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.interop import gat_weights_from_reference

# No test writes into the checkout's artifacts/.
os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

#: Fold-in x and ALS scores: of the reference's max abs value.
ALS_TOL = 1e-4
#: GAT and attention scores: of max(1, the reference's max abs value).
SCORE_TOL = 1e-5
CPU = torch.device("cpu")


def _reply_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def _port_coo(S) -> HostCOO:
    return HostCOO(S.rows, S.cols, S.vals, S.M, S.N)


def _jax_problem():
    return JaxCOO.erdos_renyi(64, 48, 6, seed=0, values="normal")


def _port_alg(S, R=8, p=1, c=1):
    return DenseShift15D(_port_coo(S), R=R, c=c, fusion_approach=2, world=LocalWorld(p),
                         device="cpu")


def _close(got, want, tol, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, err / scale


def _ids_agree(got_ids, want_ids, want_scores, tol):
    """Equal ids, but for swaps between items whose reference scores lie
    within ``tol`` of each other."""
    for a, b in zip(np.asarray(got_ids), np.asarray(want_ids)):
        if a != b:
            assert abs(want_scores[a] - want_scores[b]) <= tol, (a, b)


def _modes(engine, payloads):
    """Replies one at a time, in one batch, in reverse order, and padded
    into the largest inner bucket: all must equal one another."""
    solo = [engine.execute_now([p])[0] for p in payloads]
    batched = engine.execute_now(payloads)
    reverse = engine.execute_now(payloads[::-1])[::-1]
    top = max(engine.workload.inner_buckets)
    padded = engine._dispatch(payloads, bucket_for(len(payloads), engine.batch_buckets), top)
    for got in (batched, reverse, padded):
        assert all(_reply_equal(g, w) for g, w in zip(got, solo))
    return solo


@pytest.fixture(scope="module")
def als_serving():
    """One warm port ALS fold-in workload and engine for the module."""
    S = HostCOO.erdos_renyi(64, 48, 6, seed=0, values="normal")
    model = DistributedALS(DenseShift15D(S, R=8, c=1, fusion_approach=2, device="cpu",
                                         world=LocalWorld(1)), S_host=S)
    model.run_cg(2, cg_iters=4)
    workload = ALSFoldInTopK(model, k=5, item_buckets=(4, 8), ingest_rows=False)
    engine = ServingEngine(workload, max_batch=4, max_depth=16, max_wait_ms=4.0)
    engine.warmup()
    return workload, engine


@pytest.fixture(scope="module")
def als_payloads(als_serving):
    workload, _ = als_serving
    rng = np.random.default_rng(7)
    return [workload.sample_payload(rng) for _ in range(6)]


# --------------------------------------------------------------------- #
# Queue semantics
# --------------------------------------------------------------------- #


class TestQueue:
    def test_fifo_and_batch_cap(self):
        q = RequestQueue(max_depth=8, max_batch=3, max_wait_ms=1.0)
        reqs = [q.submit(i) for i in range(5)]
        batch = q.next_batch(timeout_s=1.0)
        assert [r.req_id for r in batch] == [r.req_id for r in reqs[:3]]
        assert [r.payload for r in q.next_batch(timeout_s=1.0)] == [3, 4]

    def test_first_arrival_starts_the_clock(self):
        q = RequestQueue(max_depth=8, max_batch=4, max_wait_ms=60.0)
        t0 = time.perf_counter()
        q.submit("a")
        batch = q.next_batch(timeout_s=5.0)
        assert [r.payload for r in batch] == ["a"]
        assert time.perf_counter() - t0 < 2.0

    def test_admission_bound_sheds_with_retry_after(self):
        q = RequestQueue(max_depth=2, max_batch=2, max_wait_ms=1.0)
        q.submit("a")
        q.submit("b")
        with pytest.raises(ShedError) as ei:
            q.submit("c")
        assert ei.value.retry_after_s >= 0.0
        assert q.shed_count == 1 and q.depth() == 2

    def test_close_drains_then_returns_empty(self):
        q = RequestQueue(max_depth=4, max_batch=4, max_wait_ms=1.0)
        q.submit("a")
        q.close()
        with pytest.raises(RuntimeError):
            q.submit("b")
        assert [r.payload for r in q.next_batch(timeout_s=1.0)] == ["a"]
        assert q.next_batch(timeout_s=0.2) == []

    def test_timeline_stamps(self):
        q = RequestQueue(max_depth=4, max_batch=1, max_wait_ms=0.0)
        req = q.submit("a")
        (got,) = q.next_batch(timeout_s=1.0)
        got.t_execute = time.perf_counter()
        got.set_result("ok")
        lat = req.stage_latencies_s()
        assert set(lat) == {"queue_s", "batch_wait_s", "execute_s", "total_s"}
        assert lat["queue_s"] + lat["batch_wait_s"] + lat["execute_s"] \
            == pytest.approx(lat["total_s"], abs=1e-9)

    def test_weighted_tenants_share_a_busy_window(self):
        from distributed_sddmm_tpu_torch.serve import TenantSpec

        q = RequestQueue(max_depth=64, max_batch=8, max_wait_ms=0.0,
                         tenants=[TenantSpec("gold", 3.0), TenantSpec("free", 1.0)])
        for i in range(12):
            q.submit(i, tenant="gold")
            q.submit(i, tenant="free")
        batch = q.next_batch(timeout_s=1.0)
        assert [r.tenant for r in batch].count("gold") == 6
        with pytest.raises(ValueError, match="unknown tenant"):
            q.submit(0, tenant="typo")


class TestRetryAfterContract:
    def test_shed_hint_uses_drain_rate(self):
        q = RequestQueue(max_depth=4, max_batch=2, max_wait_ms=1.0)
        for i in range(4):
            q.submit(i)
        q.drain_rate_hint = 8.0
        with pytest.raises(ShedError) as ei:
            q.submit("x")
        assert ei.value.retry_after_s == pytest.approx(4 / 8.0)

    def test_run_load_honors_retry_after(self):
        class _Workload:
            def sample_payload(self, rng):
                return {"q": [1]}

            def check_reply(self, payload, reply):
                return True

        class _SheddingEngine:
            def __init__(self):
                self.recorder = slo_mod.LatencyRecorder()
                self.workload = _Workload()
                self.submits = 0

            def submit(self, payload, tenant=None):
                self.submits += 1
                self.recorder.record_shed()
                raise ShedError("full", retry_after_s=30.0)

        eng = _SheddingEngine()
        summary = run_load(eng, duration_s=0.4, rate_hz=50.0, seed=3, oracle_every=0,
                           honor_retry_after=True)
        assert eng.submits == 1 and summary["shed_count"] == 1
        assert summary["retry_after_deferred"] == summary["offered"] - 1
        eng2 = _SheddingEngine()
        summary2 = run_load(eng2, duration_s=0.4, rate_hz=50.0, seed=3, oracle_every=0)
        assert eng2.submits == summary2["offered"] > 1
        assert "retry_after_deferred" not in summary2


# --------------------------------------------------------------------- #
# Batching determinism and padding (the serving contract)
# --------------------------------------------------------------------- #


class TestDeterminism:
    def test_bucket_for(self):
        assert bucket_for(1, (4, 8)) == 4
        assert bucket_for(5, (4, 8)) == 8
        assert bucket_for(99, (4, 8)) == 8

    def test_any_arrival_order_bit_identical(self, als_serving, als_payloads):
        _, engine = als_serving
        base = engine.execute_now(als_payloads)
        for perm in ([3, 1, 5, 0, 2, 4], [5, 4, 3, 2, 1, 0]):
            permuted = engine.execute_now([als_payloads[i] for i in perm])
            for where, i in enumerate(perm):
                assert _reply_equal(permuted[where], base[i])

    def test_bucket_padding_never_changes_results(self, als_serving, als_payloads):
        _, engine = als_serving
        base = engine.execute_now(als_payloads)
        for i, p in enumerate(als_payloads):
            assert _reply_equal(engine.execute_now([p])[0], base[i])

    def test_padding_into_the_largest_inner_bucket(self, als_serving, als_payloads):
        _, engine = als_serving
        _modes(engine, als_payloads[:4])

    def test_replies_match_float64_oracle(self, als_serving, als_payloads):
        workload, engine = als_serving
        for p, r in zip(als_payloads, engine.execute_now(als_payloads)):
            assert workload.check_reply(p, r)

    def test_queued_path_matches_direct(self, als_serving, als_payloads):
        workload, _ = als_serving
        engine = ServingEngine(workload, max_batch=4, max_depth=16, max_wait_ms=10.0)
        base = engine.execute_now(als_payloads)
        engine.start(warmup=False)
        try:
            replies = [r.result(timeout_s=30.0)
                       for r in [engine.submit(p) for p in als_payloads]]
            assert _reply_equal(engine.serve_one(als_payloads[0]), base[0])
        finally:
            engine.stop()
        assert all(_reply_equal(g, w) for g, w in zip(replies, base))

    def test_gat_workload_determinism_and_oracle(self):
        S = HostCOO.erdos_renyi(64, 64, 5, seed=1)
        alg = DenseShift15D(S, R=8, c=1, fusion_approach=2, device="cpu",
                            world=LocalWorld(1))
        workload = GATNodeScore(GAT([GATLayer(8, 8, 2)], alg), node_buckets=(2, 4))
        engine = ServingEngine(workload, max_batch=4, max_depth=16)
        engine.warmup()
        rng = np.random.default_rng(3)
        payloads = [workload.sample_payload(rng) for _ in range(4)]
        for p, r in zip(payloads, _modes(engine, payloads)):
            assert workload.check_reply(p, r)

    @pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
    def test_attention_workload_determinism_and_oracle(self, dynamic):
        ctx = _context()
        workload = AttentionTokenScore(ctx, window=3, token_buckets=(2, 4), dynamic=dynamic,
                                       device="cpu")
        engine = ServingEngine(workload, max_batch=4, max_depth=16)
        engine.warmup()
        payloads = _attention_payloads(workload, 4, seed=5)
        for p, r in zip(payloads, _modes(engine, payloads)):
            assert workload.check_reply(p, r)


# --------------------------------------------------------------------- #
# The program ladder
# --------------------------------------------------------------------- #


class TestProgramCache:
    def test_warmup_builds_whole_ladder_then_only_hits(self, als_serving, als_payloads):
        workload, _ = als_serving
        engine = ServingEngine(workload, max_batch=4, max_depth=16, max_wait_ms=2.0)
        warmed = engine.warmup()
        stats = engine.stats()
        assert warmed == stats["programs"] == stats["cache_misses"] == 6
        assert stats["live_compiles"] == 6
        engine.execute_now(als_payloads)
        stats = engine.stats()
        assert stats["cache_misses"] == stats["live_compiles"] == 6
        assert stats["cache_hits"] > 0

    def test_key_is_the_jax_grammar(self, als_serving):
        _, engine = als_serving
        key = engine.program_key(4, 8)
        assert key.startswith("serve:als:b4:i8") and serve_code_hash() in key
        assert key == jax_keys.serve_program_key("als", 4, 8, 8, "cpu", code=serve_code_hash(),
                                                 params="k5-l0.1")
        assert keys.parse_serve_key(key) == jax_keys.parse_serve_key(key)

    def test_key_carries_the_strategy_wire_label(self):
        """The serve keys' wire segment: a ladder warmed over a bf16-wire
        strategy never answers for an f32 one (the JAX package's grammar)."""
        from distributed_sddmm_tpu_torch.bench.harness import make_algorithm

        S = HostCOO.erdos_renyi(64, 48, 6, seed=0, values="normal")
        for wire, label in (("bf16", "bf16"), ("f32", None)):
            model = DistributedALS(make_algorithm("15d_fusion2", S, 8, wire=wire, device="cpu",
                                                  world=LocalWorld(1)))
            model.initialize_embeddings()
            workload = ALSFoldInTopK(model, k=5, item_buckets=(4, 8))
            assert workload.wire == label
            key = ServingEngine(workload).program_key(1, 8)
            assert key == jax_keys.serve_program_key(
                "als", 1, 8, 8, "cpu", code=serve_code_hash(), params="k5-l0.1", wire=label)
            assert (":wbf16" in key) == (wire == "bf16")

    def test_dynamic_attention_key_carries_its_capacity(self):
        workload = AttentionTokenScore(_context(), window=3, dynamic=True, device="cpu")
        key = ServingEngine(workload).program_key(1, 4)
        assert keys.parse_serve_key(key)["cap"] == "w3.n128"
        assert ":pw3-dyn" in key


# --------------------------------------------------------------------- #
# Resilience: transient heal, the last rung, the engine never dies
# --------------------------------------------------------------------- #


class TestFaultedEngine:
    def test_transient_faults_heal_bit_identical(self, als_serving, als_payloads):
        _, engine = als_serving
        want = engine.execute_now(als_payloads[:2])
        plan = FaultPlan([
            FaultSpec(site="execute:serveBatch", kind="timeout", at=(0,)),
            FaultSpec(site="output:serveBatch", kind="nan", at=(1,), param=0.2),
        ])
        with fault_plan(plan):
            got = engine.execute_now(als_payloads[:2])
        assert {k for _, k, _ in plan.events} == {"timeout", "nan"}
        assert all(_reply_equal(a, b) for a, b in zip(got, want))

    def test_persistent_fault_degrades_to_serial_on_the_cpu(self, als_serving, als_payloads):
        workload, _ = als_serving
        engine = ServingEngine(workload, max_batch=4, max_depth=16, max_wait_ms=2.0,
                               exec_retries=1)
        plan = FaultPlan([FaultSpec(site="execute:serveBatch", kind="error", prob=1.0)])
        engine.start(warmup=False)
        try:
            with fault_plan(plan):
                req = engine.submit(als_payloads[0])
                reply = req.result(timeout_s=30.0)
        finally:
            engine.stop()
        assert req.degraded is True and engine.degraded_batches >= 1
        assert engine.error_batches == 0
        assert _reply_equal(reply, workload.serial(als_payloads[0]))
        assert workload.check_reply(als_payloads[0], reply)

    def test_exhausted_batch_on_the_card_is_an_error_reply(self, als_serving, als_payloads,
                                                           monkeypatch):
        """On the card the last rung is no host answer: every request of the
        batch gets a RequestError carrying a NumericalFault, the batch counts
        in error_batches, not degraded_batches (the card's own run of the
        serving path is ``chip_smoke.py``'s phase serve)."""
        workload, _ = als_serving
        engine = ServingEngine(workload, max_batch=4, max_depth=16, max_wait_ms=1.0)

        def exhausted(*a, **kw):
            raise InjectedFault("injected fault at execute:serveBatch")

        def no_host(payload):
            raise AssertionError("the serial rung ran for an engine on the card")

        monkeypatch.setattr(engine, "device", torch.device("cuda"))
        monkeypatch.setattr(engine, "_dispatch", exhausted)
        monkeypatch.setattr(workload, "serial", no_host)
        reqs = [engine.submit(p) for p in als_payloads[:3]]
        batch = engine.queue.next_batch(timeout_s=1.0)
        engine._serve_batch(batch)
        for req in reqs:
            with pytest.raises(RequestError, match="no host fallback") as err:
                req.result(timeout_s=1.0)
            assert isinstance(err.value.cause, NumericalFault)
            assert isinstance(err.value.cause.__cause__, InjectedFault)
            assert req.degraded is False
        stats = engine.stats()
        assert stats["error_batches"] >= 1 and stats["degraded_batches"] == 0
        engine.queue.close()

    def test_faulted_load_run_stays_up(self, als_serving):
        workload, _ = als_serving
        engine = ServingEngine(workload, max_batch=4, max_depth=8, max_wait_ms=2.0)
        plan = FaultPlan.from_spec("delay,nan")
        engine.start(warmup=False)
        try:
            with fault_plan(plan):
                summary = run_load(engine, duration_s=1.2, rate_hz=40, seed=5, oracle_every=3)
        finally:
            engine.stop()
        assert summary["errors"] == 0 and summary["oracle_failures"] == 0
        assert summary["completed"] + summary["shed_count"] == summary["requests"]
        assert len(plan.events) > 0


# --------------------------------------------------------------------- #
# Watchdog: queue-depth runaway
# --------------------------------------------------------------------- #


class TestQueueRunaway:
    def test_sustained_depth_fires_once_and_rearms(self):
        wd = obs_watchdog.Watchdog(mode="warn", queue_frac=0.5, queue_patience=3)
        for _ in range(5):
            wd.observe_queue(6, 10)
        assert [e["kind"] for e in wd.events].count("queue_runaway") == 1
        wd.observe_queue(1, 10)
        for _ in range(3):
            wd.observe_queue(9, 10)
        assert [e["kind"] for e in wd.events].count("queue_runaway") == 2

    def test_brief_spike_does_not_fire(self):
        wd = obs_watchdog.Watchdog(mode="warn", queue_frac=0.5, queue_patience=3)
        for _ in range(10):
            wd.observe_queue(6, 10)
            wd.observe_queue(0, 10)
        assert not wd.events

    def test_strict_mode_escalates(self):
        wd = obs_watchdog.Watchdog(mode="strict", queue_frac=0.5, queue_patience=2)
        wd.observe_queue(8, 10)
        with pytest.raises(obs_watchdog.WatchdogAlarm):
            wd.observe_queue(8, 10)
        assert wd.summary()["anomalies"][0]["kind"] == "queue_runaway"

    def test_engine_submit_feeds_the_watchdog(self, als_serving):
        workload, _ = als_serving
        engine = ServingEngine(workload, max_batch=2, max_depth=8)
        obs_watchdog.enable("warn", queue_frac=0.25, queue_patience=2)
        try:
            rng = np.random.default_rng(0)
            for _ in range(6):
                engine.submit(workload.sample_payload(rng))
            assert any(e["kind"] == "queue_runaway" for e in obs_watchdog.active().events)
        finally:
            obs_watchdog.disable()
            engine.queue.close()


# --------------------------------------------------------------------- #
# SLO machinery
# --------------------------------------------------------------------- #


class TestSLO:
    def test_percentile_nearest_rank(self):
        xs = [float(i) for i in range(1, 101)]
        assert percentile(xs, 50) == 50.0 and percentile(xs, 99) == 99.0
        assert percentile([], 50) is None

    def test_parse_and_check(self):
        spec = SLOSpec.parse("p99_ms=10, err_rate=0.01")
        assert spec.p99_ms == 10.0 and spec.err_rate == 0.01
        viol = spec.check({"latency_ms": {"p99": 12.0}, "err_rate": 0.0, "shed_rate": 0.5})
        assert [v["axis"] for v in viol] == ["p99_ms"]
        assert spec.check({"latency_ms": {"p99": 9.0}, "err_rate": 0.0}) == []

    def test_parse_rejects_unknown_keys(self):
        with pytest.raises(ValueError):
            SLOSpec.parse("p98_ms=10")
        with pytest.raises(ValueError):
            SLOSpec.parse("p99_ms")

    def test_env_spec(self, monkeypatch):
        monkeypatch.setenv("SDDMM_TORCH_SLO", "p50_ms=5,shed_rate=0.1")
        spec = SLOSpec.from_env()
        assert spec.p50_ms == 5.0 and spec.shed_rate == 0.1

    def test_tenants_and_burn_rate(self, monkeypatch):
        monkeypatch.setenv("SDDMM_TORCH_TENANTS", "premium:3:p99_ms=250;batch")
        tenants = slo_mod.tenants_from_env()
        assert tenants["premium"].weight == 3.0 and tenants["premium"].slo.p99_ms == 250.0
        assert tenants["batch"].weight == 1.0 and tenants["batch"].slo is None
        hist = LatencyHistogram()
        for ms in (1.0, 3.0, 300.0, 600.0):
            hist.add(ms)
        summary = {"request_hist": hist.to_dict(), "err_rate": 0.0}
        # 300 and 600 ms lie in buckets wholly above 250 ms (250-500 and
        # 500-1000): 50% bad against a 1% budget, as the JAX spec reads it.
        assert SLOSpec.parse("p99_ms=250").burn_rate(summary) == pytest.approx(50.0)
        assert JaxSLOSpec.parse("p99_ms=250").burn_rate(summary) == pytest.approx(50.0)

    def test_histogram_equals_the_jax_one(self):
        rng = np.random.default_rng(2)
        got, want = LatencyHistogram(), JaxHistogram()
        for ms in rng.lognormal(2.0, 2.0, size=500):
            got.add(float(ms))
            want.add(float(ms))
        assert got.counts == want.counts and got.bounds_ms == want.bounds_ms
        for pct in (50, 95, 99):
            assert got.quantile_ms(pct) == want.quantile_ms(pct)
        assert got.fraction_above(100.0) == want.fraction_above(100.0)
        assert got.merge(got).total == 1000
        assert LatencyHistogram.from_dict(got.to_dict()) == got


class TestBackpressure:
    def test_overload_sheds_instead_of_queueing_forever(self, als_serving):
        workload, _ = als_serving
        engine = ServingEngine(workload, max_batch=2, max_depth=4, max_wait_ms=1.0)
        rng = np.random.default_rng(1)
        shed = 0
        for _ in range(12):
            try:
                engine.submit(workload.sample_payload(rng))
            except ShedError as e:
                shed += 1
                assert e.retry_after_s >= 0.0
        assert shed == 8 and engine.recorder.shed == 8 and engine.queue.depth() == 4
        engine.queue.close()

    def test_out_of_range_ids_are_refused_at_admission(self, als_serving):
        workload, _ = als_serving
        engine = ServingEngine(workload, max_batch=2, max_depth=4)
        with pytest.raises(ValueError, match="item ids"):
            engine.submit({"items": np.array([0, workload.N]), "ratings": np.ones(2)})
        assert engine.queue.depth() == 0
        engine.queue.close()


# --------------------------------------------------------------------- #
# Gate integration: the serving verdict axes
# --------------------------------------------------------------------- #


def _serve_doc(run_id: str, p99_ms: float, shed_rate: float = 0.0, key: str = "sk1") -> dict:
    return {
        "run_id": run_id, "key": key, "backend": "cpu", "code_hash": "c1",
        "record": {
            "app": "serve-als", "algorithm": "15d_fusion2", "R": 16, "c": 1, "fused": True,
            "kernel": "cuda-f32", "requests": 100, "shed_rate": shed_rate,
            "shed_count": int(shed_rate * 100),
            "latency_ms": {"p50": p99_ms / 2, "p99": p99_ms}, "metrics": {},
        },
    }


class TestServingGate:
    def test_phase_stats_exposes_serving_axes(self):
        rows = regress.phase_stats(_serve_doc("a", 10.0, 0.05))
        assert rows["serve:latency_p99"]["t_call"] == pytest.approx(0.010)
        assert rows["serve:latency_p50"]["t_call"] == pytest.approx(0.005)
        assert rows["serve:shed_rate"]["t_call"] == pytest.approx(0.05)

    def test_latency_regression_gates(self, tmp_path):
        store = RunStore(tmp_path)
        for i in range(3):
            store.put(_serve_doc(f"base-{i}", 10.0))
        bad = _serve_doc("new", 25.0)
        store.put(bad)
        code, report = regress.gate(store, bad, k=3)
        assert code == regress.GATE_REGRESSION
        assert "serve:latency_p99" in report["regressions"]
        assert report["phases"]["serve:latency_p99"]["attribution"] == "serving"

    def test_shed_storm_gates(self, tmp_path):
        store = RunStore(tmp_path)
        for i in range(3):
            store.put(_serve_doc(f"base-{i}", 10.0, shed_rate=0.0))
        bad = _serve_doc("new", 10.0, shed_rate=0.3)
        store.put(bad)
        code, report = regress.gate(store, bad, k=3)
        assert code == regress.GATE_REGRESSION and "serve:shed_rate" in report["regressions"]

    def test_steady_serving_passes(self, tmp_path):
        store = RunStore(tmp_path)
        for i in range(3):
            store.put(_serve_doc(f"base-{i}", 10.0))
        ok = _serve_doc("new", 10.5)
        store.put(ok)
        assert regress.gate(store, ok, k=3)[0] == regress.GATE_PASS

    def test_index_rows_carry_serving_fields(self, tmp_path):
        store = RunStore(tmp_path)
        store.put(_serve_doc("a", 12.5, shed_rate=0.02))
        (row,) = store.index()
        assert row["latency_p99_ms"] == 12.5 and row["shed_count"] == 2


class TestFaultShorthand:
    def test_kind_list_expands(self):
        plan = FaultPlan.from_spec("delay,nan")
        assert {(s.site, s.kind) for s in plan.specs} == {("execute:*", "delay"),
                                                          ("output:*", "nan")}
        assert all(s.prob > 0 for s in plan.specs)

    def test_json_specs_still_parse(self):
        plan = FaultPlan.from_spec('[{"site": "execute:*", "kind": "timeout", "at": [0]}]')
        assert plan.specs[0].kind == "timeout"

    def test_unknown_word_falls_through_to_json_error(self):
        with pytest.raises(ValueError):
            FaultPlan.from_spec("delay,frobnicate")


def test_served_users_are_folded_into_live_matrix():
    S = HostCOO.erdos_renyi(48, 32, 5, seed=2, values="normal")
    model = DistributedALS(DenseShift15D(S, R=8, c=1, fusion_approach=2, device="cpu",
                                         world=LocalWorld(1)), S_host=S)
    model.initialize_embeddings()
    workload = ALSFoldInTopK(model, k=3, item_buckets=(4, 8), ingest_rows=True)
    engine = ServingEngine(workload, max_batch=4, max_depth=8, max_wait_ms=2.0)
    rng = np.random.default_rng(4)
    payloads = [workload.sample_payload(rng) for _ in range(3)]
    M0, nnz0 = S.M, S.nnz
    engine.start(warmup=False)
    try:
        for r in [engine.submit(p) for p in payloads]:
            r.result(timeout_s=30.0)
    finally:
        engine.stop()
    assert S.M == M0 + 3
    assert S.nnz == nnz0 + sum(len(p["items"]) for p in payloads)
    got = {(int(r), int(c)): v for r, c, v in zip(S.rows[nnz0:], S.cols[nnz0:], S.vals[nnz0:])}
    want = {(M0 + i, int(c)): float(v) for i, p in enumerate(payloads)
            for c, v in zip(p["items"], p["ratings"])}
    assert got == pytest.approx(want)


def test_append_rows_grows_one_buffer_and_keeps_earlier_views():
    S = HostCOO.erdos_renyi(16, 8, 2, seed=0)
    rows0 = S.rows
    S.append_rows([np.array([1, 2])], [np.array([1.0, 2.0])])
    first = S.rows
    S.append_rows([np.array([3])], [np.array([3.0])])
    assert np.array_equal(rows0, S.rows[: rows0.size])
    assert np.array_equal(first, S.rows[: first.size]) and S.rows.base is first.base
    assert S.M == 18 and S.nnz == rows0.size + 3
    assert np.array_equal(S.cols[-3:], [1, 2, 3]) and np.array_equal(S.vals[-3:], [1, 2, 3])
    assert np.array_equal(S.rows[-3:], [16, 16, 17])
    S.reserve(100)
    base, n = S.rows.base, S.nnz
    S.append_rows([np.arange(8)] * 10, [np.ones(8)] * 10)
    assert S.rows.base is base and S.nnz == n + 80 and S.M == 28


# --------------------------------------------------------------------- #
# Parity with the JAX package
# --------------------------------------------------------------------- #


def _jax_fold_in(B, idx, ratings, mask, lam):
    rows = B[idx] * mask[..., None]
    gram = jnp.einsum("blr,bls->brs", rows, rows) + lam * jnp.eye(B.shape[1], dtype=B.dtype)
    rhs = jnp.einsum("blr,bl->br", rows, ratings * mask)
    x = _chol_solve(gram, rhs)
    return np.asarray(x), np.asarray(jnp.sum(x[:, None, :] * B[None, :, :], axis=-1))


def _masked(scores, idx, mask):
    out = np.array(scores, dtype=np.float64)
    for i in range(out.shape[0]):
        out[i, idx[i][mask[i] > 0]] = -np.inf
    return out


def _compare_als(jw, pw, payloads, bb, ib):
    """The fold-in x, the scores and the replies of one cell, the port's
    against the JAX package's."""
    B, idx, ratings, mask = jw.pad_batch(payloads, bb, ib)
    x_want, s_want = _jax_fold_in(B, jnp.asarray(idx), jnp.asarray(ratings),
                                  jnp.asarray(mask), jw.ridge_lambda)
    PB, *host = pw.pad_batch(payloads, bb, ib)
    pidx, prat, pmask = (torch.from_numpy(a) for a in host)
    x = serve_kernels.fold_in_solve(PB, pidx, prat, pmask, pw.ridge_lambda)
    _close(x, x_want, ALS_TOL)
    _close(serve_kernels.score_rows(x, PB), s_want, ALS_TOL)
    want_vals, want_ids = (np.asarray(a) for a in jw.build_program(bb, ib)(
        B, idx, ratings, mask))
    got_vals, got_ids = (t.numpy() for t in pw.build_program(bb, ib)(PB, *host))
    ref = _masked(s_want, idx, mask)
    tol = ALS_TOL * float(np.abs(s_want).max())
    for i in range(len(payloads)):
        _ids_agree(got_ids[i], want_ids[i], ref[i], tol)
        _close(got_vals[i], want_vals[i], ALS_TOL, floor=float(np.abs(s_want).max()))
    return ref, got_ids


@pytest.mark.parametrize("p,c", [(1, 1), (8, 2)], ids=["p1", "8x2"])
def test_als_fold_in_matches_jax(p, c):
    S = _jax_problem()
    jalg = JaxDS(S, R=8, c=c, fusion_approach=2, devices=jax.devices()[:p])
    jmodel = JaxALS(jalg, S_host=S)
    jmodel.run_cg(2, cg_iters=4)
    jw = JaxFoldIn(jmodel, k=5, item_buckets=(4, 8), ingest_rows=False)
    alg = _port_alg(S, p=p, c=c)
    model = DistributedALS(alg, S_host=_port_coo(S))
    model.A = alg.put_a(jalg.host_a(jmodel.A))
    model.B = alg.put_b(jmodel.item_factors())
    pw = ALSFoldInTopK(model, k=5, item_buckets=(4, 8), ingest_rows=False)
    assert np.array_equal(pw._B_host, jw._B_host)
    rng = np.random.default_rng(7)
    payloads = [jw.sample_payload(rng) for _ in range(4)]
    _compare_als(jw, pw, payloads, 4, 8)
    for payload in payloads:
        assert pw.check_reply(payload, ServingEngine(pw).execute_now([payload])[0])


def _stub_model(B: np.ndarray):
    """A warm-model stand-in: the item factors, shape and ridge the fold-in
    workloads of both packages read."""
    d_ops = types.SimpleNamespace(N=B.shape[0], R=B.shape[1], device=CPU)
    return types.SimpleNamespace(B=B, item_factors=lambda: B, d_ops=d_ops,
                                 ridge_lambda=1e-6, S_host=None)


def test_tie_rich_fold_in_matches_jax():
    """Integer-valued factors with every row repeated: the scores tie
    exactly in both packages, and both keep the lower item id first."""
    rng = np.random.default_rng(3)
    B = np.repeat(rng.integers(-1, 2, size=(8, 8)), 6, axis=0).astype(np.float32)
    B = B[rng.permutation(B.shape[0])]
    jw = JaxFoldIn(_stub_model(B), k=5, item_buckets=(4, 8), ingest_rows=False)
    pw = ALSFoldInTopK(_stub_model(B), k=5, item_buckets=(4, 8), ingest_rows=False)
    payloads = [{"items": rng.choice(48, size=3, replace=False),
                 "ratings": rng.integers(-2, 3, size=3).astype(np.float64)}
                for _ in range(4)]
    ref, got_ids = _compare_als(jw, pw, payloads, 4, 4)
    tied = sum(int(np.sum(row[got_ids[i]] == row[got_ids[i][0]])) > 1
               for i, row in enumerate(ref))
    assert tied >= 2  # the case really is tie-rich


def test_top_k_rule_equals_jax_lax_top_k():
    rng = np.random.default_rng(0)
    scores = rng.integers(-3, 4, size=(6, 40)).astype(np.float32)
    scores[:, ::7] = -np.inf
    want_vals, want_ids = jax.lax.top_k(jnp.asarray(scores), 9)
    got_vals, got_ids = top_k(torch.from_numpy(scores), 9)
    assert np.array_equal(got_vals.numpy(), np.asarray(want_vals))
    assert np.array_equal(got_ids.numpy(), np.asarray(want_ids))


def test_gat_node_scores_match_jax():
    S = JaxCOO.erdos_renyi(64, 64, 5, seed=1)
    jalg = JaxDS(S, R=8, c=1, fusion_approach=2, devices=jax.devices()[:1])
    jgat = JaxGAT([JaxLayer(8, 8, 2)], jalg)
    jw = JaxNodeScore(jgat, node_buckets=(2, 4))
    gat = GAT([GATLayer(8, 8, 2)], _port_alg(S))
    for layer, ws in zip(gat.layers, gat_weights_from_reference(
            [[np.asarray(w) for w in layer.weights] for layer in jgat.layers], device="cpu")):
        layer.weights = ws
    pw = GATNodeScore(gat, node_buckets=(2, 4))
    rng = np.random.default_rng(3)
    payloads = [jw.sample_payload(rng) for _ in range(4)]
    want = np.asarray(jw.build_program(4, 4)(*jw.pad_batch(payloads, 4, 4)))
    (got,) = pw.build_program(4, 4)(*pw.pad_batch(payloads, 4, 4))
    _close(got.numpy(), want, SCORE_TOL, floor=1.0)


def _context(n: int = 96, R: int = 8, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, R)) / np.sqrt(R)).astype(np.float32)


def _attention_payloads(workload, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    payloads = [workload.sample_payload(rng) for _ in range(n)]
    if workload.dynamic:  # a mix of both families, ties at topk thresholds included
        for i, p in enumerate(payloads):
            p["mask"] = f"window:{i % 4}" if i % 2 else f"topk:{1 + 2 * i}"
    return payloads


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_attention_token_scores_match_jax(dynamic):
    ctx = _context()
    jw = JaxAttention(ctx, window=3, token_buckets=(2, 4), dynamic=dynamic)
    pw = AttentionTokenScore(ctx, window=3, token_buckets=(2, 4), dynamic=dynamic,
                             device="cpu")
    assert np.array_equal(pw._w_host, jw._w_host)
    assert pw.program_params() == jw.program_params()
    assert pw.capacity_segment == jw.capacity_segment
    payloads = _attention_payloads(pw, 4, seed=9)
    want = np.asarray(jw.build_program(4, 4)(*jw.pad_batch(payloads, 4, 4)))
    (got,) = pw.build_program(4, 4)(*pw.pad_batch(payloads, 4, 4))
    _close(got.numpy(), want, SCORE_TOL, floor=1.0)
    for p in payloads:
        _close(pw.oracle(p)["scores"], jw.oracle(p)["scores"], 1e-12, floor=1.0)


def test_attention_rebind_within_and_past_the_rung():
    ctx = _context(n=100)
    workload = AttentionTokenScore(ctx, window=3, token_buckets=(2, 4), dynamic=True,
                                   device="cpu")
    engine = ServingEngine(workload, max_batch=2)
    engine.warmup()
    grown = _context(n=120, seed=1)
    report = engine.rebind_structure(grown)
    assert report == {"fit": True, "n_ctx": 120, "ctx_cap": 128}
    assert engine.stats()["cache_misses"] == len(engine._programs)
    fresh = ServingEngine(AttentionTokenScore(grown, window=3, token_buckets=(2, 4),
                                              dynamic=True, device="cpu"), max_batch=2)
    payloads = [{"tokens": np.array([0, 119]), "mask": "topk:3"}, {"tokens": np.array([60])}]
    assert all(_reply_equal(a, b) for a, b in zip(engine.execute_now(payloads),
                                                  fresh.execute_now(payloads)))
    report = engine.rebind_structure(_context(n=200, seed=2))
    assert report["fit"] is False and report["ctx_cap"] == 256 and engine.warmed
    with pytest.raises(ValueError, match="dynamic=True"):
        AttentionTokenScore(ctx, window=3, device="cpu").rebind_structure(grown)


# --------------------------------------------------------------------- #
# The plain versions against float64
# --------------------------------------------------------------------- #


def test_fold_in_plain_matches_float64():
    rng = np.random.default_rng(5)
    B = rng.standard_normal((40, 8)).astype(np.float32)
    idx = rng.integers(0, 40, size=(3, 6)).astype(np.int32)
    ratings = rng.standard_normal((3, 6)).astype(np.float32)
    mask = np.ones((3, 6), np.float32)
    mask[1, 4:] = 0.0
    mask[2] = 0.0  # a padded row: x = 0
    got = serve_kernels.fold_in_solve_plain(
        torch.from_numpy(B), torch.from_numpy(idx), torch.from_numpy(ratings),
        torch.from_numpy(mask), 0.1).numpy()
    for i in range(3):
        rows = B[idx[i]].astype(np.float64) * mask[i][:, None]
        gram = rows.T @ rows + 0.1 * np.eye(8)
        want = np.linalg.solve(gram, rows.T @ (ratings[i] * mask[i]))
        _close(got[i], want, 1e-5, floor=1e-30)
    assert not np.any(got[2])


def test_score_rows_plain_matches_float64():
    rng = np.random.default_rng(6)
    Q = rng.standard_normal((3, 8)).astype(np.float32)
    T = rng.standard_normal((20, 8)).astype(np.float32)
    tidx = rng.integers(0, 20, size=11).astype(np.int32)
    got = serve_kernels.score_rows_plain(torch.from_numpy(Q), torch.from_numpy(T),
                                         torch.from_numpy(tidx)).numpy()
    _close(got, Q.astype(np.float64) @ T[tidx].astype(np.float64).T, 1e-6)
    out = torch.full((3, 25), 7.0)
    view = serve_kernels.score_rows(torch.from_numpy(Q), torch.from_numpy(T), out=out)
    assert view.shape == (3, 20) and bool((out[:, 20:] == 7.0).all())
    _close(view.numpy(), Q.astype(np.float64) @ T.astype(np.float64).T, 1e-6)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_window_score_plain_matches_float64(dynamic):
    workload = AttentionTokenScore(_context(), window=3, token_buckets=(2, 4),
                                   dynamic=dynamic, device="cpu")
    payloads = _attention_payloads(workload, 4, seed=2)
    (got,) = workload.build_program(4, 4)(*workload.pad_batch(payloads, 4, 4))
    for i, p in enumerate(payloads):
        want = workload.oracle(p)["scores"]
        _close(got[i, : len(want)].numpy(), want, SCORE_TOL, floor=1.0)


def test_wrappers_run_plain_on_cpu_and_refuse_other_devices():
    serve_kernels.reset_launch_counts()
    B = torch.randn(10, 8)
    idx = torch.zeros(2, 4, dtype=torch.int32)
    ones = torch.ones(2, 4)
    serve_kernels.fold_in_solve(B, idx, ones, ones, 0.1)
    serve_kernels.score_rows(B[:2], B)
    serve_kernels.window_score(B, B[0], idx, ones, 10, 2)
    assert serve_kernels.launch_counts() == dict.fromkeys(serve_kernels.LAUNCHES, 0)
    meta = torch.device("meta")
    Bm, im, om = B.to(meta), idx.to(meta), ones.to(meta)
    for call in (lambda: serve_kernels.fold_in_solve(Bm, im, om, om, 0.1),
                 lambda: serve_kernels.score_rows(Bm[:2], Bm),
                 lambda: serve_kernels.window_score(Bm, Bm[0], im, om, 10, 2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert serve_kernels.fold_in_smem_bytes(64, 128) == 99840


# --------------------------------------------------------------------- #
# bench serve
# --------------------------------------------------------------------- #


def _serve_argv(app: str, *extra) -> list:
    return ["serve", "--app", app, "--log-m", "6", "--edge-factor", "6", "--R", "8",
            "--duration", "0.8", "--rate", "30", "--max-batch", "4", "--train-steps", "1",
            "--oracle-every", "2", "--device", "cpu", *extra]


@pytest.mark.parametrize("app", ["als", "gat", "attention"])
def test_bench_serve_runs_and_records(app, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SDDMM_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.setenv("SDDMM_TORCH_RUNSTORE", str(tmp_path / "store"))
    out = tmp_path / "rec.jsonl"
    extra = ["--mask", "window:4", "--window", "2"] if app == "attention" else []
    assert cli.main(_serve_argv(app, *extra, "-o", str(out))) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = json.loads(out.read_text().splitlines()[-1])
    assert printed["app"] == rec["app"] == f"serve-{app}"
    assert rec["errors"] == rec["oracle_failures"] == rec["degraded_count"] == 0
    assert rec["oracle_checked"] > 0 and rec["completed"] > 0
    assert rec["engine"]["live_compiles"] == 12 and rec["device"] == "cpu"
    assert rec["mask"] == ("window:4" if app == "attention" else None)
    (row,) = RunStore(tmp_path / "store").index()
    assert row["app"] == f"serve-{app}" and row["latency_p99_ms"] == rec["latency_ms"]["p99"]


def test_bench_serve_slo_violation_exits_2(tmp_path, monkeypatch):
    monkeypatch.setenv("SDDMM_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    assert cli.main(_serve_argv("gat", "--slo", "p50_ms=0.000001", "--no-runstore")) == 2


@pytest.mark.parametrize("flag", [["--telemetry"], ["--telemetry-interval", "1"],
                                  ["--admin-port", "0"], ["--serve-http"], ["--tuner"]],
                         ids=lambda f: f[0])
def test_bench_serve_refuses_flags_not_ported(flag, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(_serve_argv("als", *flag))
    assert e.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err
