"""The closed-loop tuner of the port (``tuner/``, the engine's hooks,
``rank_candidates_realized``, the ``walk_idle_frac`` gauge and ``bench
tune``) on the CPU, against the JAX package where the two compute the
same thing.

The adapt run follows the JAX ``scripts/tune_smoke.py`` at its size: a
generic incumbent on a skewed R-mat (log_m 10, edge factor 4, R 8) serves
an open-loop load with the tuner armed and ``counted`` trials; the tuner
must promote the banked variant the JAX package selects for the problem,
replies must stay the same bytes through the swap, no cell may be built
on the request path, and the plan cache must hold the banked plan. A NaN
at ``output:tunerShadow`` must block the promotion and dump a flight
record.
"""

import os
import time
import types

import numpy as np
import pytest

from distributed_sddmm_tpu.autotune.fingerprint import Problem as JaxProblem
from distributed_sddmm_tpu.codegen import variant_ids_for as jax_variant_ids_for
from distributed_sddmm_tpu.tuner import shadow as jax_shadow
from distributed_sddmm_tpu.tuner.loop import TunerConfig as JaxTunerConfig
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.autotune import Problem
from distributed_sddmm_tpu_torch.autotune import candidates as cand_mod
from distributed_sddmm_tpu_torch.autotune.cache import PlanCache
from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.codegen.variants import estimated_pad_frac
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.obs import flightrec
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.resilience import FaultPlan, fault_plan
from distributed_sddmm_tpu_torch.serve import ALSFoldInTopK, ServingEngine, run_load
from distributed_sddmm_tpu_torch.tuner import (
    BackgroundTuner, ShadowSession, StaleChallenger, TunerConfig, mine_engine, mine_watchdog,
)
from distributed_sddmm_tpu_torch.tuner import retune as retune_mod
from distributed_sddmm_tpu_torch.tuner import signals as signals_mod
from distributed_sddmm_tpu_torch.tuner.shadow import _reply_equal
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

GRAPH500 = dict(a=0.57, b=0.19, c=0.19, d=0.05)
#: The adapt run's problem: the JAX ``tune_smoke.py``'s.
SMOKE = {"log_m": 10, "edge_factor": 4, "R": 8}


def _bad_incumbent():
    """A warm ALS serving stack on the generic walk over a skewed R-mat."""
    S = HostCOO.rmat(SMOKE["log_m"], SMOKE["edge_factor"], seed=0, **GRAPH500)
    alg = DenseShift15D(S, R=SMOKE["R"], c=1, kernel=CudaTileKernel("f32", device="cpu"),
                        device="cpu", world=LocalWorld(1))
    model = DistributedALS(alg, S_host=S)
    model.initialize_embeddings()
    workload = ALSFoldInTopK(model, k=5, item_buckets=(8,), ingest_rows=False)
    return S, model, workload, ServingEngine(workload, max_batch=2, max_depth=32,
                                             max_wait_ms=2.0)


def _bytes(reply: dict) -> dict:
    return {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes()) for k, v in reply.items()}


F32 = np.float32
REPLY_PAIRS = [
    ({"a": np.arange(3)}, {"a": np.arange(3)}),
    ({"a": np.arange(3)}, {"a": np.arange(3), "b": 1}),
    ({"a": np.arange(3)}, {"a": np.arange(3).astype(np.int32)}),
    ({"a": np.ones(3, F32)}, {"a": np.ones((1, 3), F32)}),
    ({"a": np.array([1.0, np.nan], F32)}, {"a": np.array([1.0, np.nan], F32)}),
    ({"a": np.array([0.0], F32)}, {"a": np.array([-0.0], F32)}),
    ({"a": np.array([1.0, 2.0], F32)}, {"a": np.array([1.0, 2.0000002], F32)}),
    ({"s": np.float32(1.5), "i": np.int64(2)}, {"s": np.float32(1.5), "i": np.int64(2)}),
]


@pytest.mark.parametrize("a,b", REPLY_PAIRS)
def test_reply_equal_matches_jax(a, b):
    assert _reply_equal(a, b) == jax_shadow._reply_equal(a, b)
    assert _reply_equal(b, a) == jax_shadow._reply_equal(b, a)


def test_config_fields_and_env_knobs(monkeypatch):
    jax_fields = {f.name for f in JaxTunerConfig.__dataclass_fields__.values()}
    assert jax_fields <= set(TunerConfig.__dataclass_fields__)
    for name, value in (("INTERVAL", "0.5"), ("LANE_FRAC", "2.5"), ("SHADOW_N", "7"),
                        ("BUDGET", "9"), ("COOLDOWN", "3"), ("GAP", "0.25"),
                        ("TRIAL", "counted")):
        monkeypatch.setenv(f"SDDMM_TORCH_TUNER_{name}", value)
        monkeypatch.setenv(f"DSDDMM_TUNER_{name}", "999")  # the JAX names are not read
    cfg = TunerConfig.from_env(top_k=2)
    assert (cfg.interval_s, cfg.lane_frac, cfg.shadow_samples, cfg.budget_s, cfg.cooldown_s,
            cfg.gap_factor, cfg.trial, cfg.top_k) == (0.5, 2.5, 7, 9.0, 3.0, 0.25, "counted", 2)
    assert retune_mod.default_trial_mode("cpu") == "counted"
    with pytest.raises(ValueError):
        retune_mod.select_trial_fn("fast")


def test_wall_trial_is_the_autotuner_trial_fastest_pair_counted():
    """``wall`` is ``autotune/measure.py::default_trial``, the one measured
    trial (``bench tune``, the live tuner and ``get_plan(mode="measure")``):
    every timed pair in order, the fastest counted."""
    from distributed_sddmm_tpu_torch.autotune import measure as measure_mod

    fn = retune_mod.select_trial_fn("wall", device="cpu", world=LocalWorld(1))
    assert fn.func is measure_mod.default_trial
    S = HostCOO.rmat(6, 4, seed=0)
    rec = fn(S, Problem.from_coo(S, 8), cand_mod.Candidate("15d_fusion2", 1, "cuda-f32"), 3, 1)
    assert rec["trial"] == "wall" and len(rec["pairs_ms"]) == 3
    assert rec["ms_per_pair"] == min(rec["pairs_ms"])
    assert rec["overall_throughput"] == pytest.approx(4.0 * S.nnz * 8 / rec["ms_per_pair"] / 1e6)


def test_gauge_threshold_separates_uniform_from_graph500_at_2_16():
    """The trigger at the size the card's tuner leg runs: the counted idle
    share of the generic walk (p = 1: one tile, the whole matrix) is 0.105
    on a uniform R-mat 2**16 and 44.9 on Graph500's, either side of the
    default threshold 1.0."""
    threshold = TunerConfig().lane_frac
    got = {}
    for name, kw in (("uniform", {}), ("graph500", GRAPH500)):
        S = HostCOO.rmat(16, 32, seed=0, **kw)
        frac = retune_mod.counted_pad_frac(S, cand_mod.Candidate("15d_fusion2", 1, "cuda-bf16"))
        assert frac == pytest.approx(estimated_pad_frac(Problem.from_coo(S, 128), banked=False))
        got[name] = frac
    assert got["uniform"] == pytest.approx(0.1048, abs=1e-3) and got["uniform"] < threshold
    assert got["graph500"] == pytest.approx(44.92, abs=0.01) and got["graph500"] > threshold


def test_strategy_notes_the_gauge_it_counts():
    S, model, workload, engine = _bad_incumbent()
    gauges = model.d_ops.metrics.structure_gauges()
    want = retune_mod.counted_pad_frac(S, cand_mod.Candidate("15d_fusion2", 1, "cuda-f32"))
    assert gauges["fusedSpMM"]["walk_idle_frac"] == pytest.approx(want, rel=1e-6)
    assert set(gauges) == {"sddmmA", "spmmA", "fusedSpMM", "cgStep", "gatLayer", "sddmmB",
                           "spmmB"}
    info = signals_mod.realized_info(engine)
    assert info == {"kernel": "cuda-f32", "variant": None,
                    "walk_idle_frac": max(g["walk_idle_frac"] for g in gauges.values())}
    sigs = mine_engine(engine)
    assert [s.kind for s in sigs] == ["walk_idle"]
    assert mine_engine(engine, idle_threshold=1e9) == []
    workload.kernel_variant = "v1.rb4.rs"  # a banked incumbent is no signal
    assert mine_engine(engine) == []


def test_realized_ranking_puts_the_banked_variant_first():
    S = HostCOO.rmat(SMOKE["log_m"], SMOKE["edge_factor"], seed=0, **GRAPH500)
    problem = Problem.from_coo(S, SMOKE["R"])
    cands = [c for c in cand_mod.enumerate_candidates(problem, 1, ("cuda-f32",))
             if c.algorithm == "15d_fusion2" and c.wire is None]
    generic = cand_mod.Candidate("15d_fusion2", 1, "cuda-f32")
    realized = {"variant": None, "walk_idle_frac": 1e4}
    ranked = cand_mod.rank_candidates_realized(problem, cands, 1, realized=realized)
    assert ranked[0][0].variant is not None and ranked[-1][0] == generic
    # No gauge, or a banked incumbent: the model's ranking stands.
    for info in (None, {"variant": "v1.rb4.rs", "walk_idle_frac": 1e4}):
        assert (cand_mod.rank_candidates_realized(problem, cands, 1, realized=info)
                == cand_mod.rank_candidates(problem, cands, 1))


def test_watchdog_signals_keep_the_kind_filter():
    wd = types.SimpleNamespace(events=[
        {"kind": "xla_flop_mismatch", "direction": "xla_waste", "ratio": 0.25, "op": "x"},
        {"kind": "xla_flop_mismatch", "direction": "counted_waste", "ratio": 4.0},
        {"kind": "step_time_spike"}])
    sigs = mine_watchdog(wd)
    assert [(s.kind, s.op, s.severity) for s in sigs] == [("xla_waste", "x", 4.0)]
    assert mine_watchdog(wd, since=1) == [] and mine_watchdog(None) == []


def test_swap_ladder_refuses_a_partial_or_stale_ladder():
    _, _, workload, engine = _bad_incumbent()
    engine.warmup()
    cells = dict(engine._cell_programs)
    with pytest.raises(ValueError, match="missing cells"):
        engine.swap_ladder(dict(list(cells.items())[:1]), "v1.rb4.rs")
    with pytest.raises(ValueError):
        engine.swap_ladder(cells, "v9.rb4.rs")
    with pytest.raises(StaleChallenger):
        ShadowSession(engine, "v9.rb4.rs")
    assert engine.stats()["ladder_swaps"] == 0 and workload.kernel_variant is None
    engine.swap_ladder(cells, "v1.rb4.rs")
    assert engine.stats()["ladder_swaps"] == 1 and workload.kernel_variant == "v1.rb4.rs"
    assert all("v1.rb4.rs" in key for key in engine._programs)


def test_adapt_promotes_the_banked_variant_bit_equal_with_no_request_path_build(tmp_path):
    S, model, workload, engine = _bad_incumbent()
    cache = PlanCache(tmp_path / "plans")
    tuner = BackgroundTuner(engine, plan_cache=cache, config=TunerConfig(
        interval_s=0.1, shadow_samples=2, cooldown_s=60.0, trial="counted"))
    engine.start()
    warm = engine.stats()
    rng = np.random.default_rng(7)
    probes = [workload.sample_payload(rng) for _ in range(6)]
    before = [_bytes(engine.execute_now([p])[0]) for p in probes]
    tuner.start()
    try:
        summary = run_load(engine, duration_s=2.0, rate_hz=30, seed=3, oracle_every=4)
        t0 = time.perf_counter()
        while not tuner.promotions and time.perf_counter() - t0 < 30.0:
            for p in probes:
                engine.submit(p)
            time.sleep(0.2)
    finally:
        tuner.stop()
        engine.stop()
    after = [_bytes(engine.execute_now([p])[0]) for p in probes]
    end = engine.stats()
    want_vid = jax_variant_ids_for(JaxProblem.from_coo(
        JaxCOO.rmat(log_m=SMOKE["log_m"], edge_factor=SMOKE["edge_factor"], seed=0,
                    **GRAPH500),
        SMOKE["R"]))
    assert len(tuner.promotions) == 1 and tuner.state == "scan"
    assert workload.kernel_variant == tuner.promotions[0]["plan"]["variant"]
    assert workload.kernel_variant == variant_ids_for_port(S)
    assert want_vid == (workload.kernel_variant,)
    assert tuner.time_to_adapt_s is not None and 0.0 < tuner.time_to_adapt_s < 30.0
    assert before == after
    assert end["live_compiles"] == warm["live_compiles"] and end["ladder_swaps"] == 1
    assert summary["oracle_failures"] == 0 and summary["errors"] == 0
    key = tuner.promotions[0]["plan"]["fingerprint_key"]
    cached = cache.load(key)
    assert cached["variant"] == workload.kernel_variant and cached["source"] == "tuned"
    assert cached["algorithm"] == "15d_fusion2" and model.plan.variant == cached["variant"]
    assert tuner.snapshot() == {"state": "scan", "scans": tuner.scans, "promotions": 1,
                                "rejects": 0, "time_to_adapt_s": tuner.time_to_adapt_s}
    assert mine_engine(engine) == []  # the promotion answered the signal


def variant_ids_for_port(S):
    from distributed_sddmm_tpu_torch.codegen.variants import variant_ids_for

    return variant_ids_for(Problem.from_coo(S, SMOKE["R"]))[0]


def test_shadow_mismatch_blocks_promotion_and_dumps_a_flight_record(tmp_path):
    _, _, workload, engine = _bad_incumbent()
    engine.warmup()
    fr = flightrec.enable(tmp_path / "flightrec")
    try:
        shadow = ShadowSession(engine, variant_ids_for_port(workload.S_live))
        assert shadow.warm() == 2
        engine.attach_mirror(shadow.offer)
        rng = np.random.default_rng(11)
        payloads = [workload.sample_payload(rng) for _ in range(4)]
        shadow.offer(payloads[:2], engine.execute_now(payloads[:2]), 2, 8)
        plan = FaultPlan.from_spec(
            '[{"site": "output:tunerShadow", "kind": "nan", "prob": 1.0}]')
        with fault_plan(plan):
            shadow.drain()
        assert shadow.mismatches == 1 and not shadow.clean(1)
        assert shadow.mismatch_detail["reason"] == "reply_diverged"
        assert len(fr.paths) == 1 and "snapshot_path" in shadow.mismatch_detail
        # Clean replays pass once the fault is gone.
        clean = ShadowSession(engine, shadow.variant)
        clean.warm()
        clean.offer(payloads[2:], engine.execute_now(payloads[2:]), 2, 8)
        assert clean.drain() == 1 and clean.clean(2)
    finally:
        engine.detach_mirror()
        flightrec.disable()
    assert engine.stats()["ladder_swaps"] == 0 and workload.kernel_variant is None


def test_tune_dry_run_leaves_the_cache_bytes(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SDDMM_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    argv = ["tune", "8", "8", "16", "--device", "cpu", "--store", str(tmp_path / "store")]
    assert cli.main([*argv, "--dry-run"]) == 0
    assert not (tmp_path / "plans").exists()  # a miss selects in a throwaway cache
    assert cli.main([*argv, "--trial", "counted"]) == 0
    before = {p.name: p.read_bytes() for p in (tmp_path / "plans").iterdir()}
    assert before
    assert cli.main([*argv, "--dry-run", "--json", "--trial", "counted"]) == 0
    report = capsys.readouterr().out
    assert '"dry_run": true' in report and '"promoted": false' in report
    assert {p.name: p.read_bytes() for p in (tmp_path / "plans").iterdir()} == before


def test_a_challenger_cell_that_fails_to_build_is_a_counted_reject(tmp_path, monkeypatch):
    """No quiet fallback: a cell the shadow cannot build rejects the
    challenger (``tuner_rejects``), and the ladder stays the incumbent's."""
    from distributed_sddmm_tpu_torch.obs import metrics

    _, _, workload, engine = _bad_incumbent()
    engine.warmup()
    tuner = BackgroundTuner(engine, plan_cache=PlanCache(tmp_path), config=TunerConfig(
        trial="counted"))

    def refuse(*a, **kw):
        raise RuntimeError("cell build failed")

    monkeypatch.setattr(workload, "build_program", refuse)
    before = metrics.GLOBAL.get("tuner_rejects")
    assert tuner.step() == "scan"
    assert tuner.rejects[-1]["reason"] == "shadow_build_failed"
    assert "cell build failed" in tuner.rejects[-1]["error"]
    assert metrics.GLOBAL.get("tuner_rejects") == before + 1
    assert engine.stats()["ladder_swaps"] == 0 and engine._mirror is None
