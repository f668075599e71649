"""The port's in-run watchdog and flight recorder (``obs/watchdog.py``,
``obs/flightrec.py``) against the JAX package's.

Exact comparisons: one sequence of step times (and of repair counters)
fed to both packages' ``Watchdog`` gives the same anomalies, in the same
order, with the same attributes; a ``skew`` of 2.0 at ``comm:fusedSpMM``
gives the same ``comm_mismatch`` (p = 4 on the port's ``LocalWorld``, the
JAX package's first four CPU devices); both flight recorders dump the
same files with the same keys. ``strict`` raises ``WatchdogAlarm``, a
``NumericalFault``, through the CLI as well.
"""

import os
import json

import numpy as np
import pytest

import jax

from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.obs import flightrec as jax_flightrec
from distributed_sddmm_tpu.obs import metrics as jax_metrics
from distributed_sddmm_tpu.obs import trace as jax_trace
from distributed_sddmm_tpu.obs import watchdog as jax_watchdog
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.resilience import faults as jax_faults
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.obs import flightrec, metrics, trace, watchdog
from distributed_sddmm_tpu_torch.obs.watchdog import Watchdog, WatchdogAlarm
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.resilience import faults
from distributed_sddmm_tpu_torch.resilience.guards import NumericalFault
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

# Benchmarks here write no run document into the checkout's default store.
os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

SKEW = [{"site": "comm:fusedSpMM", "kind": "skew", "prob": 1.0, "param": 2.0}]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Every process-wide switch of both packages off before and after."""
    for name in ("SDDMM_TORCH_WATCHDOG", "SDDMM_TORCH_FLIGHTREC", "SDDMM_TORCH_TRACE",
                 "SDDMM_TORCH_FAULTS", "DSDDMM_WATCHDOG", "DSDDMM_FLIGHTREC", "DSDDMM_TRACE"):
        monkeypatch.delenv(name, raising=False)

    def off():
        for mod in (watchdog, flightrec, trace, jax_watchdog, jax_flightrec, jax_trace):
            mod.disable()
        faults.clear()
        jax_faults.clear()

    off()
    yield
    off()


def _pair():
    S = JaxCOO.erdos_renyi(48, 32, 5, seed=0)
    return (JaxDS(S, R=8, c=1, devices=jax.devices()[:4]),
            DenseShift15D(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=8, c=1,
                          world=LocalWorld(4), device="cpu"))


def _fused(alg, mode, n=2):
    """``n`` fused pairs in ``mode`` (B: S^T's values, B's output)."""
    kinds = type(mode)
    A, B = alg.dummy_initialize(kinds.A), alg.dummy_initialize(kinds.B)
    vals = alg.like_s_values(1.0) if mode == kinds.A else alg.like_st_values(1.0)
    for _ in range(n):
        alg.fused_spmm(A, B, vals, mode)


def _durations(seed: int) -> list:
    """A step-time stream over three ops: a steady warmup, spikes, a slow
    creep on one op (drift), and a first call that builds kernels."""
    rng = np.random.default_rng(seed)
    out = [("fusedSpMM", 0.5)]
    for i in range(80):
        op = ("fusedSpMM", "cgStep", "als:step")[i % 3]
        base = {"fusedSpMM": 0.02, "cgStep": 0.03, "als:step": 0.4}[op]
        d = base * (1 + 0.05 * rng.standard_normal())
        if op == "cgStep" and i > 30:
            d *= 1 + (i - 30) * 0.08  # creep
        if i in (20, 41, 62):
            d *= 6  # spikes
        out.append((op, float(d)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_durations_same_anomalies_as_jax(seed):
    """Kinds, ops, order and attributes equal, repair storms included (the
    repair counters move in both packages' ``GLOBAL`` at the same
    points), and the summaries equal."""
    got, want = Watchdog(storm_window=10), jax_watchdog.Watchdog(storm_window=10)
    for i, (op, d) in enumerate(_durations(seed)):
        if 25 <= i < 40:
            metrics.GLOBAL.add("exec_retries", 0.5)
            jax_metrics.GLOBAL.add("exec_retries", 0.5)
        got.observe(op, d)
        want.observe(op, d)
    for q in (10, 80, 90, 95, 99, 99, 20, 90, 90, 90, 90, 90):
        got.observe_queue(q, 100)
        want.observe_queue(q, 100)
    assert got.events == want.events
    assert {e["kind"] for e in got.events} == {"step_time_spike", "step_time_drift",
                                                "repair_storm", "queue_runaway"}
    assert got.summary() == want.summary() and got.summary(since=3) == want.summary(since=3)


def test_skew_gives_the_jax_comm_mismatch():
    """A ``skew`` of 2.0 at ``comm:fusedSpMM``: one ``comm_mismatch`` (the
    check runs once a geometry), ratio 2.0, the same words as the JAX
    package's; no anomaly without the skew. B mode is charged
    ``fusedSpMMB`` (no skew there): on this rectangular matrix both
    packages' layout math moves 1.5x the model's words, which both
    flag."""
    ja, alg = _pair()
    wd, jwd = watchdog.enable("warn"), jax_watchdog.enable("warn")
    _fused(alg, MatMode.A)
    _fused(ja, JaxMode.A)
    assert wd.events == jwd.events == []
    alg.reset_performance_timers()
    ja.reset_performance_timers()
    with faults.fault_plan(faults.FaultPlan.from_spec(SKEW)):
        wd = watchdog.enable("warn")
        _fused(alg, MatMode.A)
        _fused(alg, MatMode.B)
    with jax_faults.fault_plan(jax_faults.FaultPlan.from_spec(SKEW)):
        jwd = jax_watchdog.enable("warn")
        _fused(ja, JaxMode.A)
        _fused(ja, JaxMode.B)
    assert wd.events == jwd.events
    ev, ev_b = wd.events
    assert (ev["kind"], ev["op"], ev["ratio"]) == ("comm_mismatch", "fusedSpMM", 2.0)
    assert ev["counted_words"] == 2 * ev["model_words"] > 0
    assert (ev_b["op"], ev_b["ratio"]) == ("fusedSpMMB", 1.5)
    assert alg.metrics["fusedSpMM"]["comm_words"] == ja.metrics.to_dict()["fusedSpMM"][
        "comm_words"]


def test_strict_raises_a_numerical_fault_after_recording():
    _, alg = _pair()
    wd = watchdog.enable("strict")
    with faults.fault_plan(faults.FaultPlan.from_spec(SKEW)):
        with pytest.raises(WatchdogAlarm, match="comm_mismatch") as alarm:
            _fused(alg, MatMode.A)
    assert isinstance(alarm.value, NumericalFault)
    assert [e["kind"] for e in wd.events] == ["comm_mismatch"]
    assert alg.metrics["fusedSpMM"]["calls"] == 1  # the observation was recorded


def test_strict_step_alarm_degrades_als_instead_of_aborting(monkeypatch):
    """A strict alarm from the ``als:step`` cadence hook enters the ladder
    as a divergence: ALS falls to the serial solver (on the CPU)."""
    S = JaxCOO.erdos_renyi(48, 32, 5, seed=0)
    port = HostCOO(S.rows, S.cols, S.vals, S.M, S.N)
    als = DistributedALS(DenseShift15D(port, R=8, c=1, world=LocalWorld(4), device="cpu"),
                         seed=0, S_host=port)
    wd = watchdog.enable("strict")

    def observe(op, dur_s):
        if op == "als:step":
            raise WatchdogAlarm("step_time_drift on als:step")

    monkeypatch.setattr(wd, "observe", observe)
    monkeypatch.setattr(wd, "observe_dispatch", lambda *a, **k: None)
    als.run_cg(2, cg_iters=2)
    assert als.degraded == "serial"


def test_env_activation(monkeypatch):
    monkeypatch.setenv(watchdog.WATCHDOG_ENV, "strict")
    monkeypatch.setattr(watchdog, "_env_checked", False)
    assert watchdog.active().mode == "strict"
    monkeypatch.setenv(watchdog.WATCHDOG_ENV, "nope")
    monkeypatch.setattr(watchdog, "_active", None)
    monkeypatch.setattr(watchdog, "_env_checked", False)
    assert watchdog.active() is None
    with pytest.raises(ValueError):
        Watchdog(mode="loud")


def _dump_names(root) -> list:
    return sorted(str(p.relative_to(p.parents[1]).name) for p in root.rglob("*.json"))


def test_flight_recorder_dumps_the_jax_files(tmp_path):
    """The skew anomaly with a recorder armed in each package: the same
    file names under ``<dir>/<run_id>/``, the same top-level keys, the
    same anomaly, and the ring ends at the dispatch that preceded it; the
    anomaly's ``snapshot_path`` names the file."""
    ja, alg = _pair()
    fr = flightrec.enable(tmp_path / "port")
    wd = watchdog.enable("warn")
    with faults.fault_plan(faults.FaultPlan.from_spec(SKEW)):
        _fused(alg, MatMode.A)
    jfr = jax_flightrec.enable(tmp_path / "jax")
    jax_watchdog.enable("warn")
    with jax_faults.fault_plan(jax_faults.FaultPlan.from_spec(SKEW)):
        _fused(ja, JaxMode.A)
    names = _dump_names(tmp_path / "port")
    assert names == _dump_names(tmp_path / "jax") == ["000-comm_mismatch.json"]
    got = json.loads((fr.out_dir / names[0]).read_text())
    want = json.loads((jfr.out_dir / names[0]).read_text())
    assert set(got) == set(want)
    assert got["anomaly"]["kind"] == want["anomaly"]["kind"] == "comm_mismatch"
    assert got["anomaly"]["attrs"]["ratio"] == want["anomaly"]["attrs"]["ratio"]
    assert got["ring"][-1]["name"] == want["ring"][-1]["name"] == "fusedSpMM"
    assert got["metrics"]["global"]["faults_fired"] >= 1
    assert wd.events[0]["snapshot_path"] == str(fr.out_dir / names[0])
    assert wd.summary()["snapshots"] == [str(fr.out_dir / names[0])]


def test_flight_recorder_budget_and_refunds(tmp_path, monkeypatch):
    fr = flightrec.enable(tmp_path, max_dumps=2)
    assert [bool(fr.dump("k", "op", {})) for _ in range(3)] == [True, True, False]
    fr2 = flightrec.enable(tmp_path / "b", max_dumps=1)
    monkeypatch.setattr(flightrec.FlightRecorder, "_dump",
                        lambda self, *a: (_ for _ in ()).throw(OSError("full")))
    assert fr2.dump("k", "op", {}) is None and fr2.dumps == 0
    assert flightrec.parse_env_spec("off") == (False, None)
    assert flightrec.parse_env_spec("on") == (True, None)
    assert flightrec.parse_env_spec("d")[0]


def test_cli_strict_with_flight_recorder_raises_and_dumps(tmp_path, monkeypatch):
    """``er --watchdog strict --flightrec DIR`` under the skew: the run
    raises ``WatchdogAlarm`` (the module entry point exits nonzero), DIR
    holds the dump (the ring and the counters), and every switch the
    command turned on is off again."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "4")
    with pytest.raises(WatchdogAlarm):
        cli.main(["er", "6", "4", "15d_fusion2", "8", "1", "--device", "cpu",
                  "--trials", "2", "--faults", json.dumps(SKEW), "--watchdog", "strict",
                  "--flightrec", str(tmp_path)])
    (dump,) = tmp_path.rglob("000-comm_mismatch.json")
    rec = json.loads(dump.read_text())
    assert rec["ring"] and "faults_fired" in rec["metrics"]["global"]
    assert watchdog.active() is None and flightrec.active() is None
    assert faults.active() is None and not trace.enabled()


def test_cli_warn_record_carries_one_comm_mismatch(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "4")
    out = tmp_path / "rec.jsonl"
    assert cli.main(["er", "6", "4", "15d_fusion2", "8", "1", "--device", "cpu",
                     "--trials", "2", "--faults", json.dumps(SKEW), "--watchdog", "warn",
                     "-o", str(out)]) == 0
    rec = json.loads(out.read_text())
    (a,) = rec["anomalies"]["anomalies"]
    assert (a["kind"], a["op"], a["count"], a["first"]["ratio"]) == (
        "comm_mismatch", "fusedSpMM", 1, 2.0)
    assert rec["faults_fired"][0]["site"] == "comm:fusedSpMM"
