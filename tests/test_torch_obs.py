"""The port's tracer, manifest, per-op metrics and profiler (``obs/``)
against the JAX package's.

* The tracer: nesting and parent ids, per-thread stacks, events under the
  current span, the ring, the memory-only tracer, ``disable``; every line
  valid under the JAX package's reader (``tools/tracereport.validate_record``).
* The manifest's fields, on the CPU and where ``nvidia-smi`` cannot run.
* ``OpMetrics.to_dict`` of every op of the four strategies (five
  configurations, A and B modes, attention on the dense shift) at (8, 2),
  R 8: calls, ``comm_words``, ``comm_bytes``, ``comm_words_extra`` and
  ``flops`` equal the JAX package's exactly.
* ``er ... --trace`` on the CPU at p = 8: the JAX reader loads the port's
  trace strictly, and ``aggregate`` gives the same ops, calls and comm
  words as for the JAX CLI's trace of the same run.
* ``er ... --profile`` on the CPU writes a Chrome trace holding a
  ``fusedSpMM`` range a pair and the ``bench`` range.
"""

import contextlib
import json
import os
import subprocess
import threading

import pytest

import jax

from distributed_sddmm_tpu.bench.harness import make_algorithm as jax_make
from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.obs import trace as jax_trace
from distributed_sddmm_tpu.tools import tracereport
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO
from distributed_sddmm_tpu.utils.verify import fingerprint_algorithm as jax_fingerprint

from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.bench.harness import make_algorithm
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.obs import manifest, metrics, profiler, trace
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.verify import fingerprint_algorithm

# Benchmarks here write no run document into the checkout's default store.
os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"


@pytest.fixture(autouse=True)
def _tracers_off(monkeypatch):
    for name in ("SDDMM_TORCH_TRACE", "SDDMM_TORCH_PROFILE", "DSDDMM_TRACE"):
        monkeypatch.delenv(name, raising=False)
    trace.disable()
    jax_trace.disable()
    yield
    trace.disable()
    jax_trace.disable()


def _lines(path) -> list:
    return [json.loads(line) for line in open(path).read().splitlines()]


# --------------------------------------------------------------- tracer


def test_spans_nest_and_every_line_is_valid_for_the_jax_reader(tmp_path):
    tr = trace.enable(tmp_path / "t.jsonl", run_id="r1")
    with trace.span("outer", a=1) as outer:
        with trace.span("inner") as inner:
            trace.event("ev", x=2)
        inner_id = inner.id
        outer.set(done=True)
    trace.disable()
    recs = _lines(tr.path)
    assert [r["type"] for r in recs] == ["begin", "event", "span", "span"]
    begin, ev, sp_in, sp_out = recs
    assert begin["schema"] == 1 and begin["run_id"] == "r1" and "t0_epoch" in begin
    assert ev["parent"] == inner_id and sp_in["parent"] == sp_out["id"]
    assert sp_out["parent"] is None and sp_out["attrs"] == {"a": 1, "done": True}
    assert sp_out["t0"] <= sp_in["t0"] <= sp_in["t1"] <= sp_out["t1"]
    assert all(tracereport.validate_record(r) == [] for r in recs)
    assert tracereport.load_trace(tr.path, strict=True)["begin"]["run_id"] == "r1"
    assert (tmp_path / "t.manifest.json").exists()


def test_threads_nest_independently_and_errors_are_named(tmp_path):
    tr = trace.enable(tmp_path / "t.jsonl")
    ids = {}

    def worker():
        with trace.span("worker") as sp:
            ids["worker_parent"] = sp.parent

    with trace.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    with pytest.raises(KeyError):
        with trace.span("failing"):
            raise KeyError("x")
    trace.disable()
    assert ids["worker_parent"] is None
    failing = [r for r in _lines(tr.path) if r.get("name") == "failing"]
    assert failing[0]["attrs"]["error"] == "KeyError"


def test_disabled_tracer_is_a_shared_noop_and_env_activates(tmp_path, monkeypatch):
    assert trace.span("x") is trace.NOOP_SPAN and not trace.enabled()
    trace.event("nothing")
    monkeypatch.setenv(trace.TRACE_ENV, str(tmp_path / "envdir"))
    monkeypatch.setattr(trace, "_env_checked", False)
    assert trace.enabled()
    path = trace.trace_path()
    assert path.startswith(str(tmp_path / "envdir")) and path.endswith(".jsonl")
    trace.disable()
    assert trace.trace_path() is None


def test_ring_and_memory_only_tracer(tmp_path):
    ring = trace.arm_ring(3)
    assert trace.enabled() and trace.trace_path() is None
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert [r["name"] for r in ring.records()] == ["s2", "s3", "s4"] and ring.appended == 6
    assert trace.arm_ring(99) is ring
    trace.disarm_ring()
    assert not trace.enabled()
    tr = trace.enable(tmp_path / "t.jsonl")
    ring = trace.arm_ring()
    trace.event("tap")
    assert ring.records()[-1]["name"] == "tap" and trace.tracer() is tr
    trace.disable()
    assert trace.ring() is None and not trace.enabled()


def test_explicit_file_of_a_live_owner_becomes_a_shard(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text(json.dumps({"type": "begin", "pid": 1}) + "\n")  # pid 1 lives
    tr = trace.enable(path)
    assert tr.path.parent == trace.shard_dir_for(path)
    assert os.environ[trace.TRACE_ENV] == str(trace.shard_dir_for(path))  # for child processes
    trace.disable()
    assert trace.TRACE_ENV not in os.environ


# -------------------------------------------------------------- manifest


def test_manifest_fields_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "4")
    m = manifest.build("rid", extra={"k": 1}, device="cpu")
    for key in ("schema", "run_id", "created_epoch", "python", "platform", "argv", "git_rev",
                "git_dirty", "env", "torch_version", "cuda_version", "extra"):
        assert key in m, key
    assert m["env"]["SDDMM_TORCH_LOCAL_RANKS"] == "4"
    assert {m[k] for k in ("device", "device_name", "device_capability", "device_count",
                           "smi_name", "power_limit")} == {"cpu"}
    assert "device" not in manifest.build("rid")  # CUDA is not up here
    monkeypatch.setattr(manifest, "_REPO", tmp_path)
    manifest._git_info_cache.clear()
    assert manifest._git_info(tmp_path) == {"git_rev": "unknown", "git_dirty": None}
    manifest._git_info_cache.clear()


def test_power_limit_is_null_with_the_reason_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(manifest, "_smi_cache", {})
    monkeypatch.setattr(subprocess, "run", missing)
    info = manifest.nvidia_smi(0)
    assert info["power_limit"] is None and "FileNotFoundError" in info["power_limit_error"]


# ------------------------------------------------------------ OpMetrics

CONFIGS = ["15d_fusion1", "15d_fusion2", "15d_sparse", "25d_dense_replicate",
           "25d_sparse_replicate"]
COST_FIELDS = ("calls", "retries", "comm_words", "comm_bytes", "comm_words_extra", "flops")


def _every_op(alg, mode_cls, S):
    """The verify protocol, then the B-mode SDDMM and fused pair, and on
    the dense shift fused attention in both modes."""
    fingerprint = fingerprint_algorithm if mode_cls is MatMode else jax_fingerprint
    fingerprint(alg, S)
    A, B = alg.dummy_initialize(mode_cls.A), alg.dummy_initialize(mode_cls.B)
    st = alg.like_st_values(1.0)
    alg.sddmm_b(A, B, st)
    alg.fused_spmm(A, B, st, mode_cls.B)
    if hasattr(alg, "fusion_approach"):
        alg.fused_attention(A, B, alg.like_s_values(1.0), mode_cls.A)
        alg.fused_attention(A, B, st, mode_cls.B)


@pytest.mark.parametrize("name", CONFIGS)
def test_op_metrics_of_every_op_equal_jax(name):
    S = JaxCOO.erdos_renyi(48, 40, 5, seed=3)
    ja = jax_make(name, S, 8, 2, devices=jax.devices()[:8])
    alg = make_algorithm(name, HostCOO(S.rows, S.cols, S.vals, S.M, S.N), 8, 2,
                         device="cpu", world=LocalWorld(8))
    _every_op(ja, JaxMode, S)
    _every_op(alg, MatMode, HostCOO(S.rows, S.cols, S.vals, S.M, S.N))
    got, want = alg.metrics.to_dict(), ja.metrics.to_dict()
    assert set(got) == set(want)
    for op in want:
        assert set(got[op]) == set(want[op]), op
        assert {k: got[op][k] for k in COST_FIELDS} == {k: want[op][k] for k in COST_FIELDS}, op
    assert any(m["comm_words"] > 0 for m in got.values())
    assert alg.json_perf_statistics().keys() == ja.json_perf_statistics().keys()
    assert dict(alg.call_count) == dict(ja.call_count)
    assert alg.total_time.keys() == alg.metrics.keys()


def test_op_metrics_is_a_read_only_view():
    m = metrics.OpMetrics()
    m.note("fusedSpMM", padded_lane_frac=0.5)
    assert dict(m) == {} and m.gauges() == {"fusedSpMM": {"padded_lane_frac": 0.5}}
    m.record("fusedSpMM", 0.25, overhead_s=0.5, retries=1, comm_words=4.0, flops=8.0)
    m.record("fusedSpMM", 0.25)
    assert m["fusedSpMM"]["calls"] == 2 and m["fusedSpMM"]["padded_lane_frac"] == 0.5
    assert m.wall_view()["fusedSpMM"] == 1.0 and m.time_view()["fusedSpMM"] == 0.5
    assert "cgStep" not in m and list(m) == ["fusedSpMM"] and len(m) == 1
    m.clear()
    assert len(m) == 0 and m.gauges()
    assert metrics.op_flops("spmmA", 10, 4) == 80.0 and metrics.op_flops("nope", 1, 1) == 0.0


# ------------------------------------------------------------- the CLIs


def _jax_cli(argv, monkeypatch, tmp_path) -> int:
    """The JAX CLI in this process (its forced 8-device CPU mesh), the XLA
    kernel, no run store, its plan cache under ``tmp_path`` and its
    program store off."""
    from distributed_sddmm_tpu.bench import cli as jax_cli
    from distributed_sddmm_tpu.programs import store as jax_programs

    monkeypatch.setenv("DSDDMM_PLAN_CACHE", str(tmp_path / "jax_plan_cache"))
    monkeypatch.setenv("DSDDMM_PROGRAMS", "0")
    monkeypatch.setattr(jax_programs, "_active", None)
    monkeypatch.setattr(jax_programs, "_env_checked", False)
    return jax_cli.main([*argv, "--kernel", "xla", "--no-runstore"])


@pytest.mark.parametrize("argv", [
    pytest.param(["er", "6", "4", "15d_fusion2", "8", "2"], id="fusion2-vanilla"),
    pytest.param(["er", "6", "4", "15d_sparse", "8", "2", "--app", "als", "--trials", "1"],
                 id="sparse-als"),
    pytest.param(["er", "6", "4", "15d_fusion1", "8", "2", "--app", "gat", "--trials", "1"],
                 id="fusion1-gat"),
])
def test_traces_aggregate_like_the_jax_cli(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "8")
    argv = argv if "--trials" in argv else [*argv, "--trials", "3"]
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert cli.main([*argv, "--device", "cpu", "--trace", str(ours)]) == 0
    assert not trace.enabled()  # the command turned its tracer off
    assert _jax_cli([*argv, "--trace", str(theirs)], monkeypatch, tmp_path) == 0
    jax_trace.disable()
    got = tracereport.aggregate(tracereport.load_trace(ours, strict=True))
    want = tracereport.aggregate(tracereport.load_trace(theirs, strict=True))
    assert got["phases"].keys() == want["phases"].keys()
    for name, ph in want["phases"].items():
        mine = got["phases"][name]
        assert (mine["calls"], mine["comm_words"], mine["comm_bytes"], mine["flops"],
                mine["retries"]) == (ph["calls"], ph["comm_words"], ph["comm_bytes"],
                                     ph["flops"], ph["retries"]), name
        assert (mine.get("model_words"), mine.get("model_ratio")) == (
            ph.get("model_words"), ph.get("model_ratio")), name
    for key in ("algorithm", "cost_model", "M_pad", "N_pad", "nnz", "p", "c", "wire"):
        assert got["strategy"][key] == want["strategy"][key], key
    manifest_doc = tracereport.load_manifest(ours)
    assert manifest_doc["device"] == "cpu" and manifest_doc["run_id"] == got["run_id"]


def test_trace_spans_carry_the_records_per_call_costs(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "4")
    path, out = tmp_path / "t.jsonl", tmp_path / "rec.jsonl"
    assert cli.main(["er", "6", "4", "15d_fusion2", "8", "1", "--device", "cpu", "--trials",
                     "4", "--warmup", "2", "--trace", str(path), "-o", str(out)]) == 0
    rec = json.loads(out.read_text())
    recs = _lines(path)
    spans = [r for r in recs if r["type"] == "span" and r["name"] == "fusedSpMM"]
    per_call = rec["metrics"]["fusedSpMM"]
    assert len(spans) == 6 and rec["trace_path"] == str(path)
    assert rec["run_id"] == recs[0]["run_id"]
    for sp in spans:
        assert sp["attrs"]["comm_words"] == per_call["comm_words"] / per_call["calls"]
        assert sp["attrs"]["flops"] == per_call["flops"] / per_call["calls"]
    (bench,) = [r for r in recs if r["type"] == "span" and r["name"] == "bench"]
    assert all(sp["parent"] == bench["id"] for sp in spans)
    assert [r["name"] for r in recs if r["type"] == "event"] == ["strategy"]


def test_profile_holds_the_op_ranges(tmp_path, monkeypatch):
    """On the CPU the capture records CPU activity only (there is no card
    to ask for), with one ``fusedSpMM`` range a pair and the ``bench``
    range around them; the command's capture is over when it returns."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("SDDMM_TORCH_LOCAL_RANKS", raising=False)
    assert cli.main(["er", "6", "4", "15d_fusion2", "8", "1", "--device", "cpu", "--trials",
                     "3", "--warmup", "1", "--profile", str(tmp_path)]) == 0
    assert not profiler.active()
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    assert [e["name"] for e in ranges].count("fusedSpMM") == 4
    (bench,) = [e for e in ranges if e["name"] == "bench"]
    for e in ranges:
        if e["name"] == "fusedSpMM":
            assert bench["ts"] <= e["ts"] and e["ts"] + e["dur"] <= bench["ts"] + bench["dur"]


def test_capture_refuses_a_second_session_and_windows(tmp_path):
    with profiler.capture(tmp_path / "a") as cap:
        assert profiler.active()
        assert not profiler.capture_window(str(tmp_path / "w"))
        with profiler.capture(tmp_path / "b") as second:
            pass
        with profiler.annotate("x"):
            pass
    assert second.error == "another capture is running" and second.path is None
    assert cap.path and cap.error is None and not cap.cuda and not profiler.active()
    assert profiler.capture_window(str(tmp_path / "w"), duration_s=0.01)
    assert list((tmp_path / "w").glob("*.pt.trace.json"))
    assert isinstance(profiler.annotate("x"), contextlib.nullcontext)
