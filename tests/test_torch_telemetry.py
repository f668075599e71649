"""Live telemetry of the port (``obs/telemetry.py``: ``parse_env_spec``,
``engine_snapshot``, ``TelemetrySampler``, the stream readers and
``render_top``; ``obs/flightrec.py``'s sources) against the JAX
package's.

Both packages' engines serve one fold-in workload on the same integer
item factors (their replies tie exactly, so the two engines take the same
path) and the same payloads, one request a batch; their snapshots then
hold equal fields but the clock's (:data:`CLOCK_FIELDS`: the timestamp,
and the latency histogram, its percentiles and its sum, which read each
run's own clock; the histogram's count is compared). No field is the
device's: both engines run on the CPU. The screens of ``bench top`` are
compared as text on the same snapshot dicts.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from distributed_sddmm_tpu.obs import flightrec as jax_flightrec
from distributed_sddmm_tpu.obs import telemetry as jax_telemetry
from distributed_sddmm_tpu.serve import ALSFoldInTopK as JaxFoldIn
from distributed_sddmm_tpu.serve import ServingEngine as JaxEngine
from distributed_sddmm_tpu.serve import SLOSpec as JaxSLOSpec

from distributed_sddmm_tpu_torch.obs import flightrec, telemetry
from distributed_sddmm_tpu_torch.serve import ALSFoldInTopK, ServingEngine, SLOSpec

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

#: The snapshot fields that read the clock.
CLOCK_FIELDS = ("t_epoch", "latency_hist", "latency_hist_ms", "latency_sum_ms")
#: The snapshot fields of the device: none differ between two CPU engines.
DEVICE_FIELDS = ()
#: An SLO of error rate only: its burn rate does not read the clock.
SLO = "err_rate=0.05"


def _stub_model(B: np.ndarray):
    d_ops = types.SimpleNamespace(N=B.shape[0], R=B.shape[1], device=torch.device("cpu"))
    return types.SimpleNamespace(B=B, item_factors=lambda: B, d_ops=d_ops, ridge_lambda=1e-6,
                                 S_host=None)


def _factors():
    rng = np.random.default_rng(3)
    return rng.integers(-1, 2, size=(48, 8)).astype(np.float32)


def _payloads(n: int = 6) -> list:
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        items = rng.choice(48, size=int(rng.integers(1, 7)), replace=False)
        out.append({"items": items,
                    "ratings": rng.integers(-2, 3, size=items.size).astype(np.float64)})
    return out


def _drive(engine, payloads) -> None:
    """Each payload alone through the queue, the reply counted as a client
    counts it."""
    engine.start()
    try:
        for p in payloads:
            req = engine.submit(p)
            req.result(timeout_s=60.0)
            engine.recorder.record_reply(req)
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def engines():
    B = _factors()
    jeng = JaxEngine(JaxFoldIn(_stub_model(B), k=5, item_buckets=(4, 8), ingest_rows=False),
                     max_batch=2, max_depth=16, max_wait_ms=0.0)
    peng = ServingEngine(ALSFoldInTopK(_stub_model(B), k=5, item_buckets=(4, 8),
                                       ingest_rows=False),
                         max_batch=2, max_depth=16, max_wait_ms=0.0)
    payloads = _payloads()
    _drive(jeng, payloads)
    _drive(peng, payloads)
    return jeng, peng, payloads


@pytest.mark.parametrize("spec", ["", None, "0", "off", "OFF", "false", "no", "1", "on",
                                  "TRUE", "yes", "/tmp/telemetry-dir", "relative/dir", "2"])
def test_parse_env_spec_equals_jax(spec):
    got = telemetry.parse_env_spec(spec)
    want = jax_telemetry.parse_env_spec(spec)
    assert got == want


def test_engine_snapshot_fields_equal_jax(engines):
    jeng, peng, payloads = engines
    want = jax_telemetry.engine_snapshot(jeng, slo=JaxSLOSpec.parse(SLO), run_id="r")
    got = telemetry.engine_snapshot(peng, slo=SLOSpec.parse(SLO), run_id="r")
    assert set(got) == set(want)
    skip = CLOCK_FIELDS + DEVICE_FIELDS
    assert {k: got[k] for k in got if k not in skip} == {k: want[k] for k in want
                                                         if k not in skip}
    assert got["completed"] == len(payloads) and got["program_store"]["live_compiles"] == 4
    hist = telemetry.LatencyHistogram.from_dict(got["latency_hist"])
    assert hist.total == jax_telemetry.LatencyHistogram.from_dict(want["latency_hist"]).total
    assert got["latency_sum_ms"] > 0 and set(got["latency_hist_ms"]) == {"p50", "p95", "p99"}


def test_snapshot_reads_no_device_state(engines):
    """The snapshot's reads are host counters: with the tensor reads of the
    module patched to raise, it is still taken."""
    _, peng, _ = engines

    def refuse(*a, **kw):
        raise AssertionError("engine_snapshot read a tensor")

    orig = torch.Tensor.item, torch.Tensor.cpu, torch.Tensor.tolist
    torch.Tensor.item = torch.Tensor.cpu = torch.Tensor.tolist = refuse
    try:
        snap = telemetry.engine_snapshot(peng, run_id="r")
    finally:
        torch.Tensor.item, torch.Tensor.cpu, torch.Tensor.tolist = orig
    assert snap["completed"] == 6


def _snapshots(engines) -> list:
    jeng, _, _ = engines
    first = jax_telemetry.engine_snapshot(jeng, slo=JaxSLOSpec.parse(SLO), run_id="r")
    second = dict(first, t_epoch=first["t_epoch"] + 2.0, completed=first["completed"] + 8,
                  shed=3, burn_rate=1.5,
                  tuner={"state": "shadow", "promotions": 1, "rejects": 2,
                         "time_to_adapt_s": 1.25})
    return [first, second]


def test_render_top_equals_jax(engines):
    snaps = _snapshots(engines)
    for case in ([], snaps[:1], snaps):
        assert telemetry.render_top(case) == jax_telemetry.render_top(case)
    router = {"router": True, "hedge_delay_s": 0.05, "audit_frac": 0.1,
              "replicas": [{"name": "r0", "ready": True, "breaker": "closed",
                            "depth_frac": 0.25, "burn": 0.5, "strikes": 1,
                            "inner_buckets": [8, 16]},
                           {"name": "r1", "draining": True}],
              "stats": {"routed": 10, "hedges": 2, "audits": 1},
              "manager": {"replicas": [{}, {}], "spawns": 3, "losses": 1}}
    assert telemetry.render_top([router]) == jax_telemetry.render_top([router])


def test_sampler_stream_reads_back_in_both_packages(engines, tmp_path):
    _, peng, _ = engines
    sampler = telemetry.TelemetrySampler(peng, interval_s=0.05, out_dir=tmp_path, slo=None,
                                         run_id="run-a")
    with sampler:
        pass
    assert sampler.path == tmp_path / "run-a.jsonl" and sampler.samples >= 1
    with open(sampler.path, "a") as fh:
        fh.write('{"torn": ')  # a torn last line is skipped
    got = telemetry.read_snapshots(sampler.path)
    assert got == jax_telemetry.read_snapshots(sampler.path) and got[-1]["completed"] == 6
    assert telemetry.newest_stream(tmp_path) == jax_telemetry.newest_stream(tmp_path)
    assert telemetry.render_top(got) == jax_telemetry.render_top(got)
    assert telemetry.newest_stream(tmp_path / "none") is None
    assert telemetry.DEFAULT_TELEMETRY_DIR.name == "telemetry_torch"


def test_flight_record_carries_registered_sources(engines, tmp_path):
    """``register_source`` (JAX ``obs/flightrec.py:97``): a dump holds each
    source's value, a raising source its error, as the JAX recorder's."""
    _, peng, _ = engines
    records = {}
    for name, mod in (("port", flightrec), ("jax", jax_flightrec)):
        fr = mod.enable(tmp_path / name, run_id="r")
        fr.register_source("engine", lambda: telemetry.engine_snapshot(peng, run_id="r"))
        fr.register_source("broken", lambda: 1 / 0)
        path = fr.dump("step_time_spike", "serve:als", {"x": 1})
        assert path and fr.paths == [path]
        records[name] = json.loads(open(path).read())
        mod.disable()  # and the ring it armed
    assert set(records["port"]) == set(records["jax"])
    assert records["port"]["sources"]["broken"] == records["jax"]["sources"]["broken"]
    assert records["port"]["sources"]["engine"]["completed"] == 6
