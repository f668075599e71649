"""The admin server of the port (``obs/httpexp.py``) against the JAX
package's, on port 0 of the loopback.

Both servers front an engine of their own package on one fold-in
workload (the same integer item factors): every route answers with the
JAX server's status and JSON keys, ``/readyz`` is 503 until warm-up ends,
``/metrics`` carries the JAX families (the port's extras listed in
:data:`PORT_ONLY_FAMILIES`), and ``POST /submit`` answers each payload
with the bytes the engine gives it in-process. ``Exposition.render`` is
held to the JAX text on the same snapshot dicts.
"""

import json
import os
import types
import urllib.request

import numpy as np
import pytest
import torch

from distributed_sddmm_tpu.obs import httpexp as jax_httpexp
from distributed_sddmm_tpu.obs import telemetry as jax_telemetry
from distributed_sddmm_tpu.serve import ALSFoldInTopK as JaxFoldIn
from distributed_sddmm_tpu.serve import ServingEngine as JaxEngine

from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.obs import httpexp, metrics, telemetry
from distributed_sddmm_tpu_torch.resilience import faults
from distributed_sddmm_tpu_torch.serve import ALSFoldInTopK, ServingEngine, ShedError

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

#: Families only the port's scrape has: its card-only error rung's counter
#: and the walk idle gauge of a strategy's ops (with ``op_metrics``).
PORT_ONLY_FAMILIES = {"dsddmm_serve_error_batches_total"}
ROUTES = ("/", "/healthz", "/readyz", "/snapshot", "/debug/requests", "/nope")


def _stub_model(B: np.ndarray):
    d_ops = types.SimpleNamespace(N=B.shape[0], R=B.shape[1], device=torch.device("cpu"))
    return types.SimpleNamespace(B=B, item_factors=lambda: B, d_ops=d_ops, ridge_lambda=1e-6,
                                 S_host=None)


def _get(port: int, path: str) -> tuple:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _keys(status: int, body: str):
    try:
        return status, sorted(json.loads(body))
    except ValueError:
        return status, None


def _families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


@pytest.fixture(scope="module")
def servers():
    B = np.random.default_rng(3).integers(-1, 2, size=(48, 8)).astype(np.float32)
    jeng = JaxEngine(JaxFoldIn(_stub_model(B), k=5, item_buckets=(4, 8), ingest_rows=False),
                     max_batch=4, max_depth=16, max_wait_ms=1.0)
    peng = ServingEngine(ALSFoldInTopK(_stub_model(B), k=5, item_buckets=(4, 8),
                                       ingest_rows=False),
                         max_batch=4, max_depth=16, max_wait_ms=1.0)
    jadmin = jax_httpexp.AdminServer(
        engine=jeng, submit_fn=lambda payload, **kw: jeng.serve_one(payload)).start()
    padmin = httpexp.AdminServer(engine=peng, submit_fn=cli._http_submit(peng),
                                 chaos_fn=httpexp.arm_faults).start()
    cold = {name: {path: _get(a.port, path) for path in ("/healthz", "/readyz")}
            for name, a in (("jax", jadmin), ("port", padmin))}
    jeng.start()
    peng.start()
    yield jeng, peng, jadmin, padmin, cold
    for eng, admin in ((jeng, jadmin), (peng, padmin)):
        admin.stop()
        eng.stop()


def test_readyz_is_503_until_warm_up_ends(servers):
    *_, cold = servers
    for name in ("jax", "port"):
        status, body = cold[name]["/readyz"]
        assert status == 503 and json.loads(body)["checks"]["warm"] is False, name
        assert cold[name]["/healthz"][0] == 200, name  # warm-up is not death
    assert _keys(*cold["port"]["/readyz"]) == _keys(*cold["jax"]["/readyz"])


def test_routes_answer_like_the_jax_server(servers):
    jeng, peng, jadmin, padmin, _ = servers
    for path in ROUTES:
        got, want = _get(padmin.port, path), _get(jadmin.port, path)
        assert _keys(*got) == _keys(*want), path
    status, body = _get(padmin.port, "/readyz")
    assert status == 200 and json.loads(body)["ready"] is True
    snap = json.loads(_get(padmin.port, "/snapshot")[1])
    assert set(snap) == set(json.loads(_get(jadmin.port, "/snapshot")[1]))
    assert json.loads(_get(padmin.port, "/")[1])["endpoints"][-2:] == ["POST /submit",
                                                                       "POST /chaos"]


def test_metrics_carry_the_jax_families(servers):
    _, _, jadmin, padmin, _ = servers
    status, text = _get(padmin.port, "/metrics")
    assert status == 200
    got, want = _families(text), _families(_get(jadmin.port, "/metrics")[1])
    assert got - want == PORT_ONLY_FAMILIES and want <= got
    assert padmin.scrapes == 1 and "dsddmm_admin_scrapes 1" in text


def test_submit_replies_are_the_in_process_bytes(servers):
    _, peng, _, padmin, _ = servers
    rng = np.random.default_rng(5)
    payloads = [peng.workload.sample_payload(rng) for _ in range(8)]
    want = peng.execute_now(payloads)
    before = peng.recorder.summary()["completed"]
    for p, w in zip(payloads, want):
        status, body, _ = httpexp.post_json("127.0.0.1", padmin.port, "/submit",
                                            {"payload": p})
        assert status == 200 and body["tenant"] == "default"
        got = {k: np.asarray(v, dtype=np.asarray(w[k]).dtype) for k, v in body["reply"].items()}
        assert set(got) == set(w)
        assert all(got[k].tobytes() == np.asarray(w[k]).tobytes() for k in w)
    assert peng.recorder.summary()["completed"] == before + len(payloads)
    assert httpexp.post_json("127.0.0.1", padmin.port, "/submit", {"payload": 3})[0] == 400
    assert httpexp.post_json("127.0.0.1", padmin.port, "/other", {})[0] == 404
    chains = json.loads(_get(padmin.port, "/debug/requests")[1])
    assert chains["complete"] >= len(payloads) and chains["requests"]


def test_serial_submit_is_the_host_rung_on_the_cpu_and_refused_on_the_card(servers):
    _, peng, _, padmin, _ = servers
    payload = peng.workload.sample_payload(np.random.default_rng(7))
    status, body, _ = httpexp.post_json("127.0.0.1", padmin.port, "/submit",
                                        {"payload": payload, "serial": True})
    want = peng.workload.serial(peng.workload.clamp(payload))
    assert status == 200 and set(body["reply"]) == set(want)
    assert all(np.asarray(body["reply"][k], dtype=np.asarray(w).dtype).tobytes()
               == np.asarray(w).tobytes() for k, w in want.items())
    # A replica on the card has no host rung: it refuses rather than answer
    # from the host, and its engine is never reached.
    card = types.SimpleNamespace(device=torch.device("cuda", 0), workload=None)
    with httpexp.AdminServer(submit_fn=cli._http_submit(card)) as admin:
        status, body, _ = httpexp.post_json("127.0.0.1", admin.port, "/submit",
                                            {"payload": payload, "serial": True})
    assert status == 400 and "no host rung" in body["error"]


def test_shed_is_a_429_with_retry_after():
    def shed(payload, **kw):
        raise ShedError("queue full", retry_after_s=0.25)

    with httpexp.AdminServer(submit_fn=shed) as admin:
        status, body, headers = httpexp.post_json("127.0.0.1", admin.port, "/submit",
                                                  {"payload": {}})
        assert status == 429 and body["shed"] and headers["Retry-After"] == "0.250"
        assert _get(admin.port, "/healthz") == (200, '{"ok": true, "mode": "exporter"}\n')
        assert _get(admin.port, "/snapshot")[0] == 404


def test_chaos_arms_a_fault_plan():
    with httpexp.AdminServer(chaos_fn=httpexp.arm_faults) as admin:
        try:
            status, ack, _ = httpexp.post_json(
                "127.0.0.1", admin.port, "/chaos",
                {"faults": [{"site": "output:serveBatch", "kind": "nan", "prob": 1.0}]})
            assert status == 200 and ack["armed"] and ack["specs"] == 1
            assert faults.active() is not None
            assert httpexp.post_json("127.0.0.1", admin.port, "/chaos",
                                     {"faults": 3})[0] == 400
        finally:
            faults.clear()


def test_exposition_text_equals_jax_on_the_same_snapshots(servers):
    jeng, *_ = servers
    snap = jax_telemetry.engine_snapshot(jeng, run_id="r")
    cases = [snap, dict(snap, burn_rate=0.75, batch_occupancy=None),
             {"queue_depth": 2, "latency_hist": None}]
    for case in cases:
        got, want = httpexp.Exposition(), jax_httpexp.Exposition()
        httpexp._expose_snapshot(got, case)
        jax_httpexp._expose_snapshot(want, case)
        assert got.render() == want.render()
    got, want = httpexp.Exposition(), jax_httpexp.Exposition()
    for expo in (got, want):
        expo.counter("c_total", 3, "a counter", labels={"op": 'a"b'})
        expo.gauge("g", float("nan"))
        expo.gauge("g", 2.5, labels={"x": "1"})
    hist = telemetry.LatencyHistogram()
    jhist = jax_telemetry.LatencyHistogram()
    for v in (0.1, 3.0, 4e4):
        hist.add(v)
        jhist.add(v)
    got.histogram_ms("h", hist, sum_ms=1.5, help_text="lat")
    want.histogram_ms("h", jhist, sum_ms=1.5, help_text="lat")
    assert got.render() == want.render()


def test_op_metrics_expose_the_walk_idle_gauge():
    m = metrics.OpMetrics()
    m.record("fusedSpMM", 0.5, flops=8.0)
    m.note_structure("fusedSpMM", walk_idle_frac=44.9)
    expo = httpexp.Exposition()
    httpexp._expose_op_metrics(expo, m)
    text = expo.render()
    assert 'dsddmm_op_walk_idle_frac{op="fusedSpMM"} 44.9' in text
    assert 'dsddmm_op_calls_total{op="fusedSpMM"} 1' in text
    assert "walk_idle_frac" not in m.to_dict()["fusedSpMM"]  # records keep the JAX fields
