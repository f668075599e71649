"""The admin HTTP surface of one process: ``/metrics``, health, the debug
ring, request ingestion (counterpart of ``obs/httpexp.py``).

The rest of the obs stack writes files read after a run; this is what a
scraper, a load balancer or an operator reads while the process serves.
Standard library only (``http.server``), one daemon thread, loopback by
default.

Endpoints (:class:`AdminServer`):

* ``/metrics`` -- Prometheus text format 0.0.4: every
  :data:`KNOWN_GLOBAL_COUNTERS` counter, the per-op ``OpMetrics`` and
  their structure gauge (``dsddmm_op_walk_idle_frac``), the queue
  gauges, the engine's cell counters, the SLO burn rate, and the request
  :class:`~distributed_sddmm_tpu_torch.obs.telemetry.LatencyHistogram` as
  a cumulative-bucket histogram. The family names are the JAX package's,
  so a dashboard reads either package's scrape.
* ``/healthz`` -- liveness: 200 while the engine's runner lives (or has
  not started yet: warm-up is not death), 503 once it died.
* ``/readyz`` -- readiness: 200 only while the runner lives, the ladder
  is warm and the SLO burn rate is at most ``burn_threshold``.
* ``/debug/requests`` -- the last request timelines, rebuilt from the
  tracer's span ring (armed by :meth:`AdminServer.start`) through
  ``tools/tracereport.request_chains``.
* ``/snapshot`` -- :func:`~distributed_sddmm_tpu_torch.obs.telemetry.
  engine_snapshot` (``bench top --admin-port`` reads it).
* ``POST /submit`` -- with a ``submit_fn`` (``bench serve --serve-http``):
  ``{"payload": {...}, "tenant": "...", "serial": false}`` in, the reply
  out, or 429 with ``Retry-After`` when admission sheds.
* ``POST /chaos`` -- with a ``chaos_fn`` (:func:`arm_faults` in replica
  mode): install a fault plan in the running process.

The fleet trace header (``X-DSDDMM-Trace``) is not read: the fleet and
its trace context are not ported yet, and a request with the header is
served as one without it.

Every read of the engine is of host state (``engine_snapshot``'s rule):
a scrape never synchronises the card.
"""

from __future__ import annotations

import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import urlsplit

from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.obs import log as obs_log
from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics
from distributed_sddmm_tpu_torch.obs import trace as obs_trace
from distributed_sddmm_tpu_torch.obs.telemetry import LatencyHistogram, engine_snapshot

#: The GLOBAL counters exported, with their help text: the JAX package's
#: list (the tuner's and the fleet's included, 0 until they fire) and the
#: port's ``serve_error_batches``.
KNOWN_GLOBAL_COUNTERS: dict = {
    "faults_fired": "injected faults fired (resilience/faults.py)",
    "exec_retries": "dispatch retries across offline + serving paths",
    "guard_repairs": "NaN/Inf outputs repaired by guards",
    "checkpoints_saved": "checkpoint steps persisted",
    "checkpoints_loaded": "checkpoint steps restored",
    "plan_cache_hits": "autotune plan-cache hits",
    "plan_cache_misses": "autotune plan-cache misses",
    "autotune_trial_retries": "autotune measured-trial retries",
    "autotune_candidates_dropped": "autotune candidates pruned pre-trial",
    "watchdog_anomalies": "anomalies recorded by the in-run watchdog",
    "program_store_hits": "AOT program store disk hits",
    "program_store_misses": "AOT program store misses",
    "live_compiles": "in-process compiles (cold-start cost)",
    "codegen_variants_built": "specialized banked kernel encodings built",
    "codegen_generic_fallbacks":
        "kernel-variant requests that fell back to the generic encoding",
    "serve_shed": "requests shed by admission control",
    "serve_degraded_batches": "serving batches degraded to the serial rung",
    "flightrec_dumps": "flight-recorder snapshots written",
    "tuner_scans": "closed-loop tuner signal-mining cycles",
    "tuner_signals": "re-tune trigger signals mined (tuner/signals.py)",
    "tuner_retunes": "off-path re-measurement cycles run by the tuner",
    "tuner_shadow_replays":
        "mirrored request groups replayed on a challenger ladder",
    "tuner_shadow_mismatches":
        "shadow replies that diverged from the incumbent (blocks promotion)",
    "tuner_promotions": "challenger ladders hot-swapped into serving",
    "tuner_rejects": "challengers abandoned (mismatch, stale, or no better)",
    "fleet_hedges": "hedged (duplicate) submits fired by the fleet router",
    "fleet_hedge_wins": "hedged submits whose backup reply won the race",
    "fleet_audit_mismatches":
        "cross-replica reply comparisons that disagreed bit-for-bit",
    "fleet_breaker_opens": "per-replica circuit breakers tripped open",
    "fleet_quarantines": "replicas quarantined for autopsy (byzantine/gray)",
    "dynstruct_rebinds":
        "structure changes bound into live programs with zero retraces",
    "dynstruct_bucket_spills":
        "structure changes that outgrew a capacity rung (full rebuild)",
    "structure_retraces":
        "program retraces forced by a structure change (the spill cost)",
    "serve_error_batches": "serving batches failed on the card past every retry",
}

#: Exposition metric-name prefix (the JAX package's).
PREFIX = "dsddmm"


def _json_default(o):
    """JSON for array-like payloads and replies: ``tolist()`` / ``item()``
    keep int64 and float values exact (shortest-repr floats round-trip), so
    a decoded payload clamped by the workload is the original's bits."""
    tolist = getattr(o, "tolist", None)
    if callable(tolist):
        return tolist()
    item = getattr(o, "item", None)
    if callable(item):
        return item()
    return str(o)


def _fmt_value(v) -> str:
    """A Prometheus sample value: floats plainly, NaN allowed."""
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


class Exposition:
    """Prometheus text-format builder (one HELP/TYPE a family)."""

    def __init__(self):
        #: family -> (type, help, [(labels or None, value), ...])
        self._fams: dict[str, tuple[str, str, list]] = {}
        self._order: list[str] = []

    def _family(self, name: str, kind: str, help_text: str) -> list:
        fam = self._fams.get(name)
        if fam is None:
            fam = self._fams[name] = (kind, help_text, [])
            self._order.append(name)
        return fam[2]

    def counter(self, name, value, help_text="", labels=None):
        self._family(name, "counter", help_text).append((labels, value))

    def gauge(self, name, value, help_text="", labels=None):
        self._family(name, "gauge", help_text).append((labels, value))

    def histogram_ms(self, name, hist: LatencyHistogram, sum_ms=None, help_text=""):
        """Cumulative ``le`` buckets and ``+Inf`` from a fixed-bucket
        histogram (whose buckets are disjoint counts). ``_sum`` is the
        caller's mean-times-count estimate, NaN when unknown."""
        samples = self._family(name, "histogram", help_text)
        cum = 0
        for bound, count in zip(hist.bounds_ms, hist.counts):
            cum += count
            samples.append(({"le": _fmt_value(float(bound))}, cum))
        total = hist.total
        samples.append(({"le": "+Inf"}, total))
        samples.append(("_count", total))
        samples.append(("_sum", float("nan") if sum_ms is None else sum_ms))

    def render(self) -> str:
        lines = []
        for name in self._order:
            kind, help_text, samples = self._fams[name]
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                if labels in ("_count", "_sum"):
                    lines.append(f"{name}{labels} {_fmt_value(value)}")
                elif kind == "histogram":
                    lines.append(f'{name}_bucket{{le="{labels["le"]}"}} {_fmt_value(value)}')
                elif labels:
                    lab = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
                    lines.append(f"{name}{{{lab}}} {_fmt_value(value)}")
                else:
                    lines.append(f"{name} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"


# ----------------------------------------------------- sources -> families


def _expose_global(expo: Exposition) -> None:
    """Every known GLOBAL counter, 0 until bumped (a counter exists from
    the first scrape)."""
    snap = obs_metrics.GLOBAL.snapshot()
    for name, help_text in KNOWN_GLOBAL_COUNTERS.items():
        expo.counter(f"{PREFIX}_{name}_total", snap.get(name, 0.0), help_text)


_OP_FIELDS = (
    ("calls", f"{PREFIX}_op_calls_total", "dispatches per op"),
    ("kernel_s", f"{PREFIX}_op_kernel_seconds_total", "successful-attempt kernel seconds per op"),
    ("overhead_s", f"{PREFIX}_op_overhead_seconds_total",
     "retry/fault/guard overhead seconds per op"),
    ("retries", f"{PREFIX}_op_retries_total", "retries per op"),
    ("comm_words", f"{PREFIX}_op_comm_words_total",
     "counted per-device communication words per op"),
    ("comm_bytes", f"{PREFIX}_op_comm_bytes_total",
     "counted per-device communication bytes per op (wire-dtype aware)"),
    ("flops", f"{PREFIX}_op_flops_total", "analytic useful FLOPs per op"),
)


def _expose_op_metrics(expo: Exposition, op_metrics) -> None:
    ops = op_metrics.to_dict()
    for field, metric, help_text in _OP_FIELDS:
        for op, rec in ops.items():
            expo.counter(metric, rec[field], help_text, labels={"op": op})
    for op, g in op_metrics.structure_gauges().items():
        if "walk_idle_frac" in g:
            expo.gauge(f"{PREFIX}_op_walk_idle_frac", g["walk_idle_frac"],
                       "counted idle share of the generic CSR walk of the op's tiles",
                       labels={"op": op})


def _expose_engine(expo: Exposition, engine, slo=None) -> None:
    """A live engine: its snapshot through :func:`_expose_snapshot` (one
    family set for both sources) and the engine-only counters."""
    _expose_snapshot(expo, engine_snapshot(engine, slo=slo))
    stats = engine.stats()
    expo.counter(f"{PREFIX}_served_requests_total", stats.get("served", 0),
                 "requests answered by the runner")
    expo.counter(f"{PREFIX}_degraded_batches_total", stats.get("degraded_batches", 0),
                 "batches that fell to the serial rung")


def _expose_snapshot(expo: Exposition, snap: dict, sum_ms=None) -> None:
    """One snapshot dict (live or re-read from a stream) on the metric
    families; the histogram's ``_sum`` is the snapshot's
    ``latency_sum_ms`` unless the caller overrides it."""
    expo.gauge(f"{PREFIX}_queue_depth", snap.get("queue_depth", 0), "serving queue depth")
    expo.gauge(f"{PREFIX}_queue_capacity", snap.get("queue_capacity", 0),
               "admission bound (requests shed beyond it)")
    if snap.get("batch_occupancy") is not None:
        expo.gauge(f"{PREFIX}_batch_occupancy_mean", snap["batch_occupancy"],
                   "mean micro-batch fill fraction")
    expo.counter(f"{PREFIX}_requests_submitted_total", snap.get("submitted", 0),
                 "requests admitted past the queue")
    for field, metric in (("completed", "requests_completed_total"),
                          ("errors", "requests_errors_total"),
                          ("shed", "requests_shed_total"),
                          ("degraded", "requests_degraded_total")):
        expo.counter(f"{PREFIX}_{metric}", snap.get(field, 0), f"recorder {field}")
    for field in ("cache_hits", "cache_misses", "disk_hits", "live_compiles"):
        v = (snap.get("program_store") or {}).get(field)
        if v is not None:
            expo.counter(f"{PREFIX}_program_{field}_total", v, f"engine program-cache {field}")
    hist = LatencyHistogram.from_dict(snap.get("latency_hist")) or LatencyHistogram()
    if sum_ms is None:
        sum_ms = snap.get("latency_sum_ms")
    expo.histogram_ms(f"{PREFIX}_request_latency_ms", hist, sum_ms=sum_ms,
                      help_text="end-to-end request latency (ms)")
    if snap.get("burn_rate") is not None:
        expo.gauge(f"{PREFIX}_slo_burn_rate", snap["burn_rate"],
                   "worst-axis error-budget burn rate (1.0 = at budget)")


# ------------------------------------------------------------ the server


def arm_faults(body: dict) -> dict:
    """``POST /chaos``: install the fault plan ``body["faults"]`` (a spec
    ``FaultPlan.from_spec`` reads) in this process, and the guard mode
    ``body["guard_mode"]`` (raise or repair) when given. A malformed body
    raises ``ValueError`` (a 400)."""
    from distributed_sddmm_tpu_torch.resilience import faults
    from distributed_sddmm_tpu_torch.resilience.guards import GUARD_MODE_ENV

    spec = body.get("faults")
    if not isinstance(spec, (dict, list, str)):
        raise ValueError("body.faults must be a plan spec")
    plan = faults.FaultPlan.from_spec(spec)
    mode = body.get("guard_mode")
    if mode is not None and mode not in ("raise", "repair"):
        raise ValueError(f"bad guard_mode: {mode!r}")
    faults.install(plan)
    if mode is not None:
        os.environ[GUARD_MODE_ENV] = str(mode)
    return {"armed": True, "specs": len(plan.specs), "seed": plan.seed, "guard_mode": mode}


class AdminServer:
    """The operational HTTP surface of one process.

    Built on a live ``engine`` (``bench serve --admin-port``) or on a
    ``snapshot_fn`` returning the latest snapshot dict (``bench top
    --serve``, an exporter over a stream); ``op_metrics`` adds the per-op
    families, ``slo`` the burn-rate gauge and the readiness check.
    ``port=0`` binds an ephemeral port (read :attr:`port` after
    :meth:`start`)."""

    def __init__(self, engine=None, op_metrics=None, slo=None,
                 snapshot_fn: Optional[Callable[[], Optional[dict]]] = None,
                 host: str = "127.0.0.1", port: int = 0, burn_threshold: float = 1.0,
                 ring_capacity: int = 512, debug_requests_limit: int = 64,
                 submit_fn: Optional[Callable] = None,
                 chaos_fn: Optional[Callable[[dict], dict]] = None):
        self.engine = engine
        self.op_metrics = op_metrics
        self.slo = slo
        self.snapshot_fn = snapshot_fn
        #: ``submit_fn(payload, tenant=..., serial=..., timeout_s=...)`` ->
        #: reply; None leaves the server read-only (no /submit).
        self.submit_fn = submit_fn
        #: ``chaos_fn(body)`` -> ack, serving ``POST /chaos``; None: 404.
        self.chaos_fn = chaos_fn
        self.host = host
        self.port = int(port)
        self.burn_threshold = float(burn_threshold)
        self.ring_capacity = int(ring_capacity)
        self.debug_requests_limit = int(debug_requests_limit)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._armed_ring = False
        self.scrapes = 0

    # -------------------------------------------------------------- bodies

    def metrics_text(self) -> str:
        expo = Exposition()
        _expose_global(expo)
        if self.op_metrics is not None:
            _expose_op_metrics(expo, self.op_metrics)
        if self.engine is not None:
            _expose_engine(expo, self.engine, slo=self.slo)
        elif self.snapshot_fn is not None:
            snap = self.snapshot_fn()
            if snap:
                _expose_snapshot(expo, snap)
        expo.gauge(f"{PREFIX}_admin_scrapes", self.scrapes, "scrapes served by this admin server")
        return expo.render()

    def snapshot(self) -> Optional[dict]:
        """The ``/snapshot`` body."""
        if self.engine is not None:
            return engine_snapshot(self.engine, slo=self.slo, run_id=obs_trace.run_id())
        if self.snapshot_fn is not None:
            return self.snapshot_fn()
        return None

    def health(self) -> tuple[int, dict]:
        """Liveness. The server comes up before warm-up, so that readiness
        can report it: an engine not started yet is alive; only a runner
        that started and died is down."""
        if self.engine is None:
            return 200, {"ok": True, "mode": "exporter"}
        started = bool(getattr(self.engine, "ever_started", True))
        alive = self.engine.runner_alive() or not started
        return (200 if alive else 503), {"ok": alive,
                                         "runner_alive": self.engine.runner_alive(),
                                         "started": started}

    def readiness(self) -> tuple[int, dict]:
        """Readiness: alive, warm and within the SLO's error budget."""
        checks: dict = {}
        if self.engine is not None:
            checks["runner_alive"] = self.engine.runner_alive()
            checks["warm"] = bool(getattr(self.engine, "warmed", False))
            if self.slo is not None:
                burn = self.slo.burn_rate(self.engine.recorder.summary())
                checks["burn_rate"] = burn
                checks["slo_burn_ok"] = burn is None or burn <= self.burn_threshold
        elif self.snapshot_fn is not None:
            snap = self.snapshot_fn()
            checks["snapshot_available"] = snap is not None
            if snap is not None and snap.get("burn_rate") is not None:
                checks["burn_rate"] = snap["burn_rate"]
                checks["slo_burn_ok"] = snap["burn_rate"] <= self.burn_threshold
        ready = all(v for v in checks.values() if isinstance(v, bool)) if checks else True
        return (200 if ready else 503), {"ready": ready, "checks": checks}

    def debug_requests(self) -> dict:
        """The last request timelines, from the tracer's span ring."""
        from distributed_sddmm_tpu_torch.tools import tracereport

        ring = obs_trace.ring()
        if ring is None:
            return {"error": "span ring not armed", "requests": []}
        recs = ring.records()
        pseudo = {"begin": None, "spans": [r for r in recs if r.get("type") == "span"],
                  "events": [r for r in recs if r.get("type") == "event"], "errors": []}
        chains = tracereport.request_chains(pseudo)
        rows = sorted(chains["requests"].values(),
                      key=lambda ch: ch.get("t_reply") or ch.get("t_enqueue") or 0.0,
                      )[-self.debug_requests_limit:]
        return {"ring_records": len(recs), "ring_seen": ring.appended,
                "complete": chains["complete"], "incomplete": chains["incomplete"],
                "inconsistent": chains["inconsistent"], "shed": chains["shed"],
                "requests": rows}

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "AdminServer":
        if self._httpd is not None:
            raise RuntimeError("admin server already started")
        # /debug/requests reads the ring; stop() disarms it only if we armed it.
        self._armed_ring = obs_trace.ring() is None
        obs_trace.arm_ring(self.ring_capacity)
        admin = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "dsddmm-admin/1"
            protocol_version = "HTTP/1.1"

            def _guarded(self, route):
                try:
                    route(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 -- a 500, never the server's death
                    try:
                        admin._send(self, 500, f"internal error: {type(e).__name__}: {e}",
                                    "text/plain")
                    except Exception:  # noqa: BLE001
                        pass

            def do_GET(self):  # noqa: N802 -- http.server API
                self._guarded(admin._route)

            def do_POST(self):  # noqa: N802
                self._guarded(admin._route_post)

            def log_message(self, fmt, *args):
                obs_log.log("debug", "admin", fmt % args)

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.2}, daemon=True,
                                        name=f"admin-{self.port}")
        self._thread.start()
        obs_log.info("admin", "serving", url=f"http://{self.host}:{self.port}")
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        if self._armed_ring:
            from distributed_sddmm_tpu_torch.obs import flightrec

            # Never pull the ring from under an armed flight recorder.
            if flightrec.active() is None:
                obs_trace.disarm_ring()
            self._armed_ring = False

    def __enter__(self) -> "AdminServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- routing

    def _route(self, handler: BaseHTTPRequestHandler) -> None:
        path = urlsplit(handler.path).path.rstrip("/") or "/"
        if path == "/metrics":
            self.scrapes += 1
            self._send(handler, 200, self.metrics_text(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            self._send_json(handler, *self.health())
        elif path == "/readyz":
            self._send_json(handler, *self.readiness())
        elif path == "/debug/requests":
            self._send_json(handler, 200, self.debug_requests())
        elif path == "/snapshot":
            snap = self.snapshot()
            if snap is None:
                self._send_json(handler, 404, {"error": "no snapshot source"})
            else:
                self._send_json(handler, 200, snap)
        elif path == "/":
            endpoints = ["/metrics", "/healthz", "/readyz", "/debug/requests", "/snapshot"]
            if self.submit_fn is not None:
                endpoints.append("POST /submit")
            if self.chaos_fn is not None:
                endpoints.append("POST /chaos")
            self._send_json(handler, 200, {"endpoints": endpoints, "t_epoch": clock.epoch()})
        else:
            self._send(handler, 404, f"no such endpoint: {path}\n", "text/plain")

    @staticmethod
    def _read_json(handler) -> dict:
        length = int(handler.headers.get("Content-Length") or 0)
        raw = handler.rfile.read(length) if length else b""
        return json.loads(raw.decode() or "{}")

    def _route_post(self, handler: BaseHTTPRequestHandler) -> None:
        from distributed_sddmm_tpu_torch.serve.queue import ShedError

        path = urlsplit(handler.path).path.rstrip("/") or "/"
        fn = {"/submit": self.submit_fn, "/chaos": self.chaos_fn}.get(path)
        if fn is None:
            self._send(handler, 404, f"no such POST endpoint: {path}\n", "text/plain")
            return
        try:
            body = self._read_json(handler)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self._send_json(handler, 400, {"error": f"bad JSON: {e}"})
            return
        if path == "/chaos":
            try:
                ack = fn(body)
            except ValueError as e:
                self._send_json(handler, 400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 -- a typed 500
                self._send_json(handler, 500, {"error": f"{type(e).__name__}: {e}"})
            else:
                self._send_json(handler, 200, ack or {"armed": True})
            return
        payload = body.get("payload")
        if not isinstance(payload, dict):
            self._send_json(handler, 400, {"error": "body.payload must be an object"})
            return
        tenant = str(body.get("tenant") or "default")
        kwargs = {"tenant": tenant, "serial": bool(body.get("serial")),
                  "timeout_s": float(body.get("timeout_s") or 30.0)}
        try:
            reply = fn(payload, **kwargs)
        except ShedError as e:
            # The backpressure hint crosses the process boundary as a header.
            retry_s = float(getattr(e, "retry_after_s", 0.0) or 0.0)
            self._send_json(handler, 429,
                            {"error": str(e), "shed": True, "retry_after_s": retry_s},
                            extra_headers={"Retry-After": f"{retry_s:.3f}"})
        except ValueError as e:
            self._send_json(handler, 400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 -- a typed 500
            self._send_json(handler, 500, {"error": f"{type(e).__name__}: {e}"})
        else:
            self._send_json(handler, 200, {"reply": reply, "tenant": tenant})

    @staticmethod
    def _send(handler, code: int, body: str, content_type: str,
              extra_headers: Optional[dict] = None) -> None:
        payload = body.encode()
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(payload)))
        for k, v in (extra_headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(payload)

    @staticmethod
    def _send_json(handler, code: int, body: dict, extra_headers: Optional[dict] = None) -> None:
        AdminServer._send(handler, code, json.dumps(body, default=_json_default) + "\n",
                          "application/json", extra_headers=extra_headers)


def fetch_json(host: str, port: int, path: str = "/snapshot", timeout_s: float = 2.0) -> dict:
    """GET a JSON endpoint of an admin server (``bench top --admin-port``).
    A connection failure raises from the ``OSError`` family; an HTTP error
    status raises ``urllib.error.HTTPError``."""
    import urllib.request

    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def post_json(host: str, port: int, path: str, body: dict, timeout_s: float = 30.0,
              headers: Optional[dict] = None) -> tuple[int, dict, dict]:
    """POST JSON to an admin server: ``(status, decoded body, headers)``.
    HTTP error statuses (429 and the rest) come back, not raised: a shed
    is a reply. A connection failure raises from the ``OSError`` family."""
    import urllib.error
    import urllib.request

    hdrs = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 data=json.dumps(body, default=_json_default).encode(),
                                 method="POST", headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read().decode()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            decoded = json.loads(raw.decode())
        except Exception:  # noqa: BLE001 -- a body that is not JSON
            decoded = {"error": raw.decode(errors="replace")}
        return e.code, decoded, dict(e.headers)
