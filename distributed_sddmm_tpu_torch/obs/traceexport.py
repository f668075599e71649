"""Chrome trace-event export: any trace opens in Perfetto (counterpart of
``obs/traceexport.py``).

Converts a schema-valid trace, merged ``bench trace-merge`` outputs (whose
records carry ``shard``/``pid`` tags) included, into the Chrome
trace-event JSON (``{"traceEvents": [...]}``) that https://ui.perfetto.dev
and ``chrome://tracing`` open.

* One **process lane a shard** (a one-process trace is one lane named
  after its run id) and one **thread lane a source thread**, announced by
  ``process_name``/``thread_name`` metadata events.
* **Spans become B/E pairs** on the merged (calibrated) monotonic clock,
  their attrs as ``args``. At equal timestamps E closes deepest first and B
  opens shallowest first, so viewers rebuild the exact span tree.
* **Events become instants** (``ph:"i"``), except the request events
  ``serve:enqueue``/``serve:reply``/``serve:shed``, which become 1 us
  marker slices (``ph:"X"``): a flow binds to a slice, not an instant.
* **Request chains become flows**: enqueue -> batch -> reply, one
  ``s``/``t``/``f`` triple a request, the joins
  ``tools/tracereport.request_chains`` checks.
* **Fleet links become flows across processes**: every record the merge
  re-parented across shards (``attrs.fleet_parent``) gets an arrow from
  its parent span's lane.

CLI: ``python -m distributed_sddmm_tpu_torch.bench trace-export TRACE.jsonl
[-o OUT.json]`` (exit 2 on a schema-invalid trace, as ``report-trace``).
"""

from __future__ import annotations

import json
import pathlib

from distributed_sddmm_tpu_torch.tools import tracereport
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_text

#: Trace events exported as 1µs marker slices instead of instants so
#: request flows have slices to bind to.
_MARKER_EVENTS = ("serve:enqueue", "serve:reply", "serve:shed")
_MARKER_DUR_US = 1.0


def _us(t_s: float) -> float:
    return round(t_s * 1e6, 3)


class _Lanes:
    """shard → Chrome pid, (shard, raw tid) → Chrome tid, plus the
    metadata events announcing both."""

    def __init__(self, begin: dict | None):
        self._pids: dict = {}
        self._tids: dict = {}
        self.meta: list[dict] = []
        self._begin = begin or {}
        # Merged traces pre-declare their shards (keeps lane order
        # deterministic: shard meta order, not record order).
        for meta in self._begin.get("shards") or ():
            self.pid(meta.get("run_id"), os_pid=meta.get("pid"))

    def pid(self, shard, os_pid=None) -> int:
        if shard not in self._pids:
            p = len(self._pids) + 1
            self._pids[shard] = p
            label = shard or self._begin.get("run_id") or "trace"
            if os_pid is None and shard is None:
                os_pid = self._begin.get("pid")
            if os_pid is not None:
                label = f"{label} (pid {os_pid})"
            self.meta.append({
                "name": "process_name", "ph": "M", "pid": p,
                "args": {"name": f"shard {label}"},
            })
            self.meta.append({
                "name": "process_sort_index", "ph": "M", "pid": p,
                "args": {"sort_index": p},
            })
        return self._pids[shard]

    def tid(self, shard, raw_tid) -> int:
        key = (shard, raw_tid)
        if key not in self._tids:
            pid = self.pid(shard)
            t = sum(1 for (s, _r) in self._tids if s == shard) + 1
            self._tids[key] = (pid, t)
            self.meta.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                "args": {"name": f"thread {raw_tid}"},
            })
        return self._tids[key][1]


def _span_depths(spans: list[dict]) -> dict:
    """span id → nesting depth (root = 0), from parent links."""
    parent = {sp["id"]: sp.get("parent") for sp in spans}
    depths: dict = {}

    def depth(i):
        if i in depths:
            return depths[i]
        seen = []
        d = 0
        node = i
        while node is not None and node not in depths:
            seen.append(node)
            node = parent.get(node)
            d += 1
            if d > len(parent) + 1:  # cycle guard: malformed parent
                break
        base = depths.get(node, -1)
        for off, n in enumerate(reversed(seen), 1):
            depths[n] = base + off
        return depths[i]

    for sp in spans:
        depth(sp["id"])
    return depths


def _request_flows(trace: dict, lanes: _Lanes) -> list[dict]:
    """One ``s``/``t``/``f`` flow triple per fully-joined request."""
    enq: dict = {}
    rep: dict = {}
    for ev in trace["events"]:
        req = ev["attrs"].get("req")
        if req is None:
            continue
        key = tracereport.req_key(ev, req)
        if ev["name"] == "serve:enqueue":
            enq[key] = ev
        elif ev["name"] == "serve:reply":
            rep[key] = ev
    batch: dict = {}
    for sp in trace["spans"]:
        if sp["name"] != "serve:batch":
            continue
        for req in sp["attrs"].get("req_ids") or ():
            batch[tracereport.req_key(sp, req)] = sp
    flows = []
    for fid, key in enumerate(sorted(enq, key=str), 1):
        e, b, r = enq[key], batch.get(key), rep.get(key)
        if b is None or r is None:
            continue
        common = {"name": "request", "cat": "request", "id": fid,
                  "args": {"req": e["attrs"]["req"], "shard": key[0]}}
        flows.append({
            **common, "ph": "s",
            "pid": lanes.pid(e.get("shard")),
            "tid": lanes.tid(e.get("shard"), e["tid"]),
            "ts": _us(e["t"]) + _MARKER_DUR_US / 2,
        })
        flows.append({
            **common, "ph": "t",
            "pid": lanes.pid(b.get("shard")),
            "tid": lanes.tid(b.get("shard"), b["tid"]),
            "ts": round(_us(b["t0"]) + max(
                _us(b["t1"]) - _us(b["t0"]), _MARKER_DUR_US) / 2, 3),
        })
        flows.append({
            **common, "ph": "f", "bp": "e",
            "pid": lanes.pid(r.get("shard")),
            "tid": lanes.tid(r.get("shard"), r["tid"]),
            "ts": _us(r["t"]) + _MARKER_DUR_US / 2,
        })
    return flows


#: Flow-id offset keeping fleet arrows disjoint from request flows.
_FLEET_FLOW_BASE = 10_000_000


def _slice_mid_us(t0_s: float, t1_s: float) -> float:
    """A timestamp strictly inside a slice, for flow binding."""
    return round((_us(t0_s) + _us(t1_s)) / 2, 3)


def _fleet_flows(trace: dict, lanes: _Lanes) -> list[dict]:
    """One ``s``/``f`` flow pair per cross-process fleet link.

    The merge pass re-parents a record onto its causal parent in
    another shard (or thread) and records the merged id as
    ``attrs.fleet_parent``; each such re-parented record — the
    replica's enqueue marker under the router's attempt span, a
    side-thread hedge/audit attempt under its request span — gets an
    arrow from the parent span's lane. Records whose in-process parent
    survived the merge (``serve:reply`` under ``serve:batch``) keep
    their nesting and need no arrow.
    """
    span_by_id = {sp["id"]: sp for sp in trace["spans"]}
    linked = [
        rec for rec in trace["spans"] + trace["events"]
        if isinstance(rec.get("attrs"), dict)
        and rec["attrs"].get("fleet_parent") is not None
        and rec.get("parent") == rec["attrs"]["fleet_parent"]
        and (rec["type"] == "span" or rec["name"] in _MARKER_EVENTS)
    ]
    flows = []
    fid = _FLEET_FLOW_BASE
    for rec in sorted(linked, key=lambda r: r["id"]):
        parent = span_by_id.get(rec["attrs"]["fleet_parent"])
        if parent is None:
            continue
        fid += 1
        common = {
            "name": "fleet", "cat": "fleet", "id": fid,
            "args": {"fleet_req": rec["attrs"].get("fleet_req"),
                     "to": rec["name"]},
        }
        if rec["type"] == "span":
            ts = _slice_mid_us(rec["t0"], rec["t1"])
        else:
            ts = _us(rec["t"]) + _MARKER_DUR_US / 2
        # The arrow starts just inside the parent slice's opening edge
        # (a slice midpoint could land AFTER the child record — e.g. a
        # long attempt span whose replica enqueued early — and Chrome
        # flows must run forward in time); it still binds to the
        # parent slice, and never past the child's anchor.
        flows.append({
            **common, "ph": "s",
            "pid": lanes.pid(parent.get("shard")),
            "tid": lanes.tid(parent.get("shard"), parent["tid"]),
            "ts": min(_us(parent["t0"]) + 1, ts),
        })
        flows.append({
            **common, "ph": "f", "bp": "e",
            "pid": lanes.pid(rec.get("shard")),
            "tid": lanes.tid(rec.get("shard"), rec["tid"]),
            "ts": ts,
        })
    return flows


def to_chrome(trace: dict) -> dict:
    """A ``tracereport.load_trace`` dict → Chrome trace-event JSON."""
    begin = trace.get("begin") or {}
    lanes = _Lanes(begin)
    depths = _span_depths(trace["spans"])
    out: list = []

    for sp in trace["spans"]:
        pid = lanes.pid(sp.get("shard"))
        tid = lanes.tid(sp.get("shard"), sp["tid"])
        d = depths.get(sp["id"], 0)
        # Ties at one timestamp: E before B (close the old span before
        # opening the next), E deepest-first, B shallowest-first.
        out.append(((_us(sp["t0"]), 2, d), {
            "name": sp["name"], "cat": "span", "ph": "B",
            "pid": pid, "tid": tid, "ts": _us(sp["t0"]),
            "args": sp.get("attrs") or {},
        }))
        out.append(((_us(sp["t1"]), 0, -d), {
            "ph": "E", "pid": pid, "tid": tid, "ts": _us(sp["t1"]),
        }))
    for ev in trace["events"]:
        pid = lanes.pid(ev.get("shard"))
        tid = lanes.tid(ev.get("shard"), ev["tid"])
        if ev["name"] in _MARKER_EVENTS:
            out.append(((_us(ev["t"]), 2, 0), {
                "name": ev["name"], "cat": "request", "ph": "X",
                "pid": pid, "tid": tid, "ts": _us(ev["t"]),
                "dur": _MARKER_DUR_US, "args": ev.get("attrs") or {},
            }))
        else:
            out.append(((_us(ev["t"]), 2, 0), {
                "name": ev["name"], "cat": "event", "ph": "i", "s": "t",
                "pid": pid, "tid": tid, "ts": _us(ev["t"]),
                "args": ev.get("attrs") or {},
            }))
    for fl in _request_flows(trace, lanes):
        out.append(((fl["ts"], 1, 0), fl))
    for fl in _fleet_flows(trace, lanes):
        out.append(((fl["ts"], 1, 0), fl))

    out.sort(key=lambda pair: pair[0])
    events = lanes.meta + [rec for _key, rec in out]
    n_flows = sum(1 for e in events
                  if e.get("ph") == "s" and e.get("cat") == "request")
    n_fleet = sum(1 for e in events
                  if e.get("ph") == "s" and e.get("cat") == "fleet")
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "exporter": "distributed_sddmm_tpu_torch trace-export",
            "run_id": begin.get("run_id"),
            "t0_epoch": begin.get("t0_epoch"),
            "shards": [m.get("run_id") for m in begin.get("shards") or ()],
            "spans": len(trace["spans"]),
            "events": len(trace["events"]),
            "request_flows": n_flows,
            "fleet_flows": n_fleet,
        },
    }


def write_chrome(trace_path, out_path=None, strict: bool = True):
    """Load + validate ``trace_path``, write its Chrome JSON.

    Returns ``(out_path, chrome_dict)``. Default output sits next to
    the trace: ``<stem>.chrome.json``. Raises ``ValueError`` on a
    schema-invalid trace when ``strict`` (the CLI maps that to exit 2).
    """
    trace = tracereport.load_trace(trace_path, strict=strict)
    chrome = to_chrome(trace)
    if out_path is None:
        p = pathlib.Path(trace_path)
        out_path = p.with_name(p.stem + ".chrome.json")
    out_path = pathlib.Path(out_path)
    # Atomic: Perfetto rejects truncated JSON with an opaque error — a
    # kill mid-export must leave the old file or none, never a prefix.
    atomic_write_text(out_path, json.dumps(chrome, default=str))
    return out_path, chrome
