"""Trace reader, schema validator and per-phase report (counterpart of
``tools/tracereport.py``).

Reads the JSONL traces ``obs/trace.py`` writes (and the sibling
``<run_id>.manifest.json``), the port's and the JAX package's alike: both
write schema 1. It gives

* a **per-phase table**: for every span name, calls, total seconds,
  kernel seconds against retry and fault overhead seconds (the split
  ``parallel/base.py::_timed`` attributes), retries, counted comm words
  and FLOPs;
* a **comm volume against the cost model**: counted words a device (the
  strategy's own layout arithmetic, summed a call) against the analytic
  prediction recomputed here from the trace's ``strategy`` event through
  ``tools/costmodel.pair_words``;
* an **events summary**: faults fired (by kind), retries, guard repairs,
  checkpoints, autotune trials and cache hits;
* the **request chains** of serving traces (``serve:enqueue`` ->
  ``serve:batch`` -> ``serve:reply``, whose segments must sum to the
  reply's ``total_s`` within 1 ms) and the **fleet chains** of merged
  fleet traces (router request -> winning attempt -> replica chain);
* a **program-store section** from ``program_store_hit`` /
  ``program_store_compile`` events.

The JAX reader's ``xla_flops`` / ``xla_ratio`` column (analytic FLOPs
against XLA's cost analysis of the compiled programs) is left out: eager
PyTorch compiles no XLA program, and the port's records carry no
``xla_cost``.

CLI::

    python -m distributed_sddmm_tpu_torch.tools.tracereport TRACE.jsonl [--json]
    python -m distributed_sddmm_tpu_torch.bench report-trace TRACE.jsonl

Validation is strict on structure (an unknown ``type``, a missing field,
span bounds out of order are errors) and lenient on content (unknown
attrs pass through).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

#: Required fields per record type (schema v1, obs/trace.py).
_REQUIRED = {
    "begin": ("schema", "run_id", "t0_epoch"),
    "span": ("name", "id", "tid", "t0", "t1", "dur_s", "attrs"),
    "event": ("name", "id", "tid", "t", "attrs"),
}

SUPPORTED_SCHEMA = 1


def validate_record(rec) -> list[str]:
    """Structural errors in one parsed record ([] = valid)."""
    errors = []
    if not isinstance(rec, dict):
        return ["record is not an object"]
    kind = rec.get("type")
    if kind not in _REQUIRED:
        return [f"unknown record type {kind!r}"]
    for field in _REQUIRED[kind]:
        if field not in rec:
            errors.append(f"{kind} record missing {field!r}")
    if kind == "begin" and rec.get("schema") not in (None, SUPPORTED_SCHEMA):
        errors.append(f"unsupported schema {rec.get('schema')!r}")
    if kind == "span" and not errors:
        if not isinstance(rec["attrs"], dict):
            errors.append("span attrs is not an object")
        if rec["t1"] < rec["t0"] or rec["dur_s"] < 0:
            errors.append("span bounds not monotonic")
    if kind == "event" and not isinstance(rec.get("attrs"), dict):
        errors.append("event attrs is not an object")
    return errors


def load_trace(path, strict: bool = True) -> dict:
    """Parse + validate a trace file.

    Returns ``{"begin", "spans", "events", "errors"}``; raises
    ``ValueError`` on any schema error when ``strict``.
    """
    begin = None
    spans, events, errors = [], [], []
    text = pathlib.Path(path).read_text()
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {ln}: not JSON ({e})")
            continue
        errs = validate_record(rec)
        if errs:
            errors.extend(f"line {ln}: {e}" for e in errs)
            continue
        if rec["type"] == "begin":
            if begin is None:
                begin = rec
        elif rec["type"] == "span":
            spans.append(rec)
        else:
            events.append(rec)
    if begin is None:
        errors.append("no begin record")
    if strict and errors:
        raise ValueError("invalid trace: " + "; ".join(errors[:5]))
    return {"begin": begin, "spans": spans, "events": events, "errors": errors}


def load_manifest(trace_path) -> dict | None:
    """The manifest written next to ``trace_path``, or None."""
    p = pathlib.Path(trace_path)
    mpath = p.with_name(p.stem + ".manifest.json")
    try:
        rec = json.loads(mpath.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


# --------------------------------------------------------------------- #
# Aggregation
# --------------------------------------------------------------------- #


def _strategy_meta(events: list) -> dict | None:
    """The last ``strategy`` event: the layout facts for the model
    comparison (a trace of one bench run has exactly one)."""
    metas = [e["attrs"] for e in events if e["name"] == "strategy"]
    return metas[-1] if metas else None


#: Tolerance for a request chain's segment-sum vs its recorded
#: end-to-end latency: the stamps partition the timeline exactly, so
#: anything beyond float rounding is a broken chain.
REQUEST_CHAIN_TOL_S = 1e-3

_CHAIN_SEGMENTS = ("queue_s", "batch_wait_s", "execute_s")


def req_key(rec: dict, req) -> tuple:
    """Request correlation key: (shard, req_id) — merged multi-process
    traces tag records with their source shard, under which each
    process's ids are unique. Public: ``obs/traceexport.py`` builds its
    Chrome request flows on exactly this join."""
    return (rec.get("shard"), req)


_req_key = req_key


def request_chains(trace: dict) -> dict:
    """Reconstruct per-request serving timelines from the trace alone.

    Returns ``{"requests": {key: chain}, "complete", "incomplete",
    "inconsistent", "shed"}`` where a chain is ``{"req", "t_enqueue",
    "t_reply", "segments", "total_s", "batch_span", "degraded",
    "complete", "consistent"}``. A chain is *complete* when its
    enqueue event, a batch span listing it, and its reply event are all
    present; *consistent* when the reply's segments sum to its
    ``total_s`` within :data:`REQUEST_CHAIN_TOL_S` AND the trace-level
    enqueue→reply distance agrees too.
    """
    chains: dict[tuple, dict] = {}
    shed = 0
    for ev in trace["events"]:
        a = ev["attrs"]
        if ev["name"] == "serve:enqueue":
            ch = chains.setdefault(_req_key(ev, a.get("req")), {})
            ch["req"] = a.get("req")
            ch["t_enqueue"] = ev["t"]
        elif ev["name"] == "serve:reply":
            ch = chains.setdefault(_req_key(ev, a.get("req")), {})
            ch["req"] = a.get("req")
            # Prefer the precise embedded stamps: the event's own `t`
            # is its emission instant, which can lag the reply by a
            # thread-scheduling delay (the client wakes on set_result
            # before the runner reaches the emit call).
            ch["t_reply"] = a.get("t_reply", ev["t"])
            if a.get("t_enqueue") is not None:
                ch["t_enqueue"] = a["t_enqueue"]
            ch["segments"] = {
                k: a[k] for k in (*_CHAIN_SEGMENTS, "pad_s") if k in a
            }
            ch["total_s"] = a.get("total_s")
            ch["degraded"] = a.get("degraded", False)
        elif ev["name"] == "serve:shed":
            shed += 1
    for sp in trace["spans"]:
        if sp["name"] != "serve:batch":
            continue
        for req in sp["attrs"].get("req_ids") or ():
            ch = chains.setdefault(_req_key(sp, req), {})
            ch.setdefault("req", req)
            ch["batch_span"] = sp["id"]
            # The pad sub-segment of execute_s is a property of the
            # dispatch, so the engine records it on the batch span —
            # join it into every member request's decomposition (it is
            # informational, not part of the partition sum).
            if sp["attrs"].get("pad_s") is not None:
                ch.setdefault("segments", {}).setdefault(
                    "pad_s", sp["attrs"]["pad_s"]
                )
    complete = incomplete = inconsistent = 0
    for ch in chains.values():
        ch["complete"] = all(
            k in ch for k in ("t_enqueue", "t_reply", "batch_span",
                              "total_s")
        ) and ch.get("total_s") is not None
        consistent = False
        if ch["complete"]:
            seg_sum = sum(
                ch["segments"].get(k, 0.0) for k in _CHAIN_SEGMENTS
            )
            consistent = (
                abs(seg_sum - ch["total_s"]) <= REQUEST_CHAIN_TOL_S
                and abs((ch["t_reply"] - ch["t_enqueue"]) - ch["total_s"])
                <= REQUEST_CHAIN_TOL_S
            )
        ch["consistent"] = consistent
        if not ch["complete"]:
            incomplete += 1
        elif consistent:
            complete += 1
        else:
            inconsistent += 1
    return {
        "requests": chains,
        "complete": complete,
        "incomplete": incomplete,
        "inconsistent": inconsistent,
        "shed": shed,
    }


def fleet_request_chains(trace: dict) -> dict:
    """Reconstruct fleet-level request trees (router → replica) from a
    merged trace.

    Joins each ``fleet:request`` span to its ``fleet:attempt`` spans
    (on the ``fleet_req`` attr) and — through the merge pass's
    cross-process ``fleet_parent`` links — to the replica-side
    enqueue→batch→reply chain the winning attempt caused. A DELIVERED
    request (outcome ``ok``) is COMPLETE when:

    * a winning attempt span exists (kind primary/hedge, outcome ok,
      replica == the request span's recorded ``winner``), its duration
      agreeing with the router's own recorded submit latency
      (``lat_s`` — the exact value in the router's hedge-delay window)
      within :data:`REQUEST_CHAIN_TOL_S`;
    * the winning attempt is causally connected to its request span
      (parent or ``fleet_parent`` link);
    * unless the request went to the serial tier, the winner's
      replica-side chain is present, complete and consistent
      (:func:`request_chains`' own 1 ms partition check), and linked
      back to the winning attempt.

    Hedge losers, failed/failover attempts, audits and arbitrations
    appear as annotated ``attempts`` branches — informational, never
    required for completeness.

    Returns ``{"requests": {fleet_req: chain}, "delivered",
    "complete", "failed", "hedged", "audited", "coverage"}`` where
    ``coverage`` is complete/delivered (1.0 when nothing delivered —
    the regress gate's clean-run value).
    """
    attempts_by_req: dict = {}
    req_spans = []
    for sp in trace["spans"]:
        if sp["name"] == "fleet:request":
            req_spans.append(sp)
        elif sp["name"] == "fleet:attempt":
            fr = sp["attrs"].get("fleet_req")
            if fr is not None:
                attempts_by_req.setdefault(fr, []).append(sp)
    # Replica-side chains keyed by fleet request id: the enqueue/reply
    # events carry the fleet attrs, joining request_chains' per-shard
    # (shard, req) keys back onto the fleet tree. ``link`` is the
    # merged id of the attempt span that caused the chain (absent in
    # an unmerged single-process trace).
    replica = request_chains(trace)
    rep_by_fleet: dict = {}
    for ev in trace["events"]:
        if ev["name"] not in ("serve:enqueue", "serve:reply"):
            continue
        a = ev["attrs"]
        fr = a.get("fleet_req")
        if fr is None:
            continue
        key = req_key(ev, a.get("req"))
        ch = replica["requests"].get(key)
        if ch is None:
            continue
        ent = rep_by_fleet.setdefault(fr, {}).setdefault(
            key, {"chain": ch, "link": None}
        )
        if a.get("fleet_parent") is not None:
            ent["link"] = a["fleet_parent"]

    requests: dict = {}
    delivered = complete = hedged = audited = failed = 0
    for rsp in sorted(req_spans, key=lambda s: s["t0"]):
        a = rsp["attrs"]
        fr = a.get("fleet_req")
        rows = []
        for att in sorted(attempts_by_req.get(fr, ()),
                          key=lambda s: (s["attrs"].get("ordinal", 0),
                                         s["t0"])):
            aa = att["attrs"]
            row = {
                "replica": aa.get("replica"), "kind": aa.get("kind"),
                "ordinal": aa.get("ordinal"), "outcome": aa.get("outcome"),
                "depth_frac": aa.get("depth_frac"), "burn": aa.get("burn"),
                "breaker": aa.get("breaker"),
                "bucket_fit": aa.get("bucket_fit"),
                "dur_s": att["dur_s"], "lat_s": aa.get("lat_s"),
                "span": att["id"],
                "connected": (att.get("parent") == rsp["id"]
                              or aa.get("fleet_parent") == rsp["id"]),
            }
            if row["lat_s"] is not None:
                row["lat_agree"] = (
                    abs(att["dur_s"] - row["lat_s"]) <= REQUEST_CHAIN_TOL_S
                )
            rows.append(row)
        outcome = a.get("outcome")
        serial = bool(a.get("serial"))
        winner = a.get("winner")
        ch = {
            "fleet_req": fr, "outcome": outcome, "winner": winner,
            "serial": serial, "tenant": a.get("tenant"),
            "dur_s": rsp["dur_s"], "span": rsp["id"], "attempts": rows,
            "hedged": any(r["kind"] == "hedge" for r in rows),
            "audited": any(r["kind"] in ("audit", "arbitrate")
                           for r in rows),
            "complete": False,
        }
        if outcome == "ok":
            delivered += 1
            winner_row = next(
                (r for r in rows
                 if r["outcome"] == "ok" and r["replica"] == winner
                 and r["kind"] in ("primary", "hedge")),
                None,
            )
            ok = (winner_row is not None and winner_row["connected"]
                  and winner_row.get("lat_agree", False))
            rep_ok = serial
            if ok and not serial:
                for ent in (rep_by_fleet.get(fr) or {}).values():
                    if (ent["link"] is not None
                            and ent["link"] != winner_row["span"]):
                        continue  # a hedge loser's or audit's chain
                    rc = ent["chain"]
                    if rc.get("complete") and rc.get("consistent"):
                        rep_ok = True
                        ch["replica_chain"] = {
                            "req": rc.get("req"),
                            "segments": rc.get("segments"),
                            "total_s": rc.get("total_s"),
                            "degraded": rc.get("degraded", False),
                        }
                        break
            ch["complete"] = bool(ok and rep_ok)
            if ch["complete"]:
                complete += 1
                # Per-segment attribution: router decision/failover
                # overhead vs wire+serialization vs the replica's own
                # queue/batch/execute partition.
                seg = {"router_s": round(
                    rsp["dur_s"] - winner_row["dur_s"], 9)}
                rc = ch.get("replica_chain")
                if rc and rc.get("total_s") is not None:
                    seg["wire_s"] = round(
                        (winner_row["lat_s"] or winner_row["dur_s"])
                        - rc["total_s"], 9,
                    )
                    for k, v in (rc.get("segments") or {}).items():
                        seg[k] = v
                ch["segments"] = seg
        else:
            failed += 1
        if ch["hedged"]:
            hedged += 1
        if ch["audited"]:
            audited += 1
        requests[fr] = ch
    coverage = (complete / delivered) if delivered else 1.0
    return {
        "requests": requests, "delivered": delivered,
        "complete": complete, "failed": failed, "hedged": hedged,
        "audited": audited, "coverage": round(coverage, 6),
    }


def _fleet_summary(trace: dict) -> dict | None:
    """The aggregate's ``fleet`` block (None when the trace has no
    fleet request spans): chain counts, coverage, and the mean
    router/wire/replica segment attribution."""
    chains = fleet_request_chains(trace)
    if not chains["requests"]:
        return None
    seg_tot: dict[str, float] = {}
    n = 0
    for ch in chains["requests"].values():
        if not ch.get("complete"):
            continue
        n += 1
        for k, v in (ch.get("segments") or {}).items():
            if isinstance(v, (int, float)):
                seg_tot[k] = seg_tot.get(k, 0.0) + v
    out = {
        "total": len(chains["requests"]),
        "delivered": chains["delivered"],
        "complete": chains["complete"],
        "failed": chains["failed"],
        "hedged": chains["hedged"],
        "audited": chains["audited"],
        "coverage": chains["coverage"],
    }
    if n:
        out["mean_segments_ms"] = {
            k: round(v / n * 1e3, 3) for k, v in sorted(seg_tot.items())
        }
    return out


def _request_summary(trace: dict) -> dict | None:
    """The aggregate's ``requests`` block (None for non-serving
    traces): chain counts plus mean segment decomposition."""
    chains = request_chains(trace)
    if not chains["requests"] and not chains["shed"]:
        return None
    seg_tot: dict[str, float] = {}
    n = 0
    for ch in chains["requests"].values():
        if not ch.get("complete"):
            continue
        n += 1
        for k, v in (ch.get("segments") or {}).items():
            seg_tot[k] = seg_tot.get(k, 0.0) + v
    out = {
        "total": len(chains["requests"]),
        "complete": chains["complete"],
        "incomplete": chains["incomplete"],
        "inconsistent": chains["inconsistent"],
        "shed": chains["shed"],
    }
    if n:
        out["mean_segments_ms"] = {
            k: round(v / n * 1e3, 3) for k, v in sorted(seg_tot.items())
        }
    return out


def _program_store_summary(events: list) -> dict | None:
    """Disk-warm vs live-compile attribution from the program-store
    trace events (None when the store emitted nothing)."""
    hits = [e for e in events if e["name"] == "program_store_hit"]
    compiles = [e for e in events if e["name"] == "program_store_compile"]
    if not hits and not compiles:
        return None
    return {
        "disk_hits": len(hits),
        "live_compiles": len(compiles),
        "compile_s": round(
            sum(e["attrs"].get("compile_s", 0.0) for e in compiles), 6
        ),
        "keys_compiled": sorted(
            {str(e["attrs"].get("key")) for e in compiles}
        ),
    }


def _model_words_per_pair(meta: dict) -> float | None:
    from distributed_sddmm_tpu_torch.tools import costmodel

    model = meta.get("cost_model")
    if not model:
        return None
    try:
        return costmodel.pair_words(
            model, meta["M_pad"], meta["N_pad"], meta["R"],
            meta["nnz"], meta["p"], meta["c"],
        )
    except (KeyError, ValueError):
        return None


def aggregate(trace: dict) -> dict:
    """Per-phase table + model comparison + events summary, JSON-ready."""
    from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics

    phases: dict[str, dict] = {}
    for sp in trace["spans"]:
        a = sp["attrs"]
        ph = phases.setdefault(sp["name"], {
            "calls": 0, "total_s": 0.0, "kernel_s": 0.0, "overhead_s": 0.0,
            "retries": 0, "comm_words": 0.0, "comm_bytes": 0.0,
            "flops": 0.0, "pairs": 0.0,
        })
        ph["calls"] += 1
        ph["total_s"] += sp["dur_s"]
        ph["kernel_s"] += a.get("kernel_s", sp["dur_s"])
        ph["overhead_s"] += a.get("overhead_s", 0.0)
        ph["retries"] += a.get("retries", 0)
        ph["comm_words"] += a.get("comm_words", 0.0)
        # Wire-aware volume; traces without the attr add 0.
        ph["comm_bytes"] += a.get("comm_bytes", 0.0)
        ph["flops"] += a.get("flops", 0.0)
        ph["pairs"] += a.get("pairs", 0.0) * (
            obs_metrics.OP_PAIRS.get(sp["name"], 0.0)
        )

    meta = _strategy_meta(trace["events"])
    model_pair = _model_words_per_pair(meta) if meta else None
    for name, ph in phases.items():
        # Model column only where the op maps onto whole fused pairs at
        # the strategy's fingerprinted R (GAT's per-layer R drift and
        # non-op spans get no prediction rather than a wrong one).
        if (
            model_pair is not None
            and name in ("fusedSpMM", "cgStep")
            and ph["pairs"] > 0
        ):
            ph["model_words"] = model_pair * ph["pairs"]
            ph["model_ratio"] = (
                ph["comm_words"] / ph["model_words"]
                if ph["model_words"] else None
            )


    ev_counts = collections.Counter(e["name"] for e in trace["events"])
    fault_kinds = collections.Counter(
        e["attrs"].get("kind", "?")
        for e in trace["events"] if e["name"] == "fault_fired"
    )
    summary = {
        "run_id": (trace["begin"] or {}).get("run_id"),
        "strategy": meta,
        "phases": {k: phases[k] for k in sorted(phases)},
        "events": dict(sorted(ev_counts.items())),
        "faults_by_kind": dict(sorted(fault_kinds.items())),
    }
    shards = (trace["begin"] or {}).get("shards")
    if shards:
        summary["shards"] = len(shards)
    requests = _request_summary(trace)
    if requests:
        summary["requests"] = requests
    fleet = _fleet_summary(trace)
    if fleet:
        summary["fleet"] = fleet
    programs = _program_store_summary(trace["events"])
    if programs:
        summary["program_store"] = programs
    return summary


def render(report: dict) -> str:
    """The human table: per-phase rows + events + model comparison."""
    lines = [f"trace run_id: {report.get('run_id')}"]
    meta = report.get("strategy")
    if meta:
        lines.append(
            f"strategy: {meta.get('algorithm')} "
            f"(model {meta.get('cost_model')}) "
            f"M={meta.get('M')} N={meta.get('N')} R={meta.get('R')} "
            f"nnz={meta.get('nnz')} p={meta.get('p')} c={meta.get('c')}"
        )
    header = (
        f"{'phase':<18} {'calls':>6} {'total_s':>9} {'kernel_s':>9} "
        f"{'ovh_s':>8} {'retry':>5} {'Mwords':>9} {'model':>9} {'GFLOP':>8}"
    )
    lines += [header, "-" * len(header)]
    for name, ph in report["phases"].items():
        model = ph.get("model_words")
        lines.append(
            f"{name:<18} {ph['calls']:>6} {ph['total_s']:>9.4f} "
            f"{ph['kernel_s']:>9.4f} {ph['overhead_s']:>8.4f} "
            f"{ph['retries']:>5} {ph['comm_words'] / 1e6:>9.3f} "
            f"{(model / 1e6 if model is not None else float('nan')):>9.3f} "
            f"{ph['flops'] / 1e9:>8.3f}"
        )
    if report["events"]:
        lines.append("events: " + ", ".join(
            f"{k}={v}" for k, v in report["events"].items()
        ))
    if report["faults_by_kind"]:
        lines.append("faults by kind: " + ", ".join(
            f"{k}={v}" for k, v in report["faults_by_kind"].items()
        ))
    req = report.get("requests")
    if req:
        seg = req.get("mean_segments_ms") or {}
        lines.append(
            f"requests: {req['complete']}/{req['total']} complete chains"
            f" ({req['inconsistent']} inconsistent, "
            f"{req['incomplete']} incomplete, {req['shed']} shed)"
            + ("; mean " + " ".join(
                f"{k[:-2]}={v}ms" for k, v in seg.items()) if seg else "")
        )
    fl = report.get("fleet")
    if fl:
        seg = fl.get("mean_segments_ms") or {}
        lines.append(
            f"fleet: {fl['complete']}/{fl['delivered']} delivered chains"
            f" complete (coverage {fl['coverage']:.3f}; "
            f"{fl['hedged']} hedged, {fl['audited']} audited, "
            f"{fl['failed']} failed)"
            + ("; mean " + " ".join(
                f"{k[:-2]}={v}ms" for k, v in seg.items()) if seg else "")
        )
    ps = report.get("program_store")
    if ps:
        lines.append(
            f"program store: {ps['disk_hits']} disk hit(s), "
            f"{ps['live_compiles']} live compile(s) "
            f"({ps['compile_s']:.3f}s compiling)"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="path to a <run_id>.jsonl trace")
    ap.add_argument("--json", action="store_true",
                    help="emit the aggregate as JSON instead of a table")
    ap.add_argument("--no-strict", action="store_true",
                    help="tolerate (and report) malformed lines")
    args = ap.parse_args(argv)

    try:
        trace = load_trace(args.trace, strict=not args.no_strict)
    except OSError as e:
        print(f"cannot read trace: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        # Validation is a CONTRACT: a trace that fails the schema must
        # fail the invoking pipeline, not scroll past as prose. Exit 2
        # distinguishes "invalid trace" from argparse's usage exit.
        print(f"invalid trace: {e}", file=sys.stderr)
        return 2
    report = aggregate(trace)
    manifest = load_manifest(args.trace)
    if manifest:
        report["manifest"] = {
            k: manifest.get(k)
            for k in ("torch_version", "cuda_version", "backend", "device_name",
                      "device_capability", "device_count", "power_limit", "git_rev")
        }
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(render(report))
        if trace["errors"]:
            print(f"({len(trace['errors'])} malformed line(s) skipped)",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
