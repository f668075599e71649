"""Comparison across runs: per-phase deltas, verdicts and the gate
(counterpart of ``obs/regress.py``).

Reads run documents of :mod:`.store` and answers, mechanically, whether a
change made a phase slower and whether the time went to compute, comm or
overhead.

* **Per phase, not per run.** A headline rate can hide a 2x ``cgStep``
  regression behind a faster warmup. The unit of comparison is the phase
  table: the record's per-op ``metrics`` (every run has them), enriched by
  the trace aggregate's model column when the run was traced.
* **Noise-aware verdicts.** The metric is seconds a call. Against a rolling
  baseline of the last K matching runs the band is ``median * (1 +-
  threshold)``, widened by a robust spread (1.4826 MAD, about one sigma),
  so a machine with jittery timings widens its own bands.
* **Roofline context.** Each row carries GFLOP/s (counted FLOPs over kernel
  seconds) and counted against modelled comm words
  (``tools/costmodel.pair_words`` through the trace aggregate), so a
  regression is attributed to overhead (retries, faults), comm or compute.
* **A gate for CI.** :func:`gate` returns 0 (pass), 2 (regression) or 3
  (too few baseline runs) and a JSON-ready report.

The serving, fleet, dynamic-structure and tuner axes are pure functions of
a record; the port's records grow those fields with the layers that make
them. The JAX module's analytic-against-XLA FLOP axes (``xla:<op>_flops``)
are left out: the port compiles no XLA program and its records carry no
``xla_cost``.

The caller hands in documents with the same store key (problem
fingerprint, code hash, backend); :func:`compare` only notes when keys
differ, since a diff across keys answers "what did this change cost".
"""

from __future__ import annotations

import statistics

#: Gate exit codes (stable contract for CI).
GATE_PASS = 0
GATE_REGRESSION = 2
GATE_NO_DATA = 3

#: Phases that exist for bookkeeping, not performance (the bench span
#: wraps the whole run; comparing it double-counts its children).
_SKIP_PHASES = ("bench",)

#: Zero-tolerance axes: any nonzero ``t_call`` regresses, no noise
#: band, no baseline required. ``fleet:audit_mismatch`` counts
#: byzantine replies; ``fleet:trace_coverage`` carries the UNCOVERED
#: fraction of delivered requests whose trace chain failed to
#: reconstruct (1 - coverage).
_HARD_AXES = ("fleet:audit_mismatch", "fleet:trace_coverage")


def _optional_axis(name: str) -> bool:
    """Axes that only exist when optional telemetry ran (SLO burn rate
    needs an SLO spec; comm bytes need a counting strategy; time-to-adapt
    needs the background tuner to have promoted). Their absence in the
    judged run is "not measured", never a gate failure. The
    ``serve:burn_rate`` prefix covers the per-tenant sub-axes
    (``serve:burn_rate:<tenant>``) — a run without that tenant declared
    simply did not measure it; ``fleet:`` axes exist only for ``bench
    fleet`` records."""
    return (
        name.startswith("tuner:")
        or name.startswith("comm:")
        or name.startswith("fleet:")
        or name.startswith("serve:burn_rate")
        or name.startswith("dynstruct:")
    )


def phase_stats(doc: dict) -> dict[str, dict]:
    """Normalize one run document to ``{phase: row}``.

    The row NAMESPACE is the bench record's per-op ``metrics`` — every
    run (traced or not, first-of-sweep or not) carries it, so two docs
    always compare over the same phase set; a verdict of "missing" then
    means work actually vanished, never that one doc happened to have a
    trace aggregate attached and the other did not. The trace aggregate
    (``doc["phases"]``), when present, only ENRICHES matching ops with
    the cost-model column (app-level spans like ``als:step`` stay out
    of the comparison). Docs with no record metrics at all (synthetic /
    trace-only) fall back to the trace aggregate wholesale. Row shape::

        {calls, total_s, kernel_s, overhead_s, retries,
         comm_words, flops, t_call, gflops, model_words?, model_ratio?}
    """
    trace_phases = doc.get("phases") or {}
    metrics = (doc.get("record") or {}).get("metrics") or {}
    if metrics:
        phases = {}
        for op, m in metrics.items():
            row = {
                "calls": m.get("calls", 0),
                "total_s": m.get("kernel_s", 0.0) + m.get("overhead_s", 0.0),
                "kernel_s": m.get("kernel_s", 0.0),
                "overhead_s": m.get("overhead_s", 0.0),
                "retries": m.get("retries", 0),
                "comm_words": m.get("comm_words", 0.0),
                "comm_bytes": m.get("comm_bytes"),
                "flops": m.get("flops", 0.0),
            }
            tp = trace_phases.get(op)
            if tp and tp.get("model_words") is not None:
                row["model_words"] = tp["model_words"]
            phases[op] = row
    else:
        phases = trace_phases
    out = {}
    for name, ph in phases.items():
        if name in _SKIP_PHASES:
            continue
        calls = ph.get("calls", 0)
        if not calls:
            continue
        kernel_s = ph.get("kernel_s", 0.0)
        row = {
            "calls": int(calls),
            "total_s": ph.get("total_s", kernel_s + ph.get("overhead_s", 0.0)),
            "kernel_s": kernel_s,
            "overhead_s": ph.get("overhead_s", 0.0),
            "retries": int(ph.get("retries", 0)),
            "comm_words": ph.get("comm_words", 0.0),
            "comm_bytes": ph.get("comm_bytes"),
            "flops": ph.get("flops", 0.0),
        }
        row["t_call"] = row["total_s"] / calls
        row["gflops"] = (
            row["flops"] / kernel_s / 1e9 if kernel_s > 0 else None
        )
        if ph.get("model_words") is not None:
            row["model_words"] = ph["model_words"]
            row["model_ratio"] = (
                ph.get("model_ratio")
                if ph.get("model_ratio") is not None
                else (row["comm_words"] / ph["model_words"]
                      if ph["model_words"] else None)
            )
        out[name] = row
    out.update(_serving_rows(doc))
    out.update(_tuner_rows(doc))
    out.update(_comm_bytes_rows(doc))
    out.update(_fleet_rows(doc))
    out.update(_dynstruct_rows(doc))
    return out


def _pseudo_row(calls: int, value: float) -> dict:
    """A phase row carrying one scalar-per-request quantity in its
    ``t_call`` slot (seconds for latency axes, a plain rate for
    shed_rate) — the band/verdict machinery then applies unchanged."""
    return {
        "calls": int(calls), "total_s": value * calls,
        "kernel_s": value * calls, "overhead_s": 0.0, "retries": 0,
        "comm_words": 0.0, "comm_bytes": None, "flops": 0.0,
        "t_call": value, "gflops": None,
    }


def _serving_rows(doc: dict) -> dict[str, dict]:
    """The serving verdict axes (``bench serve`` records): tail latency
    percentiles as pseudo-phases (``t_call`` = the percentile in
    seconds), the shed rate, and the SLO error-budget
    burn rate. Offline records have none of these fields and contribute
    no rows, so serving and kernel docs never produce spurious
    "missing" verdicts against each other only when the config axes
    differ — which the store's ``app=serve-*`` axis already
    guarantees."""
    rec = doc.get("record") or {}
    lat = rec.get("latency_ms") or {}
    requests = rec.get("requests") or 0
    if not requests:
        return {}
    rows = {}
    for pct in (50, 99):
        v = lat.get(f"p{pct}")
        if v is not None:
            rows[f"serve:latency_p{pct}"] = _pseudo_row(requests, v / 1e3)
    if rec.get("shed_rate") is not None and lat:
        rows["serve:shed_rate"] = _pseudo_row(
            requests, float(rec["shed_rate"])
        )
    if rec.get("burn_rate") is not None:
        # Burn rate regresses like a latency: higher = burning budget
        # faster. Docs without the field simply lack the axis
        # (an OPTIONAL axis — see compare()'s not-measured verdict).
        rows["serve:burn_rate"] = _pseudo_row(
            requests, float(rec["burn_rate"])
        )
    for tname, cell in sorted((rec.get("tenant") or {}).items()):
        # Multi-tenant QoS: each tenant with its own SLO gets
        # its own burn-rate axis, so one tenant's budget burning inside
        # a healthy aggregate still regresses. OPTIONAL like the
        # fleet-wide axis (startswith in _optional_axis).
        if cell.get("burn_rate") is not None:
            rows[f"serve:burn_rate:{tname}"] = _pseudo_row(
                max(int(cell.get("requests") or 0), 1),
                float(cell["burn_rate"]),
            )
    return rows


def _fleet_rows(doc: dict) -> dict[str, dict]:
    """The fleet verdict axis (``bench fleet`` records):
    ``fleet:availability`` as a pseudo-phase whose ``t_call`` is the
    UNAVAILABLE fraction ``max(1 - availability, 0.01)`` — the gate's
    higher-is-worse convention, floored so a perfect baseline does not
    make every subsequent run read as an infinite regression. OPTIONAL
    in compare(): only fleet records carry the field."""
    fleet = (doc.get("record") or {}).get("fleet") or {}
    avail = fleet.get("availability")
    if avail is None:
        return {}
    offered = max(int(fleet.get("offered") or 0), 1)
    rows = {
        "fleet:availability": _pseudo_row(
            offered, max(1.0 - float(avail), 0.01)
        ),
    }
    if fleet.get("audit_mismatches") is not None:
        # HARD axis (compare() special-cases it ahead of the band
        # machinery): replies are bit-identical by construction, so a
        # single cross-replica mismatch is a byzantine event — any
        # nonzero count regresses, no threshold, no baseline band.
        rows["fleet:audit_mismatch"] = _pseudo_row(
            offered, float(fleet["audit_mismatches"])
        )
    trace = fleet.get("trace") or {}
    if trace.get("coverage") is not None:
        # HARD axis: every DELIVERED reply must reconstruct a
        # complete causal chain in the merged fleet trace (router
        # request span → winning attempt, duration agreeing with the
        # router's own recorded latency within 1 ms → replica
        # enqueue/batch/reply). ``t_call`` is the UNCOVERED fraction
        # ``1 - coverage`` so any nonzero value regresses — a dropped
        # span is lost observability, no threshold, no baseline band.
        rows["fleet:trace_coverage"] = _pseudo_row(
            max(int(trace.get("delivered") or 0), 1),
            max(1.0 - float(trace["coverage"]), 0.0),
        )
    hedges = int(fleet.get("hedges") or 0)
    if hedges > 0:
        # A RISING hedge-win rate means primaries increasingly miss the
        # p95-derived hedge deadline — tail degradation the latency
        # percentiles can hide when the hedge keeps rescuing it. Higher
        # = worse matches the gate convention directly.
        rows["fleet:hedge_win_rate"] = _pseudo_row(
            hedges,
            max(float(fleet.get("hedge_wins") or 0) / hedges, 0.01),
        )
    return rows


def _dynstruct_rows(doc: dict) -> dict[str, dict]:
    """The dynamic-structure verdict axis:
    ``dynstruct:rebind`` as a pseudo-phase whose ``t_call`` is the
    retrace rate per structure change — ``retraces / changes``, floored
    at 0.01 so an all-fit baseline (the whole point of dynstruct) does
    not turn the first legitimate spill into an infinite regression.
    OPTIONAL in compare(): only records that actually churned structure
    (``record["dynstruct"]`` with nonzero changes) carry the axis;
    older and static docs are "not measured", never a verdict."""
    dyn = (doc.get("record") or {}).get("dynstruct") or {}
    changes = int(dyn.get("dynstruct_rebinds") or 0) + int(
        dyn.get("dynstruct_bucket_spills") or 0
    )
    if not changes:
        return {}
    retraces = float(dyn.get("structure_retraces") or 0)
    return {
        "dynstruct:rebind": _pseudo_row(
            changes, max(retraces / changes, 0.01)
        ),
    }


def _comm_bytes_rows(doc: dict) -> dict[str, dict]:
    """Wire-volume axes: one pseudo-phase per op that counted
    ``comm_bytes``, ``t_call`` = bytes per call. The gate judges the
    realized wire volume's stability — a bf16-wire run's ~2x drop
    reads as an improvement, a policy that silently stopped realizing
    its discount as a regression. OPTIONAL in compare(): docs
    without the field read as "not-measured", never as a
    failure."""
    metrics = (doc.get("record") or {}).get("metrics") or {}
    rows = {}
    for op, m in metrics.items():
        calls, nbytes = m.get("calls") or 0, m.get("comm_bytes")
        if calls and nbytes:
            rows[f"comm:{op}_bytes"] = _pseudo_row(calls, nbytes / calls)
    return rows


def _tuner_rows(doc: dict) -> dict[str, dict]:
    """The closed-loop tuner's verdict axis: ``tuner:time_to_adapt``,
    the seconds from trigger detection to challenger promotion
    (``bench serve --tuner`` records carry ``time_to_adapt_s``). An
    adaptation that got slower run over run means the loop itself
    regressed — detection lag, measurement budget, or shadow
    throughput. OPTIONAL in compare(): records without a promotion
    (tuner off, or nothing to adapt to) lack the axis entirely."""
    rec = doc.get("record") or {}
    v = rec.get("time_to_adapt_s")
    if v is None:
        return {}
    promos = len(((rec.get("tuner") or {}).get("promotions")) or []) or 1
    return {"tuner:time_to_adapt": _pseudo_row(promos, float(v))}


def _band(t_calls: list[float], threshold: float) -> tuple[float, float, float]:
    """(median, lo, hi) noise band for a phase's baseline seconds/call.

    The relative threshold sets the floor; with >= 3 baseline runs a
    robust spread estimate (1.4826·MAD) widens it — a noisy machine's
    own history is the best available noise model."""
    med = statistics.median(t_calls)
    slack = threshold * med
    if len(t_calls) >= 3:
        mad = statistics.median(abs(t - med) for t in t_calls)
        slack = max(slack, 3.0 * 1.4826 * mad)
    return med, med - slack, med + slack


def _attribute(base: dict, new: dict) -> str:
    """First-order blame for a slower phase: overhead (retry/fault wall),
    comm (counted volume or model agreement moved), or compute (the
    kernel itself). Same altitude as the cost model — a hint for where
    to look, not a proof."""
    d_total = new["t_call"] - base["t_call"]
    d_overhead = (
        new["overhead_s"] / new["calls"] - base["overhead_s"] / base["calls"]
    )
    if d_total > 0 and d_overhead >= 0.5 * d_total:
        return "overhead"
    base_w = base["comm_words"] / base["calls"] if base["calls"] else 0.0
    new_w = new["comm_words"] / new["calls"] if new["calls"] else 0.0
    if base_w > 0 and abs(new_w - base_w) > 0.1 * base_w:
        return "comm"
    r_a, r_b = base.get("model_ratio"), new.get("model_ratio")
    if r_a is not None and r_b is not None and abs(r_b - r_a) > 0.1:
        return "comm"
    return "compute"


def compare(
    doc_b: dict,
    doc_a: dict | None = None,
    baseline_docs: list[dict] | None = None,
    threshold: float = 0.15,
) -> dict:
    """Per-phase comparison of run ``doc_b`` against run ``doc_a`` and/or
    a rolling baseline.

    ``baseline_docs`` (defaulting to ``[doc_a]``) supplies the
    seconds-per-call population the noise band is computed from;
    ``doc_a`` (defaulting to the newest baseline doc) supplies the
    reference row shown in the delta columns. Returns a JSON-able report
    with per-phase verdicts in {regression, improvement, ok, missing,
    new} and an overall verdict.
    """
    if baseline_docs is None:
        baseline_docs = [doc_a] if doc_a is not None else []
    if doc_a is None:
        if not baseline_docs:
            raise ValueError("compare needs doc_a and/or baseline_docs")
        doc_a = baseline_docs[-1]

    stats_a = phase_stats(doc_a)
    stats_b = phase_stats(doc_b)
    baseline_stats = [phase_stats(d) for d in baseline_docs] or [stats_a]

    phases: dict[str, dict] = {}
    regressions, improvements, missing, new_phases = [], [], [], []
    for name in sorted(set(stats_a) | set(stats_b)):
        a, b = stats_a.get(name), stats_b.get(name)
        if name in _HARD_AXES and b is not None:
            # Zero-tolerance hard axes: the band machinery would let a
            # "stable" nonzero value pass — but one byzantine reply (or
            # one delivered request whose trace chain failed to
            # reconstruct) is one too many, baseline or no baseline.
            bad = b["t_call"] > 0
            if bad:
                verdict = "regression"
                regressions.append(name)
            elif a is None:
                verdict = "new"
                new_phases.append(name)
            else:
                verdict = "ok"
            row = {"a": a, "b": b, "verdict": verdict, "hard_axis": True}
            if bad:
                row["attribution"] = "fleet"
            phases[name] = row
            continue
        if b is None:
            if _optional_axis(name):
                # Optional instrumentation axes (burn rate, comm bytes)
                # appear only when their telemetry ran; absent is
                # "not measured", not "work vanished": older docs
                # and store-disabled runs must not gate-fail on them.
                phases[name] = {"a": a, "b": None,
                                "verdict": "not-measured"}
                continue
            missing.append(name)
            phases[name] = {"a": a, "b": None, "verdict": "missing"}
            continue
        if a is None:
            new_phases.append(name)
            phases[name] = {"a": None, "b": b, "verdict": "new"}
            continue
        t_calls = [s[name]["t_call"] for s in baseline_stats if name in s]
        med, lo, hi = _band(t_calls or [a["t_call"]], threshold)
        if b["t_call"] > hi:
            verdict = "regression"
            regressions.append(name)
        elif b["t_call"] < lo:
            verdict = "improvement"
            improvements.append(name)
        else:
            verdict = "ok"
        row = {
            "a": a,
            "b": b,
            "baseline_median_t_call": med,
            "band": [lo, hi],
            "baseline_n": len(t_calls),
            "delta_pct": (
                (b["t_call"] - med) / med * 100.0 if med > 0 else None
            ),
            "verdict": verdict,
        }
        if verdict == "regression":
            if name.startswith("serve:"):
                # Serving axes carry no comm/overhead split to blame;
                # the axis itself names what went bad.
                row["attribution"] = "serving"
            elif name.startswith("fleet:"):
                # Availability moved: a replica-lifecycle or routing
                # problem, not a kernel one.
                row["attribution"] = "fleet"
            elif name.startswith("tuner:"):
                # The adaptation loop itself slowed down (detection →
                # promotion wall); no comm/compute split exists.
                row["attribution"] = "tuner"
            else:
                base_row = dict(a)
                base_row["t_call"] = med
                row["attribution"] = _attribute(base_row, b)
        phases[name] = row

    overall = "ok"
    if regressions or missing:
        overall = "regression"
    elif improvements:
        overall = "improvement"
    return {
        "run_a": doc_a.get("run_id"),
        "run_b": doc_b.get("run_id"),
        "key_a": doc_a.get("key"),
        "key_b": doc_b.get("key"),
        "comparable": doc_a.get("key") == doc_b.get("key"),
        "baseline_n": len(baseline_docs),
        "threshold": threshold,
        "phases": phases,
        "regressions": regressions,
        "improvements": improvements,
        "missing": missing,
        "new": new_phases,
        "verdict": overall,
    }


def gate(
    store,
    doc: dict,
    k: int = 5,
    threshold: float = 0.15,
    min_runs: int = 1,
    baseline_doc: dict | None = None,
) -> tuple[int, dict]:
    """CI gate: compare ``doc`` against an explicit baseline run or the
    rolling baseline of the last ``k`` store runs matching its index key
    (same problem fingerprint, code hash, backend).

    Returns ``(exit_code, report)``: 0 pass (improvements pass too),
    2 on any phase regression or vanished phase, 3 when fewer than
    ``min_runs`` comparable baseline runs exist (CI treats that as
    "cannot judge", distinct from "judged bad").
    """
    if baseline_doc is not None:
        baseline = [baseline_doc]
    else:
        baseline = store.matching(doc, limit=k)
    if len(baseline) < max(min_runs, 1):
        return GATE_NO_DATA, {
            "verdict": "no_data",
            "run_b": doc.get("run_id"),
            "key_b": doc.get("key"),
            "baseline_n": len(baseline),
            "min_runs": min_runs,
            "exit_code": GATE_NO_DATA,
        }
    report = compare(doc, baseline_docs=baseline, threshold=threshold)
    code = GATE_REGRESSION if report["verdict"] == "regression" else GATE_PASS
    report["exit_code"] = code
    return code, report


# --------------------------------------------------------------------- #
# Rendering (the human half of `bench compare` / `bench gate`)
# --------------------------------------------------------------------- #


def _num(v, spec: str, width: int) -> str:
    """Right-aligned number or a '-' placeholder; ``spec`` is a full
    format spec (sign/precision/type), padded to ``width``."""
    if v is None:
        return " " * (width - 1) + "-"
    return f"{format(v, spec):>{width}}"


def render_compare(report: dict) -> str:
    """Fixed-width per-phase delta table with comm/FLOP attribution."""
    lines = [
        f"compare {report.get('run_a')} -> {report.get('run_b')} "
        f"(baseline n={report.get('baseline_n')}, "
        f"threshold ±{report.get('threshold', 0) * 100:.0f}%)",
    ]
    if not report.get("comparable", True):
        lines.append(
            "NOTE: runs have different fingerprint keys (problem, code or "
            "backend changed) — deltas mix causes"
        )
    header = (
        f"{'phase':<16} {'calls':>5} {'t/call A':>10} {'t/call B':>10} "
        f"{'Δ%':>7} {'GF/s A':>8} {'GF/s B':>8} {'Mw/call':>9} "
        f"{'words/model':>11} {'verdict':>11} {'blame':>9}"
    )
    lines += [header, "-" * len(header)]
    for name, row in report["phases"].items():
        a, b = row.get("a"), row.get("b")
        if row["verdict"] in ("missing", "new", "not-measured"):
            src = a if b is None else b
            dash = " ".join(
                "-".rjust(w) for w in (10, 10, 7, 8, 8, 9, 11)
            )
            lines.append(
                f"{name:<16} {src['calls']:>5} {dash} "
                f"{row['verdict']:>11}"
            )
            continue
        # A hard axis judged without a baseline row has no A side.
        med = row.get("baseline_median_t_call")
        mwords = b["comm_words"] / b["calls"] / 1e6 if b["calls"] else 0.0
        lines.append(
            f"{name:<16} {b['calls']:>5} "
            f"{_num(med, '.6f', 10)} {_num(b['t_call'], '.6f', 10)} "
            f"{_num(row.get('delta_pct'), '+.1f', 7)} "
            f"{_num((a or {}).get('gflops'), '.3f', 8)} "
            f"{_num(b.get('gflops'), '.3f', 8)} "
            f"{mwords:>9.3f} "
            f"{_num(b.get('model_ratio'), '.3f', 11)} "
            f"{row['verdict']:>11} {row.get('attribution', ''):>9}"
        )
    lines.append(f"verdict: {report['verdict']}")
    if report.get("regressions"):
        lines.append("regressions: " + ", ".join(report["regressions"]))
    if report.get("missing"):
        lines.append("missing phases: " + ", ".join(report["missing"]))
    if report.get("improvements"):
        lines.append("improvements: " + ", ".join(report["improvements"]))
    return "\n".join(lines)


def render_history(rows: list[dict]) -> str:
    """``bench history`` table: one line per stored run, oldest first."""
    header = (
        f"{'run_id':<28} {'source':<9} {'alg':<20} {'app':<7} {'R':>5} "
        f"{'backend':<8} {'elapsed':>9} {'GFLOP/s':>9} {'anom':>4}  key"
    )
    lines = [header, "-" * len(header)]
    for r in rows:
        lines.append(
            f"{str(r.get('run_id'))[:28]:<28} {str(r.get('source', ''))[:9]:<9} "
            f"{str(r.get('algorithm', '') or '-')[:20]:<20} "
            f"{str(r.get('app', '') or '-')[:7]:<7} "
            f"{str(r.get('R', '') or '-'):>5} "
            f"{str(r.get('backend', '') or '-')[:8]:<8} "
            f"{_num(r.get('elapsed'), '.3f', 9)} "
            f"{_num(r.get('overall_throughput'), '.3f', 9)} "
            f"{r.get('anomaly_count', 0):>4}  {str(r.get('key') or '-')[:16]}"
        )
    return "\n".join(lines)
