"""Live serving telemetry: mergeable histograms, the sampler thread and
``bench top`` (counterpart of ``obs/telemetry.py``).

* :class:`LatencyHistogram` -- fixed-bucket latency counts. The bounds
  are fixed, so two histograms from two processes, or from two windows
  of one run, merge by adding counts: associative and commutative, which
  sample-list percentiles are not without every sample. Percentiles come
  back as bucket upper bounds (nearest rank over the cumulative counts),
  so a merged p99 is conservative by at most one bucket. ``serve/slo.py``
  records every reply's total latency here and reads the SLO burn rate
  off it.
* :func:`engine_snapshot` -- one JSON-ready view of a serving engine:
  queue depth and fill, the recorder's counters and histogram, the
  engine's cell counters, the SLO burn rate, the bucket ladders, the
  tenant classes and the tuner's state. It reads host-side state only
  (Python counters under their locks, never a CUDA tensor), so the
  sampler and the admin server never synchronise the runner's stream.
* :class:`TelemetrySampler` -- a daemon thread appending a snapshot every
  ``interval_s`` as one JSON line to
  ``artifacts/telemetry_torch/<run_id>.jsonl`` (``SDDMM_TORCH_TELEMETRY``
  or ``bench serve --telemetry`` relocate or enable it); a crashed
  process leaves every completed line readable.
* :func:`read_snapshots`, :func:`newest_stream`, :func:`render_top` --
  the reader half behind ``bench top``, over a stream file or a live
  ``/snapshot``.

**Burn rate**: for a latency target ``pXX_ms=L`` the budget is the
``(100-XX)%`` of requests allowed over ``L``; ``burn_rate =
observed_bad_fraction / budget_fraction`` (1.0 burns exactly at budget),
the worst axis winning.

The snapshot's fields, the histogram's bounds and the screen are the JAX
package's, so ``bench top`` of either package reads either's stream.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading

from distributed_sddmm_tpu_torch.obs import clock

_REPO = pathlib.Path(__file__).resolve().parents[2]
#: Apart from the JAX package's ``artifacts/telemetry/``.
DEFAULT_TELEMETRY_DIR = _REPO / "artifacts" / "telemetry_torch"
TELEMETRY_ENV = "SDDMM_TORCH_TELEMETRY"

#: Bucket upper bounds in milliseconds (a 1-2-5 ladder, 0.25 ms to 30 s)
#: plus an overflow bucket. Fixed, so any two histograms merge; changing
#: them is a schema change, and the JAX package's are the same.
BUCKET_BOUNDS_MS: tuple[float, ...] = (
    0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class LatencyHistogram:
    """Fixed-bucket counts; :meth:`merge` is associative and commutative."""

    __slots__ = ("bounds_ms", "counts")

    def __init__(self, bounds_ms: tuple[float, ...] = BUCKET_BOUNDS_MS,
                 counts: list[int] | None = None):
        self.bounds_ms = tuple(float(b) for b in bounds_ms)
        n = len(self.bounds_ms) + 1  # the overflow bucket
        if counts is None:
            counts = [0] * n
        if len(counts) != n:
            raise ValueError(f"histogram needs {n} counts for {n - 1} bounds, "
                             f"got {len(counts)}")
        self.counts = [int(c) for c in counts]

    def add(self, latency_ms: float) -> None:
        for i, bound in enumerate(self.bounds_ms):
            if latency_ms <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def total(self) -> int:
        return sum(self.counts)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """A new histogram holding both operands' counts; raises on other
        bounds, whose merge would mean nothing."""
        if self.bounds_ms != other.bounds_ms:
            raise ValueError("cannot merge histograms with different bounds")
        return LatencyHistogram(self.bounds_ms,
                                [a + b for a, b in zip(self.counts, other.counts)])

    def __eq__(self, other) -> bool:
        return (isinstance(other, LatencyHistogram)
                and self.bounds_ms == other.bounds_ms and self.counts == other.counts)

    def quantile_ms(self, pct: float) -> float | None:
        """Nearest-rank percentile as a bucket upper bound (None when
        empty); a hit in the overflow bucket reads the last finite bound."""
        total = self.total
        if total == 0:
            return None
        rank = max(1, int(pct / 100.0 * total + 0.999999))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds_ms[min(i, len(self.bounds_ms) - 1)]
        return self.bounds_ms[-1]

    def fraction_above(self, threshold_ms: float) -> float:
        """The fraction in buckets lying wholly above ``threshold_ms`` (a
        lower bound: the bucket straddling the threshold is not charged)."""
        total = self.total
        if total == 0:
            return 0.0
        above = self.counts[-1] if self.bounds_ms[-1] >= threshold_ms else 0
        for i, bound in enumerate(self.bounds_ms):
            lower = self.bounds_ms[i - 1] if i else 0.0
            if lower >= threshold_ms:
                above += self.counts[i]
        return above / total

    def percentiles_ms(self, pcts=(50, 95, 99)) -> dict:
        out = {}
        for pct in pcts:
            v = self.quantile_ms(pct)
            if v is not None:
                out[f"p{pct}"] = v
        return out

    def to_dict(self) -> dict:
        return {"bounds_ms": list(self.bounds_ms), "counts": list(self.counts)}

    @classmethod
    def from_dict(cls, d: dict | None) -> "LatencyHistogram | None":
        if not isinstance(d, dict):
            return None
        try:
            return cls(tuple(d["bounds_ms"]), list(d["counts"]))
        except (KeyError, TypeError, ValueError):
            return None


# ------------------------------------------------------------ the sampler


def parse_env_spec(spec: str | None) -> tuple[bool, pathlib.Path | None]:
    """``SDDMM_TORCH_TELEMETRY``, in the run store's grammar: 0/off/false/no
    (or empty) disables, 1/on/true/yes selects the default directory, any
    other value is a directory."""
    spec = spec or ""
    low = spec.lower()
    if low in ("", "0", "off", "false", "no"):
        return False, None
    if low in ("1", "on", "true", "yes"):
        return True, None
    return True, pathlib.Path(spec)


def engine_snapshot(engine, slo=None, run_id: str | None = None) -> dict:
    """One snapshot of a serving engine, JSON-ready: the sampler's lines,
    the admin server's ``/snapshot`` and what :func:`render_top` draws.

    ``engine`` needs ``.queue`` (``depth()``, ``max_depth``,
    ``submitted_count``), ``.stats()`` and ``.recorder`` (a
    ``serve.slo.LatencyRecorder``); ``slo`` adds the burn rate. Every read
    is of host state: the sampler's and the server's threads must not
    stall the runner's CUDA stream."""
    q = engine.queue
    summary = engine.recorder.summary()
    depth = q.depth()
    snap = {
        "schema": 1,
        "run_id": run_id,
        "t_epoch": clock.epoch(),
        "queue_depth": depth,
        "queue_capacity": q.max_depth,
        "depth_frac": round(depth / q.max_depth, 4) if q.max_depth else 0.0,
        "submitted": q.submitted_count,
        "requests": summary.get("requests", 0),
        "completed": summary.get("completed", 0),
        "errors": summary.get("errors", 0),
        "shed": summary.get("shed_count", 0),
        "degraded": summary.get("degraded_count", 0),
        "latency_hist": summary.get("request_hist"),
        "latency_hist_ms": summary.get("latency_hist_ms"),
        "batch_occupancy": (summary.get("batch_occupancy") or {}).get("mean"),
    }
    # The exposition's histogram _sum, from the same summary as the buckets:
    # a second summary() could count replies in between.
    lat = summary.get("latency_ms") or {}
    if lat.get("mean") is not None:
        snap["latency_sum_ms"] = lat["mean"] * summary.get("completed", 0)
    try:
        stats = engine.stats()
    except Exception:  # noqa: BLE001 -- telemetry never fails serving
        stats = {}
    # ``disk_hits`` is the JAX schema's field: a serve cell is a bound
    # kernel call with no stored artifact, so none is loaded from disk.
    store = {**stats, "disk_hits": 0} if stats else {}
    snap["program_store"] = {k: store.get(k)
                             for k in ("cache_hits", "cache_misses", "disk_hits", "live_compiles")
                             if store.get(k) is not None}
    if slo is not None:
        snap["burn_rate"] = slo.burn_rate(summary)
    try:  # a replica's warm ladders: what a router admits by
        snap["buckets"] = {"batch": list(engine.batch_buckets),
                           "inner": list(engine.workload.inner_buckets)}
    except Exception:  # noqa: BLE001
        pass
    q_tenants = getattr(q, "tenants", None) or {}
    if set(q_tenants) - {"default"} and hasattr(q, "tenant_depths"):
        view: dict[str, dict] = {}
        depths = q.tenant_depths()
        shed = dict(getattr(q, "tenant_shed", {}))
        sub = dict(getattr(q, "tenant_submitted", {}))
        rec_tenants = summary.get("tenant") or {}
        for name, spec in q_tenants.items():
            cell = {"depth": depths.get(name, 0), "submitted": sub.get(name, 0),
                    "queue_shed": shed.get(name, 0), "weight": spec.weight}
            cell.update(rec_tenants.get(name, {}))
            t_slo = getattr(spec, "slo", None)
            if t_slo is not None and name in rec_tenants:
                cell["burn_rate"] = t_slo.burn_rate(rec_tenants[name])
            view[name] = cell
        snap["tenant"] = view
    tuner = getattr(engine, "tuner", None)
    if tuner is not None:
        try:
            snap["tuner"] = tuner.snapshot()
        except Exception:  # noqa: BLE001
            pass
    return snap


class TelemetrySampler:
    """Periodic :func:`engine_snapshot` lines appended to one JSONL file.
    The thread is a daemon and each snapshot one whole line, so a dying
    process loses at most the line in flight."""

    def __init__(self, engine, interval_s: float = 0.5, out_dir=None, slo=None,
                 run_id: str | None = None):
        from distributed_sddmm_tpu_torch.obs import trace as obs_trace

        self.engine = engine
        self.interval_s = float(interval_s)
        self.slo = slo
        self.run_id = run_id or obs_trace.run_id() or obs_trace._make_run_id()
        out_dir = pathlib.Path(out_dir) if out_dir else DEFAULT_TELEMETRY_DIR
        self.path = out_dir / f"{self.run_id}.jsonl"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples = 0

    def snapshot(self) -> dict:
        return engine_snapshot(self.engine, slo=self.slo, run_id=self.run_id)

    def start(self) -> "TelemetrySampler":
        if self._thread is not None:
            raise RuntimeError("sampler already started")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-sampler")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None
        self._emit()  # the end-of-run state always lands

    def __enter__(self) -> "TelemetrySampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._emit()

    def _emit(self) -> None:
        try:
            line = json.dumps(self.snapshot(), default=str)
            # Append-only: ``bench top`` tails it, a torn last line is skipped.
            with open(self.path, "a") as fh:
                fh.write(line + "\n")
            self.samples += 1
        except Exception:  # noqa: BLE001 -- telemetry never fails serving
            pass


# ------------------------------------------------------------ bench top


def read_snapshots(path) -> list[dict]:
    """Every parseable snapshot line of one stream (a torn last line is
    skipped: the writer appends whole lines)."""
    out = []
    try:
        text = pathlib.Path(path).read_text()
    except OSError:
        return out
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def newest_stream(root=None) -> pathlib.Path | None:
    """The most recently modified stream under ``root``."""
    root = pathlib.Path(root) if root else DEFAULT_TELEMETRY_DIR
    try:
        files = sorted(root.glob("*.jsonl"), key=os.path.getmtime)
    except OSError:
        return None
    return files[-1] if files else None


def _render_top_fleet(snapshots: list[dict], cur: dict) -> str:
    """The screen of a fleet router's snapshot (tagged ``router: true``):
    the replica table and the routing, hedging and audit counters."""
    stats = cur.get("stats") or {}
    lines = [
        f"fleet router · sample {len(snapshots)} · "
        f"hedge {cur.get('hedge_delay_s')}s · audit {cur.get('audit_frac')}",
        "",
        f"  {'replica':<10} {'ready':<6} {'breaker':<8} {'depth':>6} "
        f"{'burn':>6} {'strikes':>7}  buckets",
    ]
    for rep in cur.get("replicas") or []:
        state = "drain" if rep.get("draining") else ("yes" if rep.get("ready") else "no")
        lines.append(
            f"  {str(rep.get('name')):<10} {state:<6} "
            f"{str(rep.get('breaker', '-')):<8} "
            f"{100.0 * (rep.get('depth_frac') or 0.0):>5.0f}% "
            f"{rep.get('burn') if rep.get('burn') is not None else '-':>6} "
            f"{rep.get('strikes', 0):>7}  {rep.get('inner_buckets')}")
    lines += [
        "",
        f"  routed    {stats.get('routed', 0):>6}   serial "
        f"{stats.get('serial_routed', 0)}   failovers "
        f"{stats.get('failovers', 0)}   decode_failovers "
        f"{stats.get('decode_failovers', 0)}",
        f"  hedges    {stats.get('hedges', 0):>6}   wins "
        f"{stats.get('hedge_wins', 0)}   audits {stats.get('audits', 0)}   "
        f"mismatches {stats.get('audit_mismatches', 0)}",
        f"  sheds     edge={stats.get('edge_sheds', 0)} "
        f"replica={stats.get('replica_sheds_seen', 0)}   breaker_opens "
        f"{stats.get('breaker_opens', 0)}   quarantines "
        f"{stats.get('quarantines', 0)}",
    ]
    mgr = cur.get("manager") or {}
    if mgr:
        lines.append("  manager   " + "   ".join(
            f"{k}={len(mgr[k]) if isinstance(mgr[k], list) else mgr[k]}"
            for k in ("replicas", "spawns", "losses", "quarantines", "trace_shards")
            if mgr.get(k) is not None))
    return "\n".join(lines)


def render_top(snapshots: list[dict]) -> str:
    """The ``bench top`` screen: the latest snapshot and the rates over
    the last window; the fleet view for a router's snapshot."""
    if not snapshots:
        return "no telemetry samples yet"
    cur = snapshots[-1]
    if cur.get("router"):
        return _render_top_fleet(snapshots, cur)
    lines = [
        f"run {cur.get('run_id')} · sample {len(snapshots)} · t={cur.get('t_epoch')}",
        "",
        f"  queue     {cur.get('queue_depth', 0):>6} / {cur.get('queue_capacity', 0)} "
        f"({100.0 * (cur.get('depth_frac') or 0.0):.0f}% full)",
        f"  requests  {cur.get('requests', 0):>6}   completed "
        f"{cur.get('completed', 0)}   errors {cur.get('errors', 0)}   "
        f"shed {cur.get('shed', 0)}   degraded {cur.get('degraded', 0)}",
    ]
    hist = LatencyHistogram.from_dict(cur.get("latency_hist"))
    if hist is not None and hist.total:
        p = hist.percentiles_ms()
        lines.append(f"  latency   p50 {p.get('p50', 0):>8.2f} ms   "
                     f"p95 {p.get('p95', 0):>8.2f} ms   "
                     f"p99 {p.get('p99', 0):>8.2f} ms   (n={hist.total})")
    burn = cur.get("burn_rate")
    if burn is not None:
        state = "OVER BUDGET" if burn > 1.0 else "within budget"
        lines.append(f"  slo burn  {burn:>8.3f}x  ({state})")
    ps = cur.get("program_store") or {}
    if ps:
        lines.append("  programs  " + "   ".join(f"{k}={v}" for k, v in sorted(ps.items())))
    tun = cur.get("tuner")
    if tun:
        adapt = tun.get("time_to_adapt_s")
        lines.append(f"  tuner     {tun.get('state', '?'):<8} "
                     f"promotions={tun.get('promotions', 0)} "
                     f"rejects={tun.get('rejects', 0)}"
                     + (f"  adapted in {adapt:.2f}s" if adapt is not None else ""))
    occ = cur.get("batch_occupancy")
    if occ is not None:
        lines.append(f"  occupancy {occ:>8.3f} mean batch fill")
    if len(snapshots) >= 2:
        prev = snapshots[-2]
        dt = (cur.get("t_epoch") or 0) - (prev.get("t_epoch") or 0)
        if dt > 0:
            dc = (cur.get("completed") or 0) - (prev.get("completed") or 0)
            ds = (cur.get("shed") or 0) - (prev.get("shed") or 0)
            lines.append(f"  window    {dc / dt:.1f} req/s served, "
                         f"{ds / dt:.1f} req/s shed (last {dt:.1f}s)")
    return "\n".join(lines)
