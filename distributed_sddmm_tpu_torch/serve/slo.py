"""SLO specs, per-request latency recording, and the open-loop load gen
(counterpart of ``serve/slo.py``).

Three pieces, one contract:

* :class:`SLOSpec` — the target (``SDDMM_TORCH_SLO="p99_ms=250,err_rate=0.01"``
  or the ``--slo`` flag): latency percentiles in milliseconds plus an
  error-rate bound. :meth:`SLOSpec.check` turns an observed summary into
  a (possibly empty) list of violations.
* :class:`LatencyRecorder` — the measurement half: per-request stage
  latencies (enqueue→admit→execute→reply, straight off the
  :class:`~distributed_sddmm_tpu_torch.serve.queue.Request` timeline), queue
  depth and batch occupancy samples, shed/error/degraded counts.
  Percentiles use the nearest-rank convention (p99 of 100 samples is the
  99th largest — no interpolation invents latencies nobody observed).
* :func:`run_load` — an **open-loop Poisson** load generator: arrival
  times are drawn ahead of time from a seeded exponential process and
  submissions happen at those instants regardless of completions (a
  closed loop self-throttles and hides capacity cliffs; open-loop is the
  honest way to ask "does this engine sustain λ req/s"). Every Nth reply
  is checked against the workload's float64 oracle.

The summary :func:`run_load` returns is the serving half of a bench
record: ``latency_ms`` percentiles, ``shed_count``, occupancy — the
fields ``bench serve`` persists to the run store and ``bench gate``
regresses on (``obs/regress.py`` serving axes).
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time  # time.sleep only; clocks go through obs.clock
from typing import Optional

import numpy as np

from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.obs import log as obs_log
from distributed_sddmm_tpu_torch.obs.telemetry import LatencyHistogram
from distributed_sddmm_tpu_torch.serve.queue import (
    DEFAULT_TENANT, ShedError, TenantSpec,
)

_PCTS = (50, 95, 99)

#: The default SLO spec and tenant table of ``bench serve``.
SLO_ENV = "SDDMM_TORCH_SLO"
TENANTS_ENV = "SDDMM_TORCH_TENANTS"


def percentile(samples: list[float], pct: float) -> float | None:
    """Nearest-rank percentile (None on empty input)."""
    if not samples:
        return None
    ordered = sorted(samples)
    rank = max(1, math.ceil(pct / 100.0 * len(ordered)))
    return ordered[rank - 1]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Latency/error targets. Unset fields (None) are unconstrained."""

    p50_ms: float | None = None
    p95_ms: float | None = None
    p99_ms: float | None = None
    err_rate: float | None = None
    shed_rate: float | None = None

    _FIELDS = ("p50_ms", "p95_ms", "p99_ms", "err_rate", "shed_rate")

    @classmethod
    def parse(cls, spec: str | None) -> "SLOSpec":
        """``"p99_ms=250,err_rate=0.01"`` → SLOSpec. Unknown keys raise —
        a typo'd SLO that silently constrains nothing would make every
        run green."""
        if not spec:
            return cls()
        kw = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"SLO entry {part!r} is not key=value")
            k, v = part.split("=", 1)
            k = k.strip()
            if k not in cls._FIELDS:
                raise ValueError(
                    f"unknown SLO key {k!r}; expected one of {cls._FIELDS}"
                )
            kw[k] = float(v)
        return cls(**kw)

    @classmethod
    def from_env(cls) -> "SLOSpec":
        return cls.parse(os.environ.get(SLO_ENV))

    def to_dict(self) -> dict:
        return {
            k: v for k, v in dataclasses.asdict(self).items() if v is not None
        }

    def check(self, summary: dict) -> list[dict]:
        """Violations of this spec in a :meth:`LatencyRecorder.summary`
        (empty list = SLO met; unmeasured axes are not violations)."""
        out = []
        lat = summary.get("latency_ms") or {}
        for pct in _PCTS:
            want = getattr(self, f"p{pct}_ms")
            got = lat.get(f"p{pct}")
            if want is not None and got is not None and got > want:
                out.append({"axis": f"p{pct}_ms", "limit": want,
                            "observed": round(got, 3)})
        for axis in ("err_rate", "shed_rate"):
            want = getattr(self, axis)
            got = summary.get(axis)
            if want is not None and got is not None and got > want:
                out.append({"axis": axis, "limit": want,
                            "observed": round(got, 6)})
        return out

    def burn_rate(self, summary: dict) -> float | None:
        """Worst-axis error-budget burn rate for this spec over one
        recorder summary (None when no constrained axis is measurable).

        A ``pXX_ms`` target's budget is the ``(100-XX)%`` of requests
        allowed above it; the observed bad fraction comes from the
        summary's fixed-bucket ``request_hist`` so burn rates from
        different processes/windows aggregate the way the histograms
        do. ``err_rate``/``shed_rate`` budgets divide directly. 1.0 =
        burning exactly at budget; >1 = on course to violate.
        """
        rates = []
        hist = LatencyHistogram.from_dict(summary.get("request_hist"))
        if hist is not None and hist.total:
            for pct in _PCTS:
                want = getattr(self, f"p{pct}_ms")
                budget = 1.0 - pct / 100.0
                if want is None or budget <= 0:
                    continue
                rates.append(hist.fraction_above(want) / budget)
        for axis in ("err_rate", "shed_rate"):
            want = getattr(self, axis)
            got = summary.get(axis)
            if want and got is not None:
                rates.append(got / want)
        return round(max(rates), 4) if rates else None


def parse_tenants(spec: str | None) -> Optional[dict[str, TenantSpec]]:
    """``"premium:3:p99_ms=250,err_rate=0.01;batch:1"`` → tenant table.

    Grammar: ``;``-separated tenant clauses, each ``name[:weight[:slo]]``.
    The SLO sub-spec is the :meth:`SLOSpec.parse` grammar (commas inside
    it are why clauses join on ``;``). Weight defaults to 1.0. Returns
    None on an empty spec so callers fall back to single-tenant mode.
    """
    if not spec:
        return None
    out: dict[str, TenantSpec] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":", 2)
        name = fields[0].strip()
        weight = 1.0
        if len(fields) > 1 and fields[1].strip():
            weight = float(fields[1])
        slo = None
        if len(fields) > 2 and fields[2].strip():
            slo = SLOSpec.parse(fields[2].strip())
        if name in out:
            raise ValueError(f"duplicate tenant {name!r} in spec")
        out[name] = TenantSpec(name=name, weight=weight, slo=slo)
    return out or None


def tenants_from_env() -> Optional[dict[str, TenantSpec]]:
    return parse_tenants(os.environ.get(TENANTS_ENV))


class LatencyRecorder:
    """Thread-safe accumulator for one serving session's observations."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total_s: list[float] = []
        self._queue_s: list[float] = []
        self._batch_wait_s: list[float] = []
        self._execute_s: list[float] = []
        self._depth: list[int] = []
        self._occupancy: list[float] = []
        #: Fixed-bucket total-latency histogram — the mergeable view
        #: (sample-list percentiles above are exact but unmergeable).
        self.hist = LatencyHistogram()
        self.completed = 0
        self.errors = 0
        self.degraded = 0
        self.shed = 0
        #: Per-tenant breakdown (QoS axes). Cells appear lazily so the
        #: single-tenant path pays nothing and old summaries are stable.
        self._tenant_stats: dict[str, dict] = {}

    # -- feeding ------------------------------------------------------- #

    def _tenant_cell(self, tenant: str) -> dict:
        """Caller holds the lock."""
        cell = self._tenant_stats.get(tenant)
        if cell is None:
            cell = {"completed": 0, "errors": 0, "shed": 0,
                    "hist": LatencyHistogram()}
            self._tenant_stats[tenant] = cell
        return cell

    def record_reply(self, req) -> None:
        stages = req.stage_latencies_s()
        tenant = getattr(req, "tenant", DEFAULT_TENANT)
        with self._lock:
            self.completed += 1
            cell = self._tenant_cell(tenant)
            cell["completed"] += 1
            if req.degraded:
                self.degraded += 1
            if "total_s" in stages:
                self._total_s.append(stages["total_s"])
                self.hist.add(stages["total_s"] * 1e3)
                cell["hist"].add(stages["total_s"] * 1e3)
            if "queue_s" in stages:
                self._queue_s.append(stages["queue_s"])
            if "batch_wait_s" in stages:
                self._batch_wait_s.append(stages["batch_wait_s"])
            if "execute_s" in stages:
                self._execute_s.append(stages["execute_s"])

    def record_error(self, tenant: str = DEFAULT_TENANT) -> None:
        with self._lock:
            self.errors += 1
            self._tenant_cell(tenant)["errors"] += 1

    def record_shed(self, tenant: str = DEFAULT_TENANT) -> None:
        with self._lock:
            self.shed += 1
            self._tenant_cell(tenant)["shed"] += 1

    def record_batch(self, batch_size: int, bucket: int, depth: int) -> None:
        with self._lock:
            self._depth.append(depth)
            self._occupancy.append(batch_size / bucket if bucket else 0.0)

    # -- reporting ----------------------------------------------------- #

    @staticmethod
    def _pct_ms(samples: list[float]) -> dict:
        out = {}
        for pct in _PCTS:
            v = percentile(samples, pct)
            if v is not None:
                out[f"p{pct}"] = round(v * 1e3, 3)
        if samples:
            out["mean"] = round(sum(samples) / len(samples) * 1e3, 3)
            out["max"] = round(max(samples) * 1e3, 3)
        return out

    def summary(self) -> dict:
        with self._lock:
            total = list(self._total_s)
            queue = list(self._queue_s)
            batch_wait = list(self._batch_wait_s)
            execute = list(self._execute_s)
            depth = list(self._depth)
            occ = list(self._occupancy)
            completed, errors = self.completed, self.errors
            shed, degraded = self.shed, self.degraded
            hist = LatencyHistogram(self.hist.bounds_ms,
                                    list(self.hist.counts))
            tstats = {
                name: {"completed": c["completed"], "errors": c["errors"],
                       "shed": c["shed"],
                       "hist": LatencyHistogram(c["hist"].bounds_ms,
                                                list(c["hist"].counts))}
                for name, c in self._tenant_stats.items()
            }
        requests = completed + errors + shed
        out = {
            "requests": requests,
            "completed": completed,
            "errors": errors,
            "shed_count": shed,
            "degraded_count": degraded,
            "err_rate": errors / requests if requests else 0.0,
            "shed_rate": shed / requests if requests else 0.0,
            "latency_ms": self._pct_ms(total),
            "queue_ms": self._pct_ms(queue),
            "batch_wait_ms": self._pct_ms(batch_wait),
            "execute_ms": self._pct_ms(execute),
        }
        if hist.total:
            # The mergeable histogram view (bench-record fields the
            # runstore index lifts into hist_p* columns).
            out["request_hist"] = hist.to_dict()
            out["latency_hist_ms"] = hist.percentiles_ms()
        if occ:
            out["batch_occupancy"] = {
                "mean": round(sum(occ) / len(occ), 4),
                "p50": round(percentile(occ, 50), 4),
                "batches": len(occ),
            }
        if depth:
            out["queue_depth"] = {
                "mean": round(sum(depth) / len(depth), 2),
                "p95": percentile(depth, 95),
                "max": max(depth),
            }
        if set(tstats) - {DEFAULT_TENANT}:
            # Per-tenant QoS breakdown — only emitted once a named
            # tenant shows up, so single-tenant records keep their
            # pre-fleet shape byte for byte.
            out["tenant"] = {
                name: self._tenant_summary(cell)
                for name, cell in sorted(tstats.items())
            }
        return out

    @staticmethod
    def _tenant_summary(cell: dict) -> dict:
        t_req = cell["completed"] + cell["errors"] + cell["shed"]
        entry = {
            "requests": t_req,
            "completed": cell["completed"],
            "errors": cell["errors"],
            "shed_count": cell["shed"],
            "err_rate": cell["errors"] / t_req if t_req else 0.0,
            "shed_rate": cell["shed"] / t_req if t_req else 0.0,
        }
        if cell["hist"].total:
            entry["request_hist"] = cell["hist"].to_dict()
            entry["latency_hist_ms"] = cell["hist"].percentiles_ms()
        return entry


# --------------------------------------------------------------------- #
# Open-loop Poisson load generator
# --------------------------------------------------------------------- #


def run_load(
    engine,
    duration_s: float,
    rate_hz: float,
    seed: int = 0,
    oracle_every: int = 8,
    reply_timeout_s: float = 30.0,
    slo: Optional[SLOSpec] = None,
    tenants: Optional[dict[str, TenantSpec]] = None,
    honor_retry_after: bool = False,
) -> dict:
    """Drive ``engine`` with Poisson arrivals for ``duration_s`` seconds.

    Arrivals are precomputed (seeded exponential inter-arrival gaps at
    ``rate_hz``), submitted open-loop from this thread; each reply is
    collected on its own short-lived waiter thread (pruned as they
    finish) so a slow reply never delays the next arrival — arrival
    instants are absolute offsets from the run start, so thread-spawn
    cost cannot accumulate into schedule drift. Every
    ``oracle_every``-th completed request
    is checked against ``engine.workload.oracle`` (float64 reference);
    mismatches are counted and logged, never raised — the load gen's job
    is to measure, the caller's to judge.

    Returns the recorder summary extended with throughput, oracle-check
    results, and SLO violations (``slo`` defaults to the env spec).

    ``tenants`` (a :func:`parse_tenants` table) makes each arrival pick a
    tenant weighted by the spec weights; per-tenant burn rates land in
    ``summary["tenant"]``. ``honor_retry_after=True`` makes the client a
    good citizen: a shed whose :class:`ShedError` carries a positive
    ``retry_after_s`` opens a backoff window, and arrivals inside it are
    *deferred* (counted, never submitted) — the admission-control
    contract a fleet router relies on to actually relieve pressure.
    """
    slo = slo if slo is not None else SLOSpec.from_env()
    rec = engine.recorder
    rng = np.random.default_rng(seed)
    workload = engine.workload

    tenant_names: list[str] = list(tenants) if tenants else []
    tenant_probs = None
    if tenant_names:
        w = np.array([tenants[t].weight for t in tenant_names], dtype=float)
        tenant_probs = w / w.sum()

    n_expect = max(1, int(duration_s * rate_hz * 2))
    gaps = rng.exponential(1.0 / max(rate_hz, 1e-9), size=n_expect)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration_s]

    oracle_checked = [0]
    oracle_failures = [0]
    waiters: list[threading.Thread] = []
    submitted = 0

    def wait_reply(req, check: bool):
        try:
            reply = req.result(timeout_s=reply_timeout_s)
        except ShedError:
            return  # already counted at submit
        except Exception as e:  # noqa: BLE001 — recorded, run continues
            rec.record_error()
            obs_log.warn("serve", "request failed", req=req.req_id,
                         error=f"{type(e).__name__}: {e}")
            return
        rec.record_reply(req)
        if check:
            oracle_checked[0] += 1
            if not workload.check_reply(req.payload, reply):
                oracle_failures[0] += 1
                obs_log.error("serve", "oracle mismatch", req=req.req_id)

    deferred = 0
    backoff_until = 0.0

    t0 = clock.now()
    for i, t_arr in enumerate(arrivals):
        delay = t0 + float(t_arr) - clock.now()
        if delay > 0:
            time.sleep(delay)
        if honor_retry_after and clock.now() < backoff_until:
            deferred += 1  # honoring the server's Retry-After hint
            continue
        payload = workload.sample_payload(rng)
        try:
            if tenant_names:
                tenant = tenant_names[
                    int(rng.choice(len(tenant_names), p=tenant_probs))
                ]
                req = engine.submit(payload, tenant=tenant)
            else:
                req = engine.submit(payload)
        except ShedError as e:
            # The engine's submit path recorded the shed.
            hint = float(getattr(e, "retry_after_s", 0.0) or 0.0)
            if honor_retry_after and hint > 0:
                backoff_until = clock.now() + hint
            continue
        submitted += 1
        w = threading.Thread(
            target=wait_reply,
            args=(req, oracle_every > 0 and i % oracle_every == 0),
            daemon=True, name=f"serve-wait-{req.req_id}",
        )
        w.start()
        waiters.append(w)
        if len(waiters) >= 256:  # prune finished waiters, bound the list
            waiters = [t for t in waiters if t.is_alive()]

    for w in waiters:
        w.join(reply_timeout_s)
    elapsed = clock.now() - t0

    summary = rec.summary()
    summary.update({
        "duration_s": round(elapsed, 3),
        "offered_rate_hz": rate_hz,
        "offered": int(len(arrivals)),
        "submitted": submitted,
        "throughput_rps": round(summary["completed"] / elapsed, 3)
        if elapsed > 0 else 0.0,
        "oracle_checked": oracle_checked[0],
        "oracle_failures": oracle_failures[0],
    })
    if honor_retry_after:
        summary["retry_after_deferred"] = deferred
    summary["slo"] = slo.to_dict()
    summary["slo_violations"] = slo.check(summary)
    # Error-budget burn rate (None when the spec constrains nothing):
    # the live-telemetry axis `bench gate` regresses run over run.
    summary["burn_rate"] = slo.burn_rate(summary)
    attach_tenant_slo(summary, tenants)
    return summary


def attach_tenant_slo(
    summary: dict, tenants: Optional[dict[str, TenantSpec]],
) -> dict:
    """Judge each declared tenant's sub-summary against its own SLO:
    ``summary["tenant"][name]`` gains ``slo``/``slo_violations``/
    ``burn_rate`` (the per-tenant ``serve:burn_rate:<name>`` gate axes)
    plus the scheduler weight. Declared-but-idle tenants get a zeroed
    cell so the record's tenant table always matches the declaration."""
    if not tenants:
        return summary
    tstats = summary.setdefault("tenant", {})
    for name, tspec in tenants.items():
        entry = tstats.setdefault(name, {
            "requests": 0, "completed": 0, "errors": 0,
            "shed_count": 0, "err_rate": 0.0, "shed_rate": 0.0,
        })
        if tspec.slo is not None:
            entry["slo"] = tspec.slo.to_dict()
            entry["slo_violations"] = tspec.slo.check(entry)
            entry["burn_rate"] = tspec.slo.burn_rate(entry)
        entry["weight"] = tspec.weight
    return summary
