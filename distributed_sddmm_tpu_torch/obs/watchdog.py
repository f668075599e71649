"""In-run anomaly watchdog: step-time spikes and drift, repair storms,
queue runaway and comm-model disagreement (counterpart of
``obs/watchdog.py``).

* **step_time_spike / step_time_drift** -- an EWMA per op at the dispatch
  choke point (``parallel/base.py::_timed``) and per ALS step / GAT layer
  (the apps' hooks). A dispatch far above the moving average is a spike;
  a moving average creeping above its early baseline (the median of the
  first ``min_samples``, robust to a first call that builds kernels) is
  drift.
* **repair_storm** -- guard repairs plus exec retries per window of
  dispatches: a rate of healed faults is a sick device retries hide.
* **queue_runaway** -- a serving queue at ``queue_frac`` of capacity for
  ``queue_patience`` samples (:meth:`Watchdog.observe_queue`).
* **comm_mismatch** -- a strategy's counted per-device words for a fused
  pair against ``tools/costmodel.pair_words`` of its declared model,
  once per geometry.

The JAX module's fifth check, analytic FLOPs against XLA's
``cost_analysis`` of the compiled programs (``check_xla_costs``), has no
torch counterpart: eager PyTorch compiles no program to cost, so the
record carries no ``xla_cost`` and no such anomaly.

Every anomaly is recorded (the bench record's ``anomalies`` summary),
emitted as an ``anomaly`` trace event, logged and counted
(``watchdog_anomalies``); an armed flight recorder dumps first. Modes
(``SDDMM_TORCH_WATCHDOG`` or :func:`enable`): ``warn`` (also ``1``/``on``)
reports only, and the watchdog only ever reads timings and counters;
``strict`` then raises :class:`WatchdogAlarm`, a
:class:`~distributed_sddmm_tpu_torch.resilience.guards.NumericalFault`,
which the ALS ladder answers as it does a tripped guard. Off (the
default) every hook is one module-level ``None`` check.
"""

from __future__ import annotations

import os
import statistics
import threading
from typing import Optional

from distributed_sddmm_tpu_torch.obs import log as obs_log
from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics
from distributed_sddmm_tpu_torch.obs import trace as obs_trace
from distributed_sddmm_tpu_torch.resilience.guards import NumericalFault

WATCHDOG_ENV = "SDDMM_TORCH_WATCHDOG"


class WatchdogAlarm(NumericalFault):
    """An anomaly escalated under ``strict``, typed as a NumericalFault
    so the degradation ladder owns the response."""


class Watchdog:
    """Anomaly state of one process-wide monitoring session."""

    #: Ops the analytic model predicts exactly: whole fused pairs
    #: (B-mode cost names included). Single ops and GAT layers are left
    #: out, as in the trace report.
    _COMM_CHECK_OPS = ("fusedSpMM", "fusedSpMMB", "cgStep", "cgStepB")

    def __init__(self, mode: str = "warn", spike_factor: float = 3.0,
                 min_abs_s: float = 5e-3, drift_factor: float = 2.0, min_samples: int = 5,
                 ewma_alpha: float = 0.2, storm_window: int = 20, storm_rate: float = 0.25,
                 comm_rtol: float = 0.25, queue_frac: float = 0.75, queue_patience: int = 5):
        if mode not in ("warn", "strict"):
            raise ValueError(f"watchdog mode {mode!r}; expected warn|strict")
        self.mode = mode
        self.spike_factor = spike_factor
        self.min_abs_s = min_abs_s
        self.drift_factor = drift_factor
        self.min_samples = min_samples
        self.ewma_alpha = ewma_alpha
        self.storm_window = storm_window
        self.storm_rate = storm_rate
        self.comm_rtol = comm_rtol
        self.queue_frac = queue_frac
        self.queue_patience = queue_patience
        self._queue_streak = 0
        self._queue_flagged = False
        #: Every anomaly in firing order (records slice it by cursor).
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._ops: dict[str, dict] = {}
        self._drift_flagged: set[str] = set()
        self._comm_checked: dict[tuple, bool] = {}
        self._dispatches = 0
        self._storm_mark: dict[str, float] = {}

    # ------------------------------ anomalies --------------------------- #

    def _anomaly(self, kind: str, op: str, **attrs) -> str:
        """Record and emit one anomaly; never raises (strict escalation
        waits in :meth:`_escalate` until every co-detected anomaly is
        out). An armed flight recorder dumps first, so its ring ends at
        the spans that preceded the anomaly and its path rides the
        event."""
        from distributed_sddmm_tpu_torch.obs import flightrec

        fr = flightrec.active()
        if fr is not None:
            snapshot_path = fr.dump(kind, op, attrs)
            if snapshot_path:
                attrs = {**attrs, "snapshot_path": snapshot_path}
        with self._lock:
            self.events.append({"kind": kind, "op": op, **attrs})
        obs_metrics.GLOBAL.add("watchdog_anomalies")
        obs_trace.event("anomaly", kind=kind, op=op, **attrs)
        obs_log.warn("watchdog", f"{kind} on {op}", **{k: _fmt(v) for k, v in attrs.items()})
        return f"{kind} on {op} ({attrs})"

    def _escalate(self, descriptions: list[str]) -> None:
        if descriptions and self.mode == "strict":
            raise WatchdogAlarm("watchdog: " + "; ".join(descriptions))

    # ------------------------------ step time --------------------------- #

    def observe(self, op: str, dur_s: float) -> None:
        """Feed one timed region; spike and drift are judged against the
        op's own history."""
        spike = drift = None
        with self._lock:
            # Storm accounting first, whatever the op's warmup state, so a
            # window boundary never slides.
            self._dispatches += 1
            storm = self._storm_check_locked()
            st = self._ops.get(op)
            if st is None:
                st = self._ops[op] = {"count": 0, "ewma": 0.0, "warmup": [], "baseline": 0.0}
            if st["count"] < self.min_samples:
                st["count"] += 1
                st["warmup"].append(dur_s)
                if st["count"] == self.min_samples:
                    st["baseline"] = st["ewma"] = statistics.median(st["warmup"])
            else:
                ewma = st["ewma"]
                if dur_s > self.spike_factor * ewma and dur_s - ewma > self.min_abs_s:
                    spike = (dur_s, ewma)
                st["ewma"] = ewma = (1 - self.ewma_alpha) * ewma + self.ewma_alpha * dur_s
                st["count"] += 1
                baseline = st["baseline"]
                if (op not in self._drift_flagged and st["count"] > 2 * self.min_samples
                        and ewma > self.drift_factor * baseline
                        and ewma - baseline > self.min_abs_s):
                    self._drift_flagged.add(op)
                    drift = (ewma, baseline)
        fired = []
        if spike:
            fired.append(self._anomaly(
                "step_time_spike", op, dur_s=round(spike[0], 6), ewma_s=round(spike[1], 6),
                factor=round(spike[0] / max(spike[1], 1e-12), 2)))
        if drift:
            fired.append(self._anomaly(
                "step_time_drift", op, ewma_s=round(drift[0], 6),
                baseline_s=round(drift[1], 6),
                factor=round(drift[0] / max(drift[1], 1e-12), 2)))
        if storm:
            fired.append(self._anomaly("repair_storm", "*", **storm))
        self._escalate(fired)

    def _storm_check_locked(self) -> dict | None:
        """Every ``storm_window`` dispatches: repairs and retries since the
        last mark, a storm above ``storm_rate`` a dispatch."""
        if self._dispatches % self.storm_window:
            return None
        snap = obs_metrics.GLOBAL.snapshot()
        repairs = snap.get("guard_repairs", 0.0) + snap.get("exec_retries", 0.0)
        prev = self._storm_mark.get("repairs", None)
        self._storm_mark["repairs"] = repairs
        if prev is None:
            return None
        rate = (repairs - prev) / self.storm_window
        if rate > self.storm_rate:
            return {"repairs_in_window": repairs - prev, "window": self.storm_window,
                    "rate": round(rate, 3)}
        return None

    # ------------------------------ queue depth ------------------------- #

    def observe_queue(self, depth: int, capacity: int) -> None:
        """Feed one serving-queue depth; one anomaly an episode of depth
        at or above ``queue_frac * capacity`` for ``queue_patience``
        samples running."""
        fired = None
        with self._lock:
            if capacity <= 0:
                return
            if depth >= self.queue_frac * capacity:
                self._queue_streak += 1
                if not self._queue_flagged and self._queue_streak >= self.queue_patience:
                    self._queue_flagged = True
                    fired = (depth, self._queue_streak)
            else:
                self._queue_streak = 0
                self._queue_flagged = False
        if fired:
            self._escalate([self._anomaly(
                "queue_runaway", "serve", depth=fired[0], capacity=capacity,
                frac=round(fired[0] / capacity, 3), streak=fired[1])])

    # --------------------------- comm vs model -------------------------- #

    def check_comm(self, strategy, op: str, counted_words: float, pairs: float = 1.0) -> None:
        """Counted per-device words of one call of ``op`` against the
        strategy's cost model, once per (geometry, op, R, pairs)."""
        if op not in self._COMM_CHECK_OPS:
            return
        model_name = getattr(strategy, "cost_model_name", None)
        frac = obs_metrics.OP_PAIRS.get(op)
        if model_name is None or frac is None or strategy.S_tiles is None:
            return
        key = (strategy.algorithm_name, model_name, op, strategy.M_pad, strategy.N_pad,
               strategy.p, strategy.c, strategy.R, pairs)
        with self._lock:
            if key in self._comm_checked:
                return
            self._comm_checked[key] = True
        from distributed_sddmm_tpu_torch.tools import costmodel

        try:
            model_words = costmodel.pair_words(
                model_name, strategy.M_pad, strategy.N_pad, strategy.R,
                strategy.S_tiles.nnz, strategy.p, strategy.c) * frac * pairs
        except ValueError:
            return
        if model_words <= 0:
            if counted_words > 0:
                self._escalate([self._anomaly("comm_mismatch", op, counted_words=counted_words,
                                              model_words=0.0, ratio=None)])
            return
        ratio = counted_words / model_words
        if abs(ratio - 1.0) > self.comm_rtol:
            self._escalate([self._anomaly(
                "comm_mismatch", op, counted_words=counted_words, model_words=model_words,
                ratio=round(ratio, 4), model=model_name)])

    def observe_dispatch(self, strategy, op: str, dur_s: float, counted_words: float = 0.0,
                         pairs: float = 1.0, cost_op: str | None = None) -> None:
        """The ``_timed`` hook: the one-time comm check, then the EWMA."""
        self.check_comm(strategy, cost_op or op, counted_words, pairs)
        self.observe(op, dur_s)

    # ------------------------------ summary ----------------------------- #

    def summary(self, since: int = 0) -> dict:
        """Anomalies after cursor ``since``, grouped by (kind, op) with a
        count and the first one's detail; ``snapshots`` lists the flight
        records they produced, in firing order."""
        with self._lock:
            events = list(self.events[since:])
        grouped: dict[tuple, dict] = {}
        snapshots: list[str] = []
        for ev in events:
            k = (ev["kind"], ev["op"])
            g = grouped.get(k)
            if g is None:
                g = grouped[k] = {"kind": ev["kind"], "op": ev["op"], "count": 0,
                                  "first": {a: v for a, v in ev.items()
                                            if a not in ("kind", "op")}}
            g["count"] += 1
            if ev.get("snapshot_path"):
                snapshots.append(ev["snapshot_path"])
        out = {"mode": self.mode, "total": len(events),
               "anomalies": [grouped[k] for k in sorted(grouped)]}
        if snapshots:
            out["snapshots"] = snapshots
        return out


def _fmt(v):
    return round(v, 6) if isinstance(v, float) else v


# ----------------------------------------------------- module activation

_active: Optional[Watchdog] = None
_env_checked = False
_registry_lock = threading.Lock()


def enable(mode: str = "warn", **knobs) -> Watchdog:
    """Activate a process-wide watchdog (replacing any previous one)."""
    global _active, _env_checked
    with _registry_lock:
        _env_checked = True
        _active = Watchdog(mode=mode, **knobs)
        return _active


def disable() -> None:
    global _active, _env_checked
    with _registry_lock:
        _active = None
        _env_checked = True


def active() -> Optional[Watchdog]:
    """The active watchdog, activating from ``SDDMM_TORCH_WATCHDOG`` on
    the first query (``warn``/``1``/``on`` -> warn, ``strict`` -> strict,
    anything else -> off)."""
    global _active, _env_checked
    if _env_checked:
        return _active
    with _registry_lock:
        if not _env_checked:
            _env_checked = True
            spec = os.environ.get(WATCHDOG_ENV, "").lower()
            if spec in ("warn", "1", "on", "true", "yes"):
                _active = Watchdog(mode="warn")
            elif spec == "strict":
                _active = Watchdog(mode="strict")
    return _active
