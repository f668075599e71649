"""Thread-safe counters: the per-op metrics registry and the process-wide
event counters (counterpart of ``obs/metrics.py``).

* :class:`OpMetrics` -- one a strategy (``DistributedSparse.metrics``):
  per op its calls, **kernel_s** (the attempt that succeeded, host clock
  around the call and its device synchronise), **overhead_s** (what the
  resilient path added: failed attempts, backoff sleeps, fault hooks,
  guard checks), retries, communication words and bytes and FLOPs. It is
  also a read-only mapping ``{op: to_dict()[op]}``, so
  ``alg.metrics["cgStep"]["calls"]`` reads a counter.
* :data:`GLOBAL` -- a :class:`Counters` of cross-cutting events
  (``faults_fired``, ``exec_retries``, ``guard_repairs``,
  ``checkpoints_saved``/``loaded``, ``watchdog_anomalies``,
  ``flightrec_dumps``, the autotuner's ``plan_cache_hits``/``misses``,
  ``autotune_trial_retries``, ``autotune_candidates_dropped``).

Accounting conventions, the JAX package's (and ``tools/costmodel.py``'s):
``comm_words`` are per-device float elements of the collectives the
strategy's cost model counts (``in_model`` entries of its
``comm_profile``), the SpMM reduce-scatter apart as ``comm_words_extra``;
``comm_bytes`` are the same under the wire policy; ``flops`` are global
useful FLOPs, ``4 * nnz * R`` a fused pair and ``2 * nnz * R`` a single
op. A ``LocalWorld`` moves none of these words: they are what the layout
would move between cards.
"""

from __future__ import annotations

import collections
import collections.abc
import threading


class Counters:
    """Named float counters behind one lock (add/get/snapshot/clear)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vals: dict[str, float] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._vals[name] = self._vals.get(name, 0.0) + value

    def get(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._vals.get(name, default)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._vals)

    def clear(self) -> None:
        with self._lock:
            self._vals.clear()


#: Process-wide event counters.
GLOBAL = Counters()

_FIELDS = (
    "calls", "kernel_s", "overhead_s", "retries",
    "comm_words", "comm_bytes", "comm_words_extra", "flops",
)


class OpMetrics(collections.abc.Mapping):
    """Per-op accumulators of one strategy (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: dict[str, dict] = {}
        #: Per-op gauges (set, not summed), kept across :meth:`clear`.
        self._gauges: dict[str, dict] = {}
        #: Per-op gauges of the tile structure (:meth:`note_structure`):
        #: scraped and read by the tuner, kept out of :meth:`to_dict`.
        self._structure: dict[str, dict] = {}

    def note(self, op: str, **gauges) -> None:
        """Set per-op gauges (last write wins); they join the op's dict in
        :meth:`to_dict` once the op has run."""
        with self._lock:
            self._gauges.setdefault(op, {}).update(gauges)

    def gauges(self) -> dict:
        """Every noted gauge, ops that never ran included."""
        with self._lock:
            return {op: dict(g) for op, g in self._gauges.items()}

    def note_structure(self, op: str, **gauges) -> None:
        """Set per-op gauges of the tile structure (last write wins). They
        stay out of :meth:`to_dict`, so a record keeps the JAX package's
        fields; ``/metrics`` and the tuner read :meth:`structure_gauges`."""
        with self._lock:
            self._structure.setdefault(op, {}).update(gauges)

    def structure_gauges(self) -> dict:
        with self._lock:
            return {op: dict(g) for op, g in self._structure.items()}

    def record(self, op: str, kernel_s: float, overhead_s: float = 0.0,
               retries: int = 0, comm_words: float = 0.0, comm_bytes: float = 0.0,
               comm_words_extra: float = 0.0, flops: float = 0.0,
               calls: int = 1) -> None:
        with self._lock:
            rec = self._ops.get(op)
            if rec is None:
                rec = self._ops[op] = dict.fromkeys(_FIELDS, 0.0)
            rec["calls"] += calls
            rec["kernel_s"] += kernel_s
            rec["overhead_s"] += overhead_s
            rec["retries"] += retries
            rec["comm_words"] += comm_words
            rec["comm_bytes"] += comm_bytes
            rec["comm_words_extra"] += comm_words_extra
            rec["flops"] += flops

    # ------------------------------ views ------------------------------ #

    def time_view(self):
        """``{op: kernel seconds}``, the ``json_perf_statistics`` shape."""
        with self._lock:
            return collections.defaultdict(
                float, {k: v["kernel_s"] for k, v in self._ops.items()})

    def wall_view(self):
        """``{op: kernel + overhead seconds}``."""
        with self._lock:
            return collections.defaultdict(
                float, {k: v["kernel_s"] + v["overhead_s"] for k, v in self._ops.items()})

    def calls_view(self):
        with self._lock:
            return collections.defaultdict(
                int, {k: int(v["calls"]) for k, v in self._ops.items()})

    def to_dict(self) -> dict:
        """Every op that ran, sorted, JSON-ready, its gauges merged in."""
        with self._lock:
            out = {}
            for op in sorted(self._ops):
                rec = self._ops[op]
                out[op] = {
                    "calls": int(rec["calls"]),
                    "kernel_s": round(rec["kernel_s"], 9),
                    "overhead_s": round(rec["overhead_s"], 9),
                    "retries": int(rec["retries"]),
                    "comm_words": rec["comm_words"],
                    "comm_bytes": rec["comm_bytes"],
                    "comm_words_extra": rec["comm_words_extra"],
                    "flops": rec["flops"],
                    **self._gauges.get(op, {}),
                }
            return out

    def clear(self) -> None:
        with self._lock:
            self._ops.clear()

    # ------------------------- read-only mapping ------------------------ #

    def __getitem__(self, op: str) -> dict:
        return self.to_dict()[op]

    def __iter__(self):
        with self._lock:
            return iter(sorted(self._ops))

    def __len__(self) -> int:
        with self._lock:
            return len(self._ops)


#: The fraction of one fused SDDMM+SpMM pair each op is (``gatLayer`` is
#: a head's: the caller scales by the head count). ``fusedSpMMB``,
#: ``fusedAttnB`` and ``cgStepB`` are cost names of B-mode calls, which
#: count under the public op's name but are charged the transposed
#: layout.
OP_PAIRS = {
    "fusedSpMM": 1.0, "fusedSpMMB": 1.0, "fusedAttn": 1.0, "fusedAttnB": 1.0,
    "cgStep": 1.0, "cgStepB": 1.0, "gatLayer": 1.0,
    "sddmmA": 0.5, "sddmmB": 0.5, "spmmA": 0.5, "spmmB": 0.5,
}


def op_flops(op: str, nnz: int, R: int, pairs: float = 1.0) -> float:
    """Global useful FLOPs of one call: ``4 * nnz * R`` a fused pair."""
    frac = OP_PAIRS.get(op)
    if frac is None:
        return 0.0
    return 4.0 * nnz * R * frac * pairs
