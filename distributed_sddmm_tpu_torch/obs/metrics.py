"""Thread-safe event counters (the ``Counters`` class and ``GLOBAL`` of
``obs/metrics.py``).

:data:`GLOBAL` counts cross-cutting events of the process; the autotuner
bumps ``plan_cache_hits``, ``plan_cache_misses``,
``autotune_trial_retries`` and ``autotune_candidates_dropped``. The
per-op registry (``OpMetrics``), the trace spans and the rest of the JAX
package's observability layer are not ported; strategies keep their own
per-op counters (``DistributedSparse.metrics``).
"""

from __future__ import annotations

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
