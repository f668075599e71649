"""Anomaly-triggered flight recorder: dump the last spans when the
watchdog fires (counterpart of ``obs/flightrec.py``).

The tracer keeps a bounded ring of recent spans and events
(``obs.trace.arm_ring``); when the watchdog records an anomaly while a
recorder is armed, the ring and the global counters (and, with
``--profile`` armed too, a short ``torch.profiler`` window) go to::

    artifacts/flightrec_torch/<run_id>/<seq>-<kind>.json

The dump's path rides the anomaly's trace event and the bench record's
``anomalies`` summary (``snapshot_path``). A dump never fails the run (a
failed one returns None and gives its budget slot back), ``max_dumps``
caps the files a process writes, and the ring caps memory. Sources
registered with :meth:`FlightRecorder.register_source` (``bench serve``:
the engine's telemetry snapshot) land in the dump's ``sources``.

Activation: ``SDDMM_TORCH_FLIGHTREC`` (``1``/``on`` -> the default
directory, ``0``/``off`` -> off, anything else -> a directory), the CLI's
``--flightrec``, or :func:`enable`.
"""

from __future__ import annotations

import os
import pathlib
import threading
from typing import Optional

from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.obs import log as obs_log
from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics
from distributed_sddmm_tpu_torch.obs import trace as obs_trace

_REPO = pathlib.Path(__file__).resolve().parents[2]
#: Apart from the JAX package's ``artifacts/flightrec/``.
DEFAULT_FLIGHTREC_DIR = _REPO / "artifacts" / "flightrec_torch"
FLIGHTREC_ENV = "SDDMM_TORCH_FLIGHTREC"

SCHEMA_VERSION = 1


class FlightRecorder:
    """One process's armed black box."""

    def __init__(self, out_dir=None, ring_capacity: int = 512, max_dumps: int = 16,
                 profile_window_s: float = 0.0, run_id: Optional[str] = None):
        self.out_root = pathlib.Path(out_dir) if out_dir else DEFAULT_FLIGHTREC_DIR
        #: Whether this recorder armed the ring (disable disarms only that).
        self._armed_ring = obs_trace.ring() is None
        self.ring = obs_trace.arm_ring(ring_capacity)
        self.max_dumps = int(max_dumps)
        #: > 0 arms a profiler window a dump (the CLI sets it with --profile).
        self.profile_window_s = float(profile_window_s)
        self.run_id = run_id or obs_trace.run_id() or obs_trace._make_run_id()
        self.out_dir = self.out_root / self.run_id
        self._lock = threading.Lock()
        self.dumps = 0
        #: File-name sequence: never refunded, unlike the budget.
        self._seq = 0
        #: Paths written, in firing order.
        self.paths: list[str] = []
        #: Named snapshot callables merged into every dump (``bench serve``
        #: registers the engine's telemetry snapshot).
        self._sources: dict = {}

    def register_source(self, name: str, fn) -> None:
        """Attach a snapshot source, called at each dump; what it raises is
        recorded as its value, never raised."""
        with self._lock:
            self._sources[name] = fn

    def dump(self, kind: str, op: str, attrs: dict) -> Optional[str]:
        """Write one flight record; its path, or None (budget spent or the
        write failed). Never raises."""
        try:
            return self._dump(kind, op, attrs)
        except Exception as e:  # noqa: BLE001 -- the run goes on
            with self._lock:
                self.dumps = max(0, self.dumps - 1)
            obs_log.warn("flightrec", "dump failed", kind=kind,
                         error=f"{type(e).__name__}: {e}")
            return None

    def _dump(self, kind: str, op: str, attrs: dict) -> Optional[str]:
        with self._lock:
            if self.dumps >= self.max_dumps:
                return None
            self.dumps += 1
            seq = self._seq
            self._seq += 1
            sources = dict(self._sources)
        path = self.out_dir / f"{seq:03d}-{kind}.json"
        record = {
            "schema": SCHEMA_VERSION,
            "run_id": self.run_id,
            "seq": seq,
            "t_epoch": clock.epoch(),
            "anomaly": {"kind": kind, "op": op, "attrs": dict(attrs)},
            "ring": self.ring.records(),
            "ring_seen": self.ring.appended,
            "metrics": {"global": obs_metrics.GLOBAL.snapshot()},
        }
        for name, fn in sources.items():
            try:
                record.setdefault("sources", {})[name] = fn()
            except Exception as e:  # noqa: BLE001 -- recorded, not raised
                record.setdefault("sources", {})[name] = {"error": f"{type(e).__name__}: {e}"}
        if self.profile_window_s > 0:
            from distributed_sddmm_tpu_torch.obs import profiler

            logdir = str(self.out_dir / f"{seq:03d}-profile")
            started = profiler.capture_window(logdir, duration_s=self.profile_window_s,
                                              block=False)
            record["profile"] = {"logdir": logdir, "started": started}
        from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_json

        atomic_write_json(path, record, default=str)
        with self._lock:
            self.paths.append(str(path))
        obs_metrics.GLOBAL.add("flightrec_dumps")
        obs_log.warn("flightrec", "anomaly snapshot written", kind=kind, op=op, path=str(path))
        return str(path)


# ----------------------------------------------------- module activation

_active: Optional[FlightRecorder] = None
_env_checked = False
_registry_lock = threading.Lock()


def parse_env_spec(spec: str | None) -> tuple[bool, pathlib.Path | None]:
    """``SDDMM_TORCH_FLIGHTREC``: 0/off/false/no -> off, 1/on/true/yes ->
    the default directory, anything else -> that directory."""
    spec = spec or ""
    low = spec.lower()
    if low in ("", "0", "off", "false", "no"):
        return False, None
    if low in ("1", "on", "true", "yes"):
        return True, None
    return True, pathlib.Path(spec)


def enable(out_dir=None, **knobs) -> FlightRecorder:
    """Arm a process-wide recorder (replacing any previous one)."""
    global _active, _env_checked
    with _registry_lock:
        _env_checked = True
        _active = FlightRecorder(out_dir=out_dir, **knobs)
        return _active


def disable() -> None:
    global _active, _env_checked
    with _registry_lock:
        fr = _active
        _active = None
        _env_checked = True
    if fr is not None and fr._armed_ring:
        obs_trace.disarm_ring()


def active() -> Optional[FlightRecorder]:
    """The armed recorder, activating from ``SDDMM_TORCH_FLIGHTREC`` on
    the first query."""
    global _active, _env_checked
    if _env_checked:
        return _active
    with _registry_lock:
        if not _env_checked:
            _env_checked = True
            enabled, root = parse_env_spec(os.environ.get(FLIGHTREC_ENV))
            if enabled:
                _active = FlightRecorder(out_dir=root)
    return _active
