"""Process-wide structured tracer: nested spans, thread-safe JSONL
(counterpart of ``obs/trace.py``, with its record schema, so the JAX
package's trace reader takes a trace of the port unchanged).

One tracer a process, turned on by ``SDDMM_TORCH_TRACE`` (``1`` -> the
default ``artifacts/traces_torch/<run_id>.jsonl``; any other value is the
output path, a directory taking the default file name), by the CLI's
``--trace``, or by :func:`enable`.

* **Near-zero cost when off.** :func:`span` and :func:`event` check one
  module-level value and return a shared no-op: no allocation, no lock,
  no clock read.
* **Thread-safe emission.** Records are serialised under one lock and
  written as whole lines; span nesting is tracked per thread, so a
  worker thread's spans parent to that thread's enclosing span. The file
  is block-buffered and flushed whenever a thread's outermost span
  closes (and by a record emitted outside any span, and at close): a
  line a timed op would cost a system call a dispatch, and a reader of a
  killed run loses at most the unfinished top-level span's records.
* **Monotonic stamps.** ``t0``/``t1`` are ``clock.now()`` offsets from the
  tracer's start; the ``begin`` record carries the epoch time of that
  origin (``t0_epoch``).
* **One process, one file.** A directory spec puts the run id (which
  holds the pid) in the file name; an explicit ``PATH.jsonl`` that a live
  process already owns reroutes this process into the shard directory
  ``PATH.shards/<run_id>.jsonl``. Enabling exports
  ``SDDMM_TORCH_TRACE`` to child processes (``torchrun`` workers), which
  then write shards of their own; :func:`disable` restores it.

Besides the file there is one optional in-memory sink, the **span ring**
(:func:`arm_ring`): the flight recorder (``obs/flightrec.py``) dumps it
when the watchdog fires. Arming it with no file tracer installs a
memory-only tracer (``path is None``).

Record schema (one JSON object a line, ``schema`` = :data:`SCHEMA_VERSION`):

* ``{"type": "begin", "schema": 1, "run_id", "t0_epoch", "pid"}`` -- the
  first line;
* ``{"type": "span", "name", "id", "parent", "tid", "t0", "t1", "dur_s",
  "attrs"}`` -- written when the span closes (children before parents);
* ``{"type": "event", "name", "id", "parent", "tid", "t", "attrs"}``.
"""

from __future__ import annotations

import collections
import errno
import json
import os
import pathlib
import threading
import time
from typing import Optional

from distributed_sddmm_tpu_torch.obs import clock

#: Trace record schema generation (the JAX package's reader accepts 1).
SCHEMA_VERSION = 1

_REPO = pathlib.Path(__file__).resolve().parents[2]
#: Apart from the JAX package's ``artifacts/traces/``: the two packages'
#: outputs never mix.
DEFAULT_TRACE_DIR = _REPO / "artifacts" / "traces_torch"

TRACE_ENV = "SDDMM_TORCH_TRACE"
#: ``SDDMM_TORCH_TRACE`` values meaning "on, at the default location".
FLAG_VALUES = ("1", "on", "true", "yes")

_active: Optional["Tracer"] = None
_env_checked = False
_registry_lock = threading.Lock()
#: (the inherited SDDMM_TORCH_TRACE, exported?): restored by disable().
_env_export: tuple[Optional[str], bool] = (None, False)
_ring: Optional["SpanRing"] = None


class SpanRing:
    """Bounded ring of the most recent emitted records (thread-safe); a
    span lands when it closes."""

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        #: Records ever appended (``appended - len(records())`` forgotten).
        self.appended = 0

    def append(self, rec: dict) -> None:
        with self._lock:
            self._buf.append(rec)
            self.appended += 1

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


def _make_run_id() -> str:
    return (time.strftime("%Y%m%d-%H%M%S")
            + f"-{os.getpid()}-{int.from_bytes(os.urandom(2), 'big'):04x}")


class _NoopSpan:
    """The shared do-nothing span of a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """A live span, written as one record when it closes."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "tid", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attach attributes before the span closes."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.id = tr.next_id()
        self.tid = threading.get_ident()
        stack = tr.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._t0 = clock.now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = clock.now()
        tr = self.tracer
        stack = tr.stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        if exc and exc[0] is not None:
            self.attrs.setdefault("error", exc[0].__name__)
        tr.emit({
            "type": "span", "name": self.name, "id": self.id,
            "parent": self.parent, "tid": self.tid,
            "t0": round(self._t0 - tr.t0, 9), "t1": round(t1 - tr.t0, 9),
            "dur_s": round(t1 - self._t0, 9), "attrs": self.attrs,
        }, flush=not stack)
        return False


class Tracer:
    """JSONL tracer bound to one file (``path=None``: memory only, the
    ring's)."""

    def __init__(self, path: Optional[pathlib.Path], run_id: str):
        self.path = path
        self.run_id = run_id
        self.t0 = clock.now()
        self._lock = threading.Lock()
        self._ids = 0
        self._local = threading.local()
        self._manifest_final = False
        if path is None:
            self._fh = None
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            # Truncate: one trace a file (rerunning with the same explicit
            # path must not merge runs).
            self._fh = open(path, "w")
        self.emit({"type": "begin", "schema": SCHEMA_VERSION, "run_id": run_id,
                   "t0_epoch": clock.epoch(), "pid": os.getpid()}, flush=True)

    def next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def emit(self, record: dict, flush: bool = False) -> None:
        """Write one record (and flush the file when asked)."""
        ring = _ring
        if ring is not None:
            ring.append(record)
        if self._fh is None:
            return
        line = json.dumps(record, default=str)
        with self._lock:
            if not self._fh.closed:
                self._fh.write(line + "\n")
                if flush:
                    self._fh.flush()

    def current_span_id(self) -> Optional[int]:
        st = self.stack()
        return st[-1] if st else None

    def close(self) -> None:
        if self._fh is None:
            return
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()


# ----------------------------------------------------------- module API


def _env_activate() -> None:
    global _env_checked
    with _registry_lock:
        if _env_checked:
            return
        _env_checked = True
        spec = os.environ.get(TRACE_ENV)
        if spec:
            _enable_locked(None if spec in FLAG_VALUES else spec)


def _owning_pid(path: pathlib.Path) -> Optional[int]:
    """The pid in an existing trace file's begin record, or None."""
    try:
        with open(path) as fh:
            rec = json.loads(fh.readline())
    except (OSError, ValueError):
        return None
    if isinstance(rec, dict) and rec.get("type") == "begin":
        pid = rec.get("pid")
        return pid if isinstance(pid, int) else None
    return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError as e:
        return e.errno == errno.EPERM
    return True


def shard_dir_for(path) -> pathlib.Path:
    """The shard directory of an explicit ``PATH.jsonl``: ``PATH.shards``."""
    return pathlib.Path(path).with_suffix(".shards")


def _resolve_path(spec, run_id: str) -> pathlib.Path:
    if spec is None:
        return DEFAULT_TRACE_DIR / f"{run_id}.jsonl"
    p = pathlib.Path(spec)
    if p.suffix != ".jsonl":
        return p / f"{run_id}.jsonl"
    owner = _owning_pid(p)
    if owner is not None and owner != os.getpid() and _pid_alive(owner):
        return shard_dir_for(p) / f"{run_id}.jsonl"
    return p


def _export_child_spec(spec, resolved: pathlib.Path) -> None:
    """Point child processes at a directory of their own shards (the
    default directory, the given one, or an explicit file's ``.shards``)."""
    global _env_export
    if spec is None:
        child = str(DEFAULT_TRACE_DIR)
    else:
        p = pathlib.Path(spec)
        child = str(shard_dir_for(p) if p.suffix == ".jsonl" else p)
    if resolved.parent.name.endswith(".shards"):
        child = str(resolved.parent)  # rerouted into a shard directory
    _env_export = (os.environ.get(TRACE_ENV), True)
    os.environ[TRACE_ENV] = child


def _enable_locked(spec=None, run_id: Optional[str] = None) -> "Tracer":
    global _active
    if _active is not None:
        return _active
    rid = run_id or _make_run_id()
    path = _resolve_path(spec, rid)
    _active = Tracer(path, rid)
    _export_child_spec(spec, path)
    return _active


def enable(path=None, run_id: Optional[str] = None) -> "Tracer":
    """Turn tracing on (idempotent: an active tracer wins) and write the
    run manifest beside the trace. ``path``: a ``.jsonl`` file, a
    directory, or None for the default."""
    global _env_checked
    with _registry_lock:
        _env_checked = True
        tr = _enable_locked(path, run_id)
    from distributed_sddmm_tpu_torch.obs import manifest

    manifest.write_for_trace(tr)
    return tr


def disable() -> None:
    """Close and deactivate the tracer, disarm the ring and restore the
    inherited ``SDDMM_TORCH_TRACE``: the full reset tests rely on."""
    global _active, _env_checked, _env_export, _ring
    with _registry_lock:
        if _active is not None:
            _active.close()
        _active = None
        _ring = None
        _env_checked = True
        prev, exported = _env_export
        if exported:
            if prev is None:
                os.environ.pop(TRACE_ENV, None)
            else:
                os.environ[TRACE_ENV] = prev
        _env_export = (None, False)


def arm_ring(capacity: int = 512) -> SpanRing:
    """Attach (or return) the span ring; with no tracer active, install a
    memory-only one so spans and events flow. Arm after :func:`enable`
    when both are wanted."""
    global _ring, _active
    if not _env_checked:
        _env_activate()  # a file spec in the environment wins over memory
    with _registry_lock:
        if _ring is None:
            _ring = SpanRing(capacity)
        if _active is None:
            _active = Tracer(None, _make_run_id())
        return _ring


def disarm_ring() -> None:
    """Detach the ring; a memory-only tracer goes with it."""
    global _ring, _active
    with _registry_lock:
        _ring = None
        if _active is not None and _active.path is None:
            _active = None


def ring() -> Optional[SpanRing]:
    return _ring


def tracer() -> Optional[Tracer]:
    """The active tracer, activating from ``SDDMM_TORCH_TRACE`` on the
    first query."""
    if not _env_checked:
        _env_activate()
    return _active


def enabled() -> bool:
    if not _env_checked:
        _env_activate()
    return _active is not None


def run_id() -> Optional[str]:
    tr = tracer()
    return tr.run_id if tr else None


def trace_path() -> Optional[str]:
    tr = tracer()
    return str(tr.path) if tr is not None and tr.path is not None else None


def rel_time(t_perf: float) -> Optional[float]:
    """A ``clock.now()`` stamp as trace-relative time (the unit of span
    ``t0``/``t1`` and event ``t``), or None when not tracing: an emitter
    embeds a stamp it took earlier, where the event's own ``t`` would lag
    it by a scheduling delay (the serving reply events)."""
    tr = tracer()
    return round(t_perf - tr.t0, 9) if tr else None


def span(name: str, **attrs):
    """A context manager timing a nested region; the shared no-op when
    tracing is off."""
    tr = tracer()
    if tr is None:
        return NOOP_SPAN
    return Span(tr, name, attrs)


def event(name: str, **attrs) -> None:
    """An instantaneous record under the current thread's span."""
    tr = tracer()
    if tr is None:
        return
    parent = tr.current_span_id()
    tr.emit({
        "type": "event", "name": name, "id": tr.next_id(),
        "parent": parent, "tid": threading.get_ident(),
        "t": round(clock.now() - tr.t0, 9), "attrs": attrs,
    }, flush=parent is None)
