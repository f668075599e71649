"""``torch.profiler`` capture and named ranges (counterpart of
``obs/profiler.py``, which drives ``jax.profiler``).

* :func:`capture` -- a whole run under
  ``torch.profiler.profile``: CPU activity, and CUDA activity when the
  card is up, written as a Chrome trace ``<logdir>/<name>.pt.trace.json``
  (Perfetto and ``chrome://tracing`` read it). Armed by the CLI's
  ``--profile DIR`` or ``SDDMM_TORCH_PROFILE=DIR``.
* :func:`capture_window` -- a bounded capture (a fraction of a second):
  the flight recorder's hook around an anomaly. It refuses (False) while
  another capture runs: one profiler session at a time, as in the JAX
  module.
* :func:`annotate` -- ``torch.profiler.record_function(name)`` around each
  timed op (``fusedSpMM``, ``cgStep``, ``gatLayer``, ...) and the bench
  loop, so the device timeline carries the op names. Built only while a
  capture runs (:func:`active`): otherwise a null context, and the
  dispatch hot path does not even ask.

A capture asked to see the card and given no device event (CUPTI could
not start, or nothing ran on the card) says so: ``Capture.device_events``
is 0, ``Capture.error`` names it and a warning is logged. The caller
decides what that means; ``chip_smoke.py`` fails its phase. Profiling
never takes a run down: a profiler that refuses to start logs a warning
and the run goes on unprofiled.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import threading
import time
from typing import Optional

import torch

from distributed_sddmm_tpu_torch.obs import log

PROFILE_ENV = "SDDMM_TORCH_PROFILE"

#: Chrome-trace categories of device activity (busy time on the card).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_capturing = False
_lock = threading.Lock()


@dataclasses.dataclass
class Capture:
    """What one capture wrote: the trace file, whether CUDA activity was
    asked for, how many device events it holds, and why it has none."""

    logdir: str
    path: Optional[str] = None
    cuda: bool = False
    device_events: int = 0
    error: Optional[str] = None


def active() -> bool:
    """True while a capture runs (annotations are worth building)."""
    return _capturing


def annotate(name: str):
    """``record_function(name)`` while capturing, else a null context."""
    if not _capturing:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def device_time(path: str, name: Optional[str] = None) -> tuple[float, int]:
    """The card's busy ms and its event count in a Chrome trace: every
    DEVICE_CATEGORIES event, or those whose name holds ``name``."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
           and (name is None or name in e.get("name", ""))]
    return sum(e.get("dur", 0) for e in dev) / 1e3, len(dev)


def _device_event_count(path: str) -> int:
    return device_time(path)[1]


@contextlib.contextmanager
def capture(logdir: str, name: Optional[str] = None):
    """Run the block under ``torch.profiler.profile`` into ``logdir``;
    yields the :class:`Capture`, filled in when the block ends."""
    global _capturing
    cap = Capture(logdir=str(logdir), cuda=torch.cuda.is_available())
    with _lock:
        if _capturing:
            cap.error = "another capture is running"
            log.warn("profiler", "capture refused", error=cap.error)
            prof = None
        else:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if cap.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                prof = torch.profiler.profile(activities=activities)
                prof.__enter__()
                _capturing = True
                log.info("profiler", "torch.profiler capture started", logdir=logdir,
                         cuda=cap.cuda)
            except Exception as e:  # noqa: BLE001 -- run unprofiled, never die
                prof = None
                cap.error = f"{type(e).__name__}: {e}"
                log.warn("profiler", "could not start torch.profiler", error=cap.error)
    try:
        yield cap
    finally:
        if prof is not None:
            try:
                if cap.cuda:
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                pathlib.Path(logdir).mkdir(parents=True, exist_ok=True)
                stem = name or f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
                cap.path = str(pathlib.Path(logdir) / f"{stem}.pt.trace.json")
                prof.export_chrome_trace(cap.path)
                cap.device_events = _device_event_count(cap.path)
                if cap.cuda and not cap.device_events:
                    cap.error = ("no device activity captured (CUPTI did not start, "
                                 "or nothing ran on the card)")
                    log.warn("profiler", cap.error, path=cap.path)
                else:
                    log.info("profiler", "torch.profiler trace written", path=cap.path,
                             device_events=cap.device_events)
            except Exception as e:  # noqa: BLE001
                cap.error = f"{type(e).__name__}: {e}"
                log.warn("profiler", "torch.profiler stop failed", error=cap.error)
            finally:
                with _lock:
                    _capturing = False


def capture_available() -> bool:
    """True when this torch has the profiler API (a probe; starts
    nothing)."""
    return hasattr(torch, "profiler") and hasattr(torch.profiler, "profile")


def capture_window(logdir: str, duration_s: float = 0.25, block: bool = True) -> bool:
    """A short capture into ``logdir``. True when a window was started
    (no capture running and the API present), False otherwise.
    ``block=False`` runs it on a daemon thread, so the anomaly hook that
    asks never stalls the dispatch it fired from; that thread's window
    records what the process runs meanwhile."""
    if _capturing or not capture_available():
        return False

    def _window():
        with capture(logdir):
            if active():
                time.sleep(duration_s)

    if block:
        _window()
        return True
    threading.Thread(target=_window, daemon=True, name="profiler-window").start()
    return True
