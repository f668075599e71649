"""Structured stderr logger (counterpart of ``obs/log.py``).

One line a record: ``[component] message key=value ...`` on stderr, with
a level gate (``SDDMM_TORCH_LOG`` = ``debug`` | ``info`` | ``warn`` |
``error``, default ``info``) and, while tracing, a mirrored ``log`` event
in the trace, so a diagnostic lands beside the spans it explains. The
fault hooks, the watchdog, the flight recorder, the profiler and the
serving layer log here; the apps and the checkpoint store keep their
Python ``logging`` loggers (``als``, ``guards``, ``checkpoint``,
``autotune.measure``). A CLI's output (JSON lines, tables) is not
logging and stays on stdout.
"""

from __future__ import annotations

import os
import sys
import threading

from distributed_sddmm_tpu_torch.obs import trace

LOG_ENV = "SDDMM_TORCH_LOG"
LEVELS = {"debug": 10, "info": 20, "warn": 30, "warning": 30, "error": 40}

_write_lock = threading.Lock()


def threshold() -> int:
    """The level gate, read from ``SDDMM_TORCH_LOG`` on every call."""
    return LEVELS.get(os.environ.get(LOG_ENV, "info").lower(), 20)


def log(level: str, component: str, msg: str, **fields) -> None:
    if LEVELS.get(level, 20) < threshold():
        return
    line = " ".join([f"[{component}] {msg}"] + [f"{k}={v}" for k, v in fields.items()])
    with _write_lock:
        sys.stderr.write(line + "\n")
    if trace.enabled():
        attrs = {"level": level, "component": component, "msg": msg}
        for k, v in fields.items():
            # "name" is trace.event's own positional argument.
            attrs[k if k != "name" else "name_"] = v
        trace.event("log", **attrs)


def info(component: str, msg: str, **fields) -> None:
    log("info", component, msg, **fields)


def warn(component: str, msg: str, **fields) -> None:
    log("warn", component, msg, **fields)



def error(component: str, msg: str, **fields) -> None:
    log("error", component, msg, **fields)
