"""The one clock module: monotonic ``now()`` and wall ``epoch()``
(counterpart of ``obs/clock.py``).

Durations and timeline stamps read :func:`now` (``time.perf_counter``:
monotonic, immune to NTP steps); metadata that must mean something across
processes reads :func:`epoch` (``time.time``). A span whose two ends came
from different clocks could report a negative duration across an NTP
correction, and shards of a multi-process trace that mixed them could not
be aligned.
"""

from __future__ import annotations

import time


def now() -> float:
    """Monotonic seconds (``time.perf_counter``), comparable only within
    this process."""
    return time.perf_counter()


def epoch() -> float:
    """Wall-clock seconds since the Unix epoch (``time.time``). Never
    subtract two of these for a duration."""
    return time.time()

