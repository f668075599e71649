"""Retry, timeout and backoff-with-jitter (counterpart of
``resilience/retry.py``).

:func:`call_with_timeout` runs a callable on a daemon thread and bounds
the *join*, so it works from any thread. The abandoned thread keeps
running after a timeout (nothing can interrupt a stuck C++ call), but
control returns to the caller, which is what a retry loop needs; a caller
whose thread holds a device decides what to do about that thread
(``autotune/measure.py`` does).

:class:`Backoff` is exponential backoff with proportional **jitter**
(fixed steps re-synchronise retries of workers that failed together) and
a **max-elapsed cap** (uncapped growth turns "retry a few times" into
minutes of sleeping on a dead device).
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Callable, Optional


class CallTimeout(TimeoutError):
    """A callable exceeded its wall-clock budget."""


def call_with_timeout(fn: Callable, timeout_s: float, *, label: str = "call"):
    """Run ``fn()`` under a wall-clock bound; usable from any thread.

    ``timeout_s <= 0`` (or None) disables the bound: a direct call. On
    expiry raises :class:`CallTimeout` and abandons the worker thread (a
    daemon)."""
    if timeout_s is None or timeout_s <= 0:
        return fn()

    result: dict = {}

    def runner():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised on the caller
            result["error"] = e

    t = threading.Thread(target=runner, daemon=True, name=f"timeout:{label}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise CallTimeout(f"{label} exceeded {timeout_s:.1f}s")
    if "error" in result:
        raise result["error"]
    return result["value"]


@dataclasses.dataclass
class Backoff:
    """Exponential backoff with proportional jitter and an elapsed cap.

    ``delay(attempt)`` is ``min(base * factor**attempt, max_delay) * (1 +
    U(0, jitter))``. The RNG defaults to a per-process seed (pid and the
    clock), so workers that failed together desynchronise; pass a seeded
    ``random.Random`` for a reproducible schedule."""

    base_s: float = 2.0
    factor: float = 2.0
    jitter: float = 0.25
    max_delay_s: float = 60.0
    max_elapsed_s: float = float("inf")
    rng: Optional[random.Random] = None

    def __post_init__(self):
        if self.rng is None:
            self.rng = random.Random(os.getpid() ^ time.time_ns())

    def delay(self, attempt: int) -> float:
        d = min(self.base_s * self.factor ** attempt, self.max_delay_s)
        if self.jitter > 0:
            d *= 1.0 + self.rng.uniform(0.0, self.jitter)
        return d

    def budget_left(self, elapsed_s: float, next_delay_s: float = 0.0) -> bool:
        """False once sleeping ``next_delay_s`` more would pass the cap:
        the retry loop then fails with the last real error."""
        return elapsed_s + next_delay_s <= self.max_elapsed_s


def retry_call(
    fn: Callable,
    *,
    retries: int = 1,
    timeout_s: float = 0.0,
    backoff: Optional[Backoff] = None,
    retry_on: tuple = (TimeoutError, MemoryError, OSError),
    give_up_on: tuple = (),
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    label: str = "call",
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Call ``fn`` with up to ``retries`` more attempts on transient
    errors. ``give_up_on`` wins over ``retry_on`` (a deterministic failure
    burns no retry). Each attempt runs under ``timeout_s``
    (:func:`call_with_timeout`); sleeps come from ``backoff`` (default
    :class:`Backoff`), and the loop stops early when its elapsed cap would
    be passed. The last error propagates unchanged."""
    bo = backoff if backoff is not None else Backoff()
    t_start = clock()
    last_err: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return call_with_timeout(fn, timeout_s, label=label)
        except give_up_on:
            raise
        except retry_on as e:
            last_err = e
            if attempt >= retries:
                break
            d = bo.delay(attempt)
            if not bo.budget_left(clock() - t_start, d):
                break
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(d)
    assert last_err is not None
    raise last_err
