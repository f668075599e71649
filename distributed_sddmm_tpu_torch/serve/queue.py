"""Thread-safe request queue with dynamic micro-batching and backpressure
(counterpart of ``serve/queue.py``).

The front door of the serving layer (`serve/engine.py` is the back):
client threads :meth:`~RequestQueue.submit` individual requests, the
engine's runner thread pulls *micro-batches* — up to ``max_batch``
requests, or whatever has arrived when ``max_wait_ms`` expires after the
first request of the batch, whichever comes first. That is the dynamic
batching bargain from the serving literature (and the same
amortize-setup-over-many-steps insight the offline kernels already
exploit via step-batching): one dispatch of a bucket cell's kernels serves
many requests, with a bounded latency tax on the first arrival.

Admission control is a hard depth bound: a full queue **sheds** new
requests with :class:`ShedError` carrying a ``retry_after_s`` hint
instead of growing without bound — queueing-theory 101 says an open-loop
arrival process above capacity turns an unbounded queue into unbounded
latency; shedding converts that into an explicit, client-visible signal
while requests already admitted still meet their latency target.

Every request carries its timeline (enqueue → admit → execute → reply
monotonic stamps, all read through ``obs.clock``); ``serve/slo.py``
turns those into the percentile histograms the SLO gate judges.

Multi-tenant QoS: the queue holds one FIFO **per tenant class**
(:class:`TenantSpec` — a name, a scheduling weight, and an optional
per-tenant SLO spec the recorder judges burn against) and extracts
micro-batches by **stride scheduling**: each tenant carries a virtual
``pass`` advanced by ``1/weight`` per dequeued request, and the batcher
always drains the non-empty tenant with the smallest pass — over any
busy window tenants receive service in weight proportion, while a lone
tenant degenerates to the exact FIFO the single-tenant engine always
had. Admission stays one shared ``max_depth`` bound (a fleet router
does cross-replica isolation; inside one replica the bound is the
latency protection), but sheds and submissions are **counted per
tenant** so the serve record and the gate axes can judge each class
separately.

Trace context: the request id minted at :meth:`~RequestQueue.submit` is
the correlation key the whole serving path carries — the queue emits a
``serve:enqueue`` event per admission (and ``serve:shed`` per
rejection), the engine's batch spans list their member ``req_ids``, and
the per-request ``serve:reply`` event carries the full segment
decomposition, so ``tools/tracereport.request_chains`` can reconstruct
any request's enqueue→reply timeline from the trace alone.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
from typing import Any, Optional

from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.obs import trace as obs_trace

#: The implicit tenant every un-labeled request belongs to.
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant class: a scheduling weight and (optionally) its own
    SLO. ``slo`` is opaque to the queue (an
    :class:`~distributed_sddmm_tpu_torch.serve.slo.SLOSpec`; ``serve/slo.py``
    parses specs and computes per-tenant burn) — the queue only
    schedules and counts."""

    name: str
    weight: float = 1.0
    slo: Optional[object] = None

    def __post_init__(self):
        if not self.name or any(c in self.name for c in ":;,= \t"):
            raise ValueError(f"bad tenant name {self.name!r}")
        if not self.weight > 0:
            raise ValueError(
                f"tenant {self.name!r} weight must be > 0, "
                f"got {self.weight}"
            )


def _normalize_tenants(tenants) -> dict[str, TenantSpec]:
    if not tenants:
        return {DEFAULT_TENANT: TenantSpec(DEFAULT_TENANT)}
    if isinstance(tenants, dict):
        specs = list(tenants.values())
    else:
        specs = list(tenants)
    out = {}
    for spec in specs:
        if spec.name in out:
            raise ValueError(f"duplicate tenant {spec.name!r}")
        out[spec.name] = spec
    return out


class ShedError(RuntimeError):
    """Request rejected by admission control (queue at ``max_depth``).

    ``retry_after_s`` is the server's drain-time estimate for the current
    backlog — the value an HTTP front end would surface as a 429
    ``Retry-After`` header.
    """

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RequestError(RuntimeError):
    """The engine produced no reply for this request: the batch failed
    past its retries and, on the CPU, the serial fallback failed too; on
    the card there is no host fallback, and ``cause`` holds the
    :class:`~distributed_sddmm_tpu_torch.resilience.guards.NumericalFault`
    that says so (``serve/engine.py``)."""

    def __init__(self, msg: str, cause: BaseException | None = None):
        super().__init__(msg)
        self.cause = cause
        self.__cause__ = cause


class Request:
    """One in-flight request: payload + reply slot + timeline stamps.

    The reply slot is a one-shot event; :meth:`result` blocks the caller
    until the engine delivers (or raises what the engine recorded).
    Timeline stamps are monotonic ``obs.clock.now()`` values filled in
    by the queue (``t_enqueue``), the batcher (``t_admit``), and the
    engine (``t_execute``, ``t_reply``); consecutive stamps bound the
    segments ``queue_s`` / ``batch_wait_s`` / ``execute_s``, which
    partition ``total_s`` exactly.
    """

    __slots__ = (
        "req_id", "payload", "tenant", "t_enqueue", "t_admit",
        "t_execute", "t_reply", "degraded", "_done", "_value", "_error",
    )

    def __init__(self, req_id: int, payload: Any,
                 tenant: str = DEFAULT_TENANT):
        self.req_id = req_id
        self.payload = payload
        self.tenant = tenant
        self.t_enqueue: float = 0.0
        self.t_admit: Optional[float] = None
        self.t_execute: Optional[float] = None
        self.t_reply: Optional[float] = None
        #: Set by the engine when this reply came off the serial fallback
        #: rung instead of the cell's kernels.
        self.degraded: bool = False
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    # -- engine side --------------------------------------------------- #

    def set_result(self, value: Any) -> None:
        self.t_reply = clock.now()
        self._value = value
        self._done.set()

    def set_error(self, err: BaseException) -> None:
        self.t_reply = clock.now()
        self._error = err
        self._done.set()

    # -- client side --------------------------------------------------- #

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout_s: Optional[float] = None) -> Any:
        """Block until the reply lands; raises the engine's recorded
        error, or ``TimeoutError`` if no reply arrives in time."""
        if not self._done.wait(timeout_s):
            raise TimeoutError(
                f"request {self.req_id} unanswered after {timeout_s}s"
            )
        if self._error is not None:
            raise self._error
        return self._value

    # -- timeline ------------------------------------------------------ #

    def stage_latencies_s(self) -> dict:
        """{queue, batch_wait, execute, total} seconds (None-safe:
        requests that were shed or errored mid-flight report what they
        have). ``queue_s`` (enqueue→admit), ``batch_wait_s``
        (admit→dispatch) and ``execute_s`` (dispatch→reply) partition
        ``total_s`` exactly — the invariant
        ``tools/tracereport.request_chains`` verifies per request."""
        out = {}
        if self.t_admit is not None:
            out["queue_s"] = self.t_admit - self.t_enqueue
        if self.t_admit is not None and self.t_execute is not None:
            out["batch_wait_s"] = self.t_execute - self.t_admit
        if self.t_execute is not None and self.t_reply is not None:
            out["execute_s"] = self.t_reply - self.t_execute
        if self.t_reply is not None:
            out["total_s"] = self.t_reply - self.t_enqueue
        return out


class RequestQueue:
    """Bounded FIFO with micro-batch extraction.

    ``max_depth`` bounds admission (excess submissions shed);
    ``max_batch``/``max_wait_ms`` shape the micro-batches
    :meth:`next_batch` hands the engine. ``drain_rate_hint`` (requests/s,
    updated by the engine from observed throughput) feeds the
    ``retry_after_s`` hint on shed. ``tenants`` (a list/dict of
    :class:`TenantSpec`) enables weighted-fair scheduling across tenant
    classes; omitted, the queue is the single implicit
    :data:`DEFAULT_TENANT` and behaves exactly as it always has.
    """

    def __init__(
        self,
        max_depth: int = 256,
        max_batch: int = 16,
        max_wait_ms: float = 5.0,
        tenants=None,
    ):
        if max_depth < 1 or max_batch < 1:
            raise ValueError("max_depth and max_batch must be >= 1")
        self.max_depth = int(max_depth)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.tenants: dict[str, TenantSpec] = _normalize_tenants(tenants)
        #: One FIFO per tenant class; total depth is what admission
        #: bounds.
        self._queues: dict[str, collections.deque[Request]] = {
            name: collections.deque() for name in self.tenants
        }
        #: Stride scheduling state: each dequeue advances the tenant's
        #: virtual pass by 1/weight; the batcher drains the non-empty
        #: tenant with the smallest pass.
        self._stride = {
            name: 1.0 / spec.weight for name, spec in self.tenants.items()
        }
        self._pass = {name: 0.0 for name in self.tenants}
        self._depth = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._ids = itertools.count()
        self._closed = False
        self.shed_count = 0
        self.submitted_count = 0
        self.tenant_shed = {name: 0 for name in self.tenants}
        self.tenant_submitted = {name: 0 for name in self.tenants}
        #: Engine-maintained throughput estimate for retry_after hints.
        self.drain_rate_hint: float = 0.0

    # ------------------------------------------------------------------ #
    # Client side
    # ------------------------------------------------------------------ #

    def submit(self, payload: Any, tenant: str = DEFAULT_TENANT) -> Request:
        """Admit one request (raises :class:`ShedError` when full, or
        ``RuntimeError`` after :meth:`close`). Admissions and sheds emit
        ``serve:enqueue`` / ``serve:shed`` trace events carrying the
        request id — the head of the request's trace chain. An unknown
        ``tenant`` raises ``ValueError`` — a typo'd class silently
        scheduled at default weight would defeat the QoS contract."""
        if tenant not in self.tenants:
            raise ValueError(
                f"unknown tenant {tenant!r}; declared: "
                f"{sorted(self.tenants)}"
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            if self._depth >= self.max_depth:
                self.shed_count += 1
                self.tenant_shed[tenant] += 1
                depth = self._depth
                rate = self.drain_rate_hint
                retry_after = (
                    depth / rate if rate > 0
                    else self.max_wait_ms / 1e3 * depth / self.max_batch
                )
                shed_id = next(self._ids)
            else:
                req = Request(next(self._ids), payload, tenant=tenant)
                req.t_enqueue = clock.now()
                q = self._queues[tenant]
                if not q:
                    # A tenant waking from idle must not replay the
                    # service it did not ask for: its pass catches up to
                    # the busiest tenants' floor instead of draining a
                    # backlog of virtual credit.
                    floor = min(
                        (self._pass[t] for t, d in self._queues.items()
                         if d), default=self._pass[tenant],
                    )
                    self._pass[tenant] = max(self._pass[tenant], floor)
                q.append(req)
                self._depth += 1
                self.submitted_count += 1
                self.tenant_submitted[tenant] += 1
                depth = self._depth
                self._not_empty.notify()
                shed_id = None
        if shed_id is not None:
            obs_trace.event("serve:shed", req=shed_id, depth=depth,
                            tenant=tenant,
                            retry_after_s=round(retry_after, 6))
            raise ShedError(
                f"queue full ({depth}/{self.max_depth}); "
                f"retry after ~{retry_after:.3f}s",
                retry_after_s=retry_after,
            )
        if obs_trace.enabled():
            obs_trace.event("serve:enqueue", req=req.req_id, depth=depth,
                            tenant=tenant)
        return req

    def depth(self) -> int:
        with self._lock:
            return self._depth

    # ------------------------------------------------------------------ #
    # Engine side
    # ------------------------------------------------------------------ #

    def next_batch(self, timeout_s: Optional[float] = None) -> list[Request]:
        """Block for the next micro-batch.

        Returns as soon as ``max_batch`` requests are waiting, or
        ``max_wait_ms`` after the FIRST request of the batch arrived —
        the arrival of request #1 starts the clock, so a lone request
        pays at most ``max_wait_ms`` of batching latency. Returns ``[]``
        on ``timeout_s`` with nothing queued, or when closed and empty.

        Batch membership is stride-scheduled across tenant classes:
        each slot goes to the non-empty tenant with the smallest
        virtual pass (advanced by ``1/weight`` per dequeue), FIFO
        within a tenant — weighted-fair service over any busy window,
        exact FIFO with a single tenant.
        """
        deadline = (
            clock.now() + timeout_s if timeout_s is not None else None
        )
        with self._not_empty:
            while not self._depth:
                if self._closed:
                    return []
                remaining = None
                if deadline is not None:
                    remaining = deadline - clock.now()
                    if remaining <= 0:
                        return []
                self._not_empty.wait(remaining)
            # First arrival in hand: linger up to max_wait_ms for peers.
            batch_deadline = (
                min(q[0].t_enqueue for q in self._queues.values() if q)
                + self.max_wait_ms / 1e3
            )
            while (
                self._depth < self.max_batch
                and not self._closed
            ):
                linger = batch_deadline - clock.now()
                if linger <= 0:
                    break
                self._not_empty.wait(linger)
            batch = []
            while self._depth and len(batch) < self.max_batch:
                tenant = min(
                    (t for t, q in self._queues.items() if q),
                    key=lambda t: (self._pass[t], t),
                )
                batch.append(self._queues[tenant].popleft())
                self._pass[tenant] += self._stride[tenant]
                self._depth -= 1
        t_admit = clock.now()
        for req in batch:
            req.t_admit = t_admit
        return batch

    def close(self) -> None:
        """Stop admitting; wake any blocked :meth:`next_batch`. Requests
        already queued remain drainable."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
