"""The serving engine: warm model, bucketed program ladder, runner thread
(counterpart of ``serve/engine.py``).

One engine serves one workload (``serve/workloads.py``) from one warm
model. The execution contract:

* **Bucket ladder.** Every micro-batch is padded to a ``(batch_bucket,
  inner_bucket)`` cell of two small power-of-two ladders, so every request
  dispatches into a program built ahead: :meth:`warmup` builds and runs
  the whole ladder before the first request. A cell's program is the bound
  kernel call of ``ops/serve_kernels.py``; its key is the JAX package's
  (``programs/keys.py::serve_program_key``: workload, cell, R, backend,
  ``serve_code_hash``, constants, variant, wire, capacity), so a stale
  program never serves a new code generation. A cell has no compiled
  artifact, so nothing of it goes to the program store; the model's
  set-up comes from the store through ``Plan.instantiate``.
* **Determinism across batching.** A micro-batch is split into groups by
  inner bucket, each group padded with zero-masked rows; the kernels
  compute every request row on its own, in a fixed order. A reply is a
  function of its payload alone: not of arrival order, micro-batch
  composition or padding (pinned by ``tests/test_torch_serve.py`` on the
  CPU and by ``chip_smoke.py`` on the card).
* **Resilience ladder** (the rungs of ``parallel/base._resilient_call``):
  fault hooks fire at ``execute:serveBatch`` / ``output:serveBatch``, a
  call runs under a per-batch timeout with bounded retries, guarded
  outputs retry on NaN/Inf. A CUDA launch cannot be cancelled, so every
  attempt writes into outputs of its own, and a retry never shares a
  buffer with a late kernel. A batch that exhausts its retries degrades,
  on the CPU, to the workload's host-serial answer per request; on the
  card there is no host rung, as ALS has none (``models/als.py``): each of
  its requests gets a :class:`~distributed_sddmm_tpu_torch.serve.queue.
  RequestError` carrying a ``NumericalFault``, counted in
  ``error_batches``. The engine answers or sheds; it does not die.
* **The card.** The runner thread enters the engine's device
  (``torch.cuda.device``) and launches on its current stream; replies are
  copied to the host after that stream's synchronise.
* **Observability**: ``serve:batch`` spans and per-request reply events
  through ``obs.trace``, queue depth and occupancy into the
  :class:`~distributed_sddmm_tpu_torch.serve.slo.LatencyRecorder`, and the
  watchdog's ``queue_runaway`` hook on every admission. The telemetry
  sampler and the admin server read the engine through
  ``obs/telemetry.py::engine_snapshot`` (host state only).
* **The tuner's hooks** (``tuner/``): :meth:`attach_mirror` hands every
  answered group to a shadow session after its replies are out, and
  :meth:`swap_ladder` swaps the whole ladder for cells the tuner built and
  ran off the request path. ``live_compiles`` counts the cells built in
  :meth:`_program`: after warm-up it stays put, swap or none.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.obs import log as obs_log
from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics
from distributed_sddmm_tpu_torch.obs import trace as obs_trace
from distributed_sddmm_tpu_torch.obs import watchdog as obs_watchdog
from distributed_sddmm_tpu_torch.resilience import faults
from distributed_sddmm_tpu_torch.resilience.guards import NumericalFault
from distributed_sddmm_tpu_torch.serve.queue import (
    DEFAULT_TENANT, Request, RequestError, RequestQueue, ShedError,
)
from distributed_sddmm_tpu_torch.serve.slo import LatencyRecorder
from distributed_sddmm_tpu_torch.serve.workloads import ServingWorkload, bucket_for
from distributed_sddmm_tpu_torch.utils.buckets import pow2_ladder

#: Per-batch wall-clock bound in seconds (0: none) and retries a batch
#: gets, unless the constructor names them.
SERVE_TIMEOUT_ENV = "SDDMM_TORCH_SERVE_TIMEOUT"
SERVE_RETRIES_ENV = "SDDMM_TORCH_SERVE_RETRIES"


class ServingEngine:
    """Request/response execution over a warm model.

    ``exec_timeout_s``/``exec_retries`` bound one micro-batch dispatch
    (defaults from ``SDDMM_TORCH_SERVE_TIMEOUT`` /
    ``SDDMM_TORCH_SERVE_RETRIES``); past the retry budget a batch degrades
    to the workload's serial answer on the CPU, and fails its requests on
    the card.
    """

    #: Fault-injection site names (the ``execute:*`` / ``output:*``
    #: namespaces of offline dispatch, so one fault spec covers both).
    OP = "serveBatch"

    def __init__(self, workload: ServingWorkload, max_batch: int = 8, max_depth: int = 64,
                 max_wait_ms: float = 5.0, batch_buckets: Optional[tuple[int, ...]] = None,
                 exec_timeout_s: Optional[float] = None, exec_retries: Optional[int] = None,
                 recorder: Optional[LatencyRecorder] = None, tenants=None):
        self.workload = workload
        self.queue = RequestQueue(max_depth=max_depth, max_batch=max_batch,
                                  max_wait_ms=max_wait_ms, tenants=tenants)
        self.batch_buckets = tuple(sorted(batch_buckets or pow2_ladder(max_batch)))
        self.exec_timeout_s = (float(os.environ.get(SERVE_TIMEOUT_ENV, "0"))
                               if exec_timeout_s is None else float(exec_timeout_s))
        self.exec_retries = (int(os.environ.get(SERVE_RETRIES_ENV, "1"))
                             if exec_retries is None else int(exec_retries))
        self.recorder = recorder if recorder is not None else LatencyRecorder()
        dev = torch.device(workload.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

        self._programs: dict[str, object] = {}
        #: (batch_bucket, inner_bucket) -> program: the key pins the ladder
        #: to a code generation at build; backend and serve_code_hash do
        #: not change within a process, so dispatch looks up by cell.
        self._cell_programs: dict[tuple[int, int], object] = {}
        self._cache_lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        #: Cells built in this process (every cell: none comes from a store).
        self.live_compiles = 0
        self.served = 0
        self.degraded_batches = 0
        #: Batches that failed past every rung on the card (their requests
        #: got a RequestError).
        self.error_batches = 0
        #: True once :meth:`warmup` has built and run the whole ladder (the
        #: admin server's ``/readyz``).
        self.warmed = False
        #: True once :meth:`start` ran: ``/healthz`` tells "not started yet"
        #: (alive, warming) from "the runner died".
        self.ever_started = False
        #: The mirror hook (:meth:`attach_mirror`); None: no shadow session.
        self._mirror = None
        #: Ladders swapped in (tuner promotions).
        self.ladder_swaps = 0
        #: Set by an attached ``tuner.BackgroundTuner`` (the snapshot reads it).
        self.tuner = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: Structure changes bound into this engine (:meth:`rebind_structure`).
        self.structure_rebinds = 0

    # ------------------------------------------------------------------ #
    # The program ladder
    # ------------------------------------------------------------------ #

    #: ``program_key``'s default variant: the workload's current one (an
    #: explicit None is the generic key).
    _WORKLOAD_VARIANT = object()

    def program_key(self, batch_bucket: int, inner_bucket: int, sig: str | None = None,
                    variant=_WORKLOAD_VARIANT) -> str:
        """The ladder cell's key: the JAX package's grammar, the device
        type for the backend. ``variant`` overrides the workload's: the
        tuner keys a challenger's cells so."""
        from distributed_sddmm_tpu_torch.programs import keys as program_keys

        if variant is ServingEngine._WORKLOAD_VARIANT:
            variant = getattr(self.workload, "kernel_variant", None)
        r = getattr(self.workload, "R", getattr(self.workload, "_F", 0))
        return program_keys.serve_program_key(
            self.workload.name, batch_bucket, inner_bucket, r, self.device.type,
            params=self.workload.program_params(), sig=sig, variant=variant,
            wire=getattr(self.workload, "wire", None),
            cap=getattr(self.workload, "capacity_segment", None),
            dist=program_keys.dist_segment())

    def _program(self, batch_bucket: int, inner_bucket: int):
        cell = (batch_bucket, inner_bucket)
        with self._cache_lock:
            prog = self._cell_programs.get(cell)
            if prog is not None:
                self.cache_hits += 1
                return prog
            self.cache_misses += 1
        key = self.program_key(batch_bucket, inner_bucket)
        prog = self.workload.build_program(batch_bucket, inner_bucket)
        with self._cache_lock:
            self.live_compiles += 1
            prog = self._programs.setdefault(key, prog)
            self._cell_programs[cell] = prog
        return prog

    def _on_device(self):
        """The engine's device as the calling thread's current one (the
        launches' device and stream); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def warmup(self) -> int:
        """Build and run every ladder cell once with an all-padding batch,
        so no live request pays a build. Returns the programs warmed."""
        n = 0
        with obs_trace.span("serve:warmup", workload=self.workload.name,
                            cells=len(self.batch_buckets) * len(self.workload.inner_buckets)):
            with self._on_device():
                for bb in self.batch_buckets:
                    for ib in self.workload.inner_buckets:
                        prog = self._program(bb, ib)
                        for t in prog(*self.workload.pad_batch([], bb, ib)):
                            t.cpu()
                        n += 1
        self.warmed = True
        obs_log.info("serve", "warmup complete", programs=n,
                     batch_buckets=list(self.batch_buckets),
                     inner_buckets=list(self.workload.inner_buckets))
        return n

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #

    def start(self, warmup: bool = True) -> "ServingEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        if warmup:
            self.warmup()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"serve-{self.workload.name}")
        # Set once the runner exists: the admin server is up through warm-up,
        # and /healthz reads that window as alive.
        self.ever_started = True
        self._thread.start()
        return self

    def runner_alive(self) -> bool:
        """``/healthz``: the runner exists and runs (False before
        :meth:`start`, after :meth:`stop`, and after the runner's death)."""
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Close admission; drain the queued requests (unless ``drain`` is
        False), then stop the runner."""
        self.queue.close()
        if not drain:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None

    # ------------------------------------------------------------------ #
    # Client surface
    # ------------------------------------------------------------------ #

    def submit(self, payload: dict, tenant: str = DEFAULT_TENANT) -> Request:
        """Admit one request (sheds with ``ShedError`` at depth). ``tenant``
        must be a class declared at construction."""
        wd = obs_watchdog.active()
        if wd is not None:
            # Before admission: a strict-mode runaway alarm must shed this
            # request while it can still be refused.
            try:
                wd.observe_queue(self.queue.depth(), self.queue.max_depth)
            except NumericalFault:
                self.recorder.record_shed(tenant)
                obs_metrics.GLOBAL.add("serve_shed")
                raise ShedError("queue runaway (watchdog strict)",
                                retry_after_s=self.queue.max_wait_ms / 1e3) from None
        try:
            return self.queue.submit(self.workload.clamp(payload), tenant=tenant)
        except ShedError:
            self.recorder.record_shed(tenant)
            obs_metrics.GLOBAL.add("serve_shed")
            raise

    def serve_one(self, payload: dict, timeout_s: float = 30.0) -> dict:
        """Submit and wait."""
        return self.submit(payload).result(timeout_s=timeout_s)

    def execute_now(self, payloads: list[dict]) -> list[dict]:
        """Run payloads through the runner's pad/program path at once (no
        queue, no recorder, no degrade rung): the reference the batching
        determinism checks hold batched replies to."""
        payloads = [self.workload.clamp(p) for p in payloads]
        replies: dict[int, dict] = {}
        with self._on_device():
            for ib, idxs in self._group_by_inner(payloads).items():
                group = [payloads[i] for i in idxs]
                out = self._dispatch(group, bucket_for(len(group), self.batch_buckets), ib)
                for i, reply in zip(idxs, out):
                    replies[i] = reply
        return [replies[i] for i in range(len(payloads))]

    # ------------------------------------------------------------------ #
    # Runner
    # ------------------------------------------------------------------ #

    def _run(self) -> None:
        with self._on_device():
            while not self._stop.is_set():
                batch = self.queue.next_batch(timeout_s=0.25)
                if not batch:
                    if self.queue.closed and self.queue.depth() == 0:
                        return
                    continue
                try:
                    self._serve_batch(batch)
                except Exception as e:  # noqa: BLE001 -- the loop must survive
                    obs_log.error("serve", "batch failed past every rung",
                                  error=f"{type(e).__name__}: {e}")
                    for req in batch:
                        if not req.done():
                            req.set_error(RequestError(str(e), cause=e))

    def _group_by_inner(self, payloads: list[dict]) -> dict[int, list[int]]:
        """Indices grouped by inner bucket: a request's inner shape is a
        function of its own payload (the determinism contract)."""
        groups: dict[int, list[int]] = {}
        for i, p in enumerate(payloads):
            ib = bucket_for(self.workload.inner_size(p), self.workload.inner_buckets)
            groups.setdefault(ib, []).append(i)
        return groups

    def _serve_batch(self, batch: list[Request]) -> None:
        t_batch = clock.now()
        depth_now = self.queue.depth()
        payloads = [req.payload for req in batch]
        answered_idx: list[int] = []
        wd = obs_watchdog.active()

        for ib, idxs in self._group_by_inner(payloads).items():
            group = [payloads[i] for i in idxs]
            reqs = [batch[i] for i in idxs]
            bb = bucket_for(len(group), self.batch_buckets)
            self.recorder.record_batch(len(group), bb, depth_now)
            t0 = clock.now()
            for req in reqs:
                # A group's own dispatch: a later group's execute_s must not
                # absorb an earlier group's.
                req.t_execute = t0
            with obs_trace.span("serve:batch", workload=self.workload.name, batch=len(group),
                                batch_bucket=bb, inner_bucket=ib, depth=depth_now,
                                req_ids=[r.req_id for r in reqs]) as sp:
                try:
                    replies = self._dispatch(group, bb, ib, span=sp)
                    degraded = False
                except Exception as e:  # noqa: BLE001 -- the last rung
                    replies, degraded = self._last_rung(group, e)
                    sp.set(degraded=degraded, failed=not degraded)
            for i, req, reply in zip(idxs, reqs, replies):
                if isinstance(reply, BaseException):
                    req.set_error(reply)
                    continue
                if reply is None:  # the serial rung failed too
                    req.set_error(RequestError(
                        "no reply: the batch's kernels and the serial fallback both failed"))
                    continue
                req.degraded = degraded
                req.set_result(reply)
                answered_idx.append(i)
                if obs_trace.enabled():
                    # The request's own stamps, trace-relative: the event's
                    # ``t`` can lag set_result by a scheduling delay.
                    obs_trace.event(
                        "serve:reply", req=req.req_id, degraded=degraded,
                        t_enqueue=obs_trace.rel_time(req.t_enqueue),
                        t_reply=obs_trace.rel_time(req.t_reply),
                        **{k: round(v, 6) for k, v in req.stage_latencies_s().items()})
            self.served += len(group)
            mirror = self._mirror
            if mirror is not None and not degraded and all(
                    r is not None and not isinstance(r, BaseException) for r in replies):
                # After the replies are out; a degraded group's replies are
                # not the cells' bits, so they are not offered.
                try:
                    mirror(group, replies, bb, ib)
                except Exception as e:  # noqa: BLE001 -- a best-effort tap
                    obs_log.warn("serve", "mirror hook failed", error=f"{type(e).__name__}: {e}")
            if wd is not None:
                try:
                    wd.observe(f"serve:{self.workload.name}", clock.now() - t0)
                except NumericalFault as alarm:
                    # Strict mode: the anomaly is recorded; serving answers
                    # it by shedding upstream, not by the runner's death.
                    obs_log.warn("serve", "watchdog alarm in runner", error=str(alarm))

        # Ingest and the drain-rate hint, after the replies are out: the
        # answered payloads only, in admission order.
        if answered_idx:
            try:
                self.workload.ingest([payloads[i] for i in sorted(answered_idx)])
            except Exception as e:  # noqa: BLE001 -- ingest is best-effort
                obs_log.warn("serve", "online ingest failed", error=f"{type(e).__name__}: {e}")
        dt = clock.now() - t_batch
        if dt > 0:
            inst = len(batch) / dt
            self.queue.drain_rate_hint = (0.8 * self.queue.drain_rate_hint + 0.2 * inst
                                          if self.queue.drain_rate_hint else inst)

    # ------------------------------------------------------------------ #
    # The resilience ladder around one dispatch
    # ------------------------------------------------------------------ #

    def _dispatch(self, group: list[dict], batch_bucket: int, inner_bucket: int,
                  span=None) -> list[dict]:
        from distributed_sddmm_tpu_torch.resilience import guards
        from distributed_sddmm_tpu_torch.resilience.retry import Backoff, retry_call

        prog = self._program(batch_bucket, inner_bucket)
        t_pad0 = clock.now()
        args = self.workload.pad_batch(group, batch_bucket, inner_bucket)
        if span is not None:
            # The padding's share of the dispatch window.
            span.set(pad_s=round(clock.now() - t_pad0, 9))

        def attempt():
            # A timed attempt runs on a thread of its own: enter the device
            # there too. Outputs are the call's own.
            with self._on_device():
                faults.maybe_raise(f"execute:{self.OP}")
                out = faults.corrupt_outputs(f"output:{self.OP}", prog(*args))
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                if guards.enabled():
                    # raise mode trips the retry; repair mode nan_to_nums.
                    out = guards.guard_output(self.OP, out)
                return tuple(t.cpu() for t in out)

        def on_retry(i: int, err: BaseException) -> None:
            obs_metrics.GLOBAL.add("exec_retries")
            obs_trace.event("retry", op=self.OP, attempt=i, error=type(err).__name__)

        out = retry_call(attempt, retries=self.exec_retries, timeout_s=self.exec_timeout_s,
                         backoff=Backoff(base_s=0.02, max_delay_s=0.5),
                         retry_on=(TimeoutError, MemoryError, NumericalFault, faults.FaultError),
                         label=f"execute:{self.OP}", on_retry=on_retry)
        return self.workload.unpad(out, group)

    def _last_rung(self, group: list[dict], cause: BaseException) -> tuple[list, bool]:
        """The batch's answer past its retries: ``(replies, degraded)``. On
        the CPU the host-serial answer per request (None where it fails
        too); on the card a ``RequestError`` per request carrying a
        ``NumericalFault``: the card's failure is not the host's to answer."""
        if self.device.type == "cpu":
            return self._degrade(group, cause), True
        fault = NumericalFault(
            f"serve batch of {len(group)} failed on {self.device} past "
            f"{self.exec_retries} retries ({type(cause).__name__}: {cause}); no host "
            "fallback runs for an engine on the card")
        fault.__cause__ = cause
        self.error_batches += 1
        obs_metrics.GLOBAL.add("serve_error_batches")
        obs_trace.event("serve_batch_failed", workload=self.workload.name,
                        cause=type(cause).__name__, batch=len(group))
        obs_log.error("serve", "batch failed on the card", cause=f"{type(cause).__name__}: "
                      f"{cause}", batch=len(group))
        return [RequestError(str(fault), cause=fault) for _ in group], False

    def _degrade(self, group: list[dict], cause: BaseException) -> list:
        """The CPU engine's last rung: the host-serial answer per request;
        a request whose answer fails too gets None (a typed error)."""
        self.degraded_batches += 1
        obs_metrics.GLOBAL.add("serve_degraded_batches")
        obs_trace.event("serve_degraded", workload=self.workload.name,
                        cause=type(cause).__name__, batch=len(group))
        obs_log.warn("serve", "batch degraded to serial fallback",
                     cause=f"{type(cause).__name__}: {cause}", batch=len(group))
        replies = []
        for payload in group:
            try:
                replies.append(self.workload.serial(payload))
            except Exception as e:  # noqa: BLE001 -- a per-request error
                replies.append(None)
                obs_log.error("serve", "serial fallback failed", error=f"{type(e).__name__}: {e}")
        return replies

    # ------------------------------------------------------------------ #
    # The tuner's hooks (tuner/)
    # ------------------------------------------------------------------ #

    def attach_mirror(self, mirror) -> None:
        """Arm the request mirror: the runner calls ``mirror(payloads,
        replies, batch_bucket, inner_bucket)`` for every answered group
        that did not degrade (a shadow session's ``offer``). One at a time;
        a second replaces the first."""
        self._mirror = mirror

    def detach_mirror(self) -> None:
        self._mirror = None

    def swap_ladder(self, cell_programs: dict, variant) -> None:
        """Swap the ladder for the tuner's challenger cells, its promotion.

        Under the cache lock: a dispatch in flight finishes on the cell it
        resolved, the next lookup takes the challenger's. ``cell_programs``
        must cover every cell and have run once already (the shadow session
        builds and runs them off the request path): a ladder missing a
        cell is refused, since the request path would build it. The
        workload's ``kernel_variant`` takes the challenger's id, so the
        record and the keys name what serves."""
        cells = {(bb, ib) for bb in self.batch_buckets for ib in self.workload.inner_buckets}
        missing = cells - set(cell_programs)
        if missing:
            raise ValueError(f"challenger ladder is missing cells {sorted(missing)}; "
                             "promoting it would build on the request path")
        if variant is not None:
            from distributed_sddmm_tpu_torch.codegen.variants import variant_from_id

            variant_from_id(variant)  # a stale id raises here too
        keyed = {self.program_key(bb, ib, variant=variant): prog
                 for (bb, ib), prog in cell_programs.items()}
        with self._cache_lock:
            self._cell_programs = {cell: cell_programs[cell] for cell in cells}
            self._programs = keyed
            self.workload.kernel_variant = variant
            self.ladder_swaps += 1
        obs_trace.event("serve_ladder_swap", workload=self.workload.name, variant=variant,
                        cells=len(cells))
        obs_log.info("serve", "bucket ladder hot-swapped", variant=variant, cells=len(cells),
                     swaps=self.ladder_swaps)

    # ------------------------------------------------------------------ #

    def rebind_structure(self, *args, **kw) -> dict:
        """Bind a mutated structure into the live ladder through the
        workload's ``rebind_structure`` hook. On a fit the ladder keeps
        serving untouched (structure rides in as program arguments); on a
        spill the stale cells are dropped and the ladder re-warms at the
        new capacity, off the request path like any warmup. Returns the
        hook's report (``{"fit": bool, ...}``)."""
        hook = getattr(self.workload, "rebind_structure", None)
        if hook is None:
            raise ValueError(f"workload {self.workload.name!r} has no structure rebind hook")
        report = hook(*args, **kw)
        with self._cache_lock:
            self.structure_rebinds += 1
        if not report.get("fit", True):
            with self._cache_lock:
                self._cell_programs.clear()
                self._programs.clear()
                self.warmed = False
            self.warmup()
        obs_trace.event("serve_structure_rebind", workload=self.workload.name,
                        fit=bool(report.get("fit", True)))
        return report

    def stats(self) -> dict:
        with self._cache_lock:
            return {
                "programs": len(self._programs),
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "live_compiles": self.live_compiles,
                "served": self.served,
                "degraded_batches": self.degraded_batches,
                "error_batches": self.error_batches,
                "ladder_swaps": self.ladder_swaps,
                "structure_rebinds": self.structure_rebinds,
                "queue_shed": self.queue.shed_count,
            }
