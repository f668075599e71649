"""Shadow execution: validate a challenger ladder on mirrored traffic
(counterpart of ``tuner/shadow.py``).

A challenger that measured well is not yet trusted with users: the
serving contract is replies equal bit for bit, and the only evidence for
that is the challenger answering real requests with the incumbent's
bytes. The protocol:

1. **Build off the request path** (:meth:`ShadowSession.warm`): one cell
   a ladder cell, each run once on an all-padding batch, on the tuner's
   thread and stream, so a promotion swaps in cells that have run. The
   cells' keys carry the challenger's variant (``program_key``'s
   ``v<variant>`` segment), so they never alias the incumbent's.
2. **Mirror** (:meth:`offer`): the runner hands each answered group
   (payloads and the replies sent) to the session after the replies are
   out: a modulo and at most one bounded append on the request path. A
   full queue drops the sample.
3. **Replay and compare** (:meth:`drain`, the tuner's thread): each group
   padded into the incumbent's cell, dispatched through the challenger's
   cell, its replies held to the sent ones bit for bit. A mismatch (or a
   replay that raises) poisons the session: no promotion, a flight record
   when the recorder is armed, the detail kept for the record. The fault
   site of the replay is ``output:tunerShadow``.

What a swap changes today: the serve cells (``ops/serve_kernels.py``)
read only the model's factors or context, not the strategy's variant, so
a challenger's cells compute what the incumbent's do and the compare
passes when nothing else is wrong. The swap restamps the variant (keys,
records, scrapes), the model's plan and the plan cache the next replica
warms from. The compare is still the gate: it holds whatever the
challenger's cells dispatch, and a corrupted replay is caught here.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional

import numpy as np
import torch

from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.obs import log as obs_log
from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics
from distributed_sddmm_tpu_torch.obs import trace as obs_trace
from distributed_sddmm_tpu_torch.resilience import faults


class StaleChallenger(ValueError):
    """A challenger whose variant this code cannot rebuild: refused before
    it shadows, long before any swap."""


def _reply_equal(a: dict, b: dict) -> bool:
    """Replies equal bit for bit: the same keys, every field of the same
    shape, type and bytes; a NaN anywhere is a mismatch (what the
    corruption faults inject)."""
    if set(a) != set(b):
        return False
    for k, va in a.items():
        va_arr, vb_arr = np.asarray(va), np.asarray(b[k])
        if va_arr.shape != vb_arr.shape or va_arr.dtype != vb_arr.dtype:
            return False
        if va_arr.dtype.kind == "f" and (np.any(np.isnan(va_arr)) or np.any(np.isnan(vb_arr))):
            return False
        if not np.array_equal(va_arr, vb_arr):
            return False
    return True


def tuner_stream(device):
    """A CUDA stream of the tuner's own on ``device`` (None on the CPU)."""
    dev = torch.device(device)
    return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None


@contextlib.contextmanager
def on_stream(device, stream):
    """``device`` current and ``stream`` its current stream for the
    calling thread (nothing on the CPU): what runs here never lands on the
    runner's stream."""
    if stream is None:
        yield
        return
    with torch.cuda.device(torch.device(device)), torch.cuda.stream(stream):
        yield


class ShadowSession:
    """One challenger's validation on mirrored traffic."""

    #: The replay's fault site (``output:tunerShadow``): tests corrupt the
    #: challenger's outputs here to show that a mismatch blocks promotion
    #: without touching a live reply.
    OP = "tunerShadow"

    def __init__(self, engine, variant: Optional[str], max_pending: int = 32,
                 sample_every: int = 1, stream=None):
        self.engine = engine
        self.variant = variant
        self._validate_variant()
        #: The stream the session's cells run on (the tuner's; its own when
        #: None on the card).
        self.stream = stream if stream is not None else tuner_stream(engine.device)
        self.t_start = clock.now()
        self.sample_every = max(int(sample_every), 1)
        self._seen = 0
        self._pending: collections.deque = collections.deque(maxlen=max_pending)
        self._lock = threading.Lock()
        #: The challenger's cell per (batch bucket, inner bucket).
        self.programs: dict[tuple[int, int], object] = {}
        self.live_compiles = 0
        self.replays = 0
        self.ok = 0
        self.mismatches = 0
        self.dropped = 0
        self.mismatch_detail: Optional[dict] = None
        self.warmed = False

    def _validate_variant(self) -> None:
        if self.variant is None:
            return
        from distributed_sddmm_tpu_torch.codegen.variants import variant_from_id

        try:
            variant_from_id(self.variant)
        except ValueError as e:
            raise StaleChallenger(f"challenger variant {self.variant!r} is not "
                                  f"reconstructible by this code generation: {e}") from e

    def _run(self, prog, args) -> tuple:
        """One cell call on the session's stream, its outputs on the host."""
        with on_stream(self.engine.device, self.stream):
            out = faults.corrupt_outputs(f"output:{self.OP}", prog(*args))
            if self.stream is not None:
                self.stream.synchronize()
            return tuple(t.cpu() for t in out)

    # ------------------------------------------------- building off the path

    def warm(self) -> int:
        """Build and run every ladder cell once on an all-padding batch, on
        the calling (tuner) thread and the session's stream. Returns the
        cells built; a promotion after this builds nothing."""
        engine, workload = self.engine, self.engine.workload
        n = 0
        with obs_trace.span("tuner:shadow_warm", variant=self.variant or "generic",
                            cells=len(engine.batch_buckets) * len(workload.inner_buckets)):
            for bb in engine.batch_buckets:
                for ib in workload.inner_buckets:
                    with on_stream(engine.device, self.stream):
                        prog = workload.build_program(bb, ib)
                        out = prog(*workload.pad_batch([], bb, ib))
                        if self.stream is not None:
                            self.stream.synchronize()
                        for t in out:
                            t.cpu()
                    self.programs[(bb, ib)] = prog
                    self.live_compiles += 1
                    n += 1
        self.warmed = True
        obs_log.info("tuner", "challenger ladder warmed off-path", cells=n,
                     variant=self.variant, live_compiles=self.live_compiles)
        return n

    # ------------------------------------------------- the mirror (request path)

    def offer(self, payloads: list[dict], replies: list[dict], batch_bucket: int,
              inner_bucket: int) -> None:
        """The runner's hook: keep one answered group for replay (sampled
        and bounded here, so the request path pays a modulo and at most an
        append)."""
        self._seen += 1
        if (self._seen - 1) % self.sample_every:
            return
        with self._lock:
            if len(self._pending) == self._pending.maxlen:
                self.dropped += 1
                return
            self._pending.append((list(payloads), list(replies), batch_bucket, inner_bucket))

    # ------------------------------------------------- replay (tuner thread)

    def drain(self, max_replays: Optional[int] = None) -> int:
        """Replay the pending groups through the challenger's cells; returns
        the groups replayed. The first mismatch stops the replay: one bad
        bit is a verdict."""
        if not self.warmed:
            return 0
        done = 0
        while self.mismatches == 0:
            if max_replays is not None and done >= max_replays:
                break
            with self._lock:
                if not self._pending:
                    break
                payloads, replies, bb, ib = self._pending.popleft()
            self._replay(payloads, replies, bb, ib)
            done += 1
        return done

    def _replay(self, payloads: list[dict], replies: list[dict], bb: int, ib: int) -> None:
        workload = self.engine.workload
        prog = self.programs.get((bb, ib))
        if prog is None:
            # A cell the incumbent served that the challenger lacks: promoting
            # a partial ladder would build on the request path.
            self._mismatch(bb, ib, reason="missing_cell")
            return
        try:
            with obs_trace.span("tuner:shadow_replay", batch_bucket=bb, inner_bucket=ib,
                                batch=len(payloads)):
                out = self._run(prog, workload.pad_batch(payloads, bb, ib))
                challenger = workload.unpad(out, payloads)
        except Exception as e:  # noqa: BLE001 -- a raising challenger disqualifies too
            self._mismatch(bb, ib, reason="replay_error", error=f"{type(e).__name__}: {e}")
            return
        self.replays += 1
        obs_metrics.GLOBAL.add("tuner_shadow_replays")
        for i, (inc, ch) in enumerate(zip(replies, challenger)):
            if not _reply_equal(inc, ch):
                self._mismatch(bb, ib, reason="reply_diverged", index=i)
                return
        self.ok += len(payloads)

    def _mismatch(self, bb: int, ib: int, **detail) -> None:
        """Poison the session: count, trace, and dump a flight record when
        the recorder is armed."""
        from distributed_sddmm_tpu_torch.obs import flightrec

        self.mismatches += 1
        info = {"batch_bucket": bb, "inner_bucket": ib, "variant": self.variant, **detail}
        fr = flightrec.active()
        if fr is not None:
            path = fr.dump("tuner_shadow_mismatch", self.OP, info)
            if path:
                info["snapshot_path"] = path
        self.mismatch_detail = info
        obs_metrics.GLOBAL.add("tuner_shadow_mismatches")
        obs_trace.event("tuner_shadow_mismatch", **info)
        obs_log.error("tuner", "shadow mismatch: the challenger will not be promoted",
                      **{k: str(v) for k, v in info.items()})

    def clean(self, min_samples: int) -> bool:
        """At least ``min_samples`` replies equal and no mismatch."""
        return self.mismatches == 0 and self.ok >= min_samples

    def stats(self) -> dict:
        with self._lock:
            return {"variant": self.variant, "cells": len(self.programs),
                    "replays": self.replays, "ok": self.ok, "mismatches": self.mismatches,
                    "dropped": self.dropped, "pending": len(self._pending),
                    "live_compiles": self.live_compiles,
                    "mismatch_detail": self.mismatch_detail}
