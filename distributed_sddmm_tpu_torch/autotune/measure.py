"""Short measured trials of candidate plans, with timeout and backoff
(counterpart of ``autotune/measure.py``).

The analytic models are first-order; when the device is healthy, a few
short trials of the candidate's own strategy (fused pairs, each timed
alone, the fastest counted: :func:`default_trial`) beat any model. Every trial runs under a per-trial timeout
(``resilience.retry.call_with_timeout``) with retries and jittered
exponential backoff under an elapsed cap; a candidate whose attempts all
fail is dropped, and when every candidate drops the caller
(``plan.get_plan``) falls back to the cost model's ranking. The trial
function is injectable (``trial_fn``), so tests simulate timeouts and
count attempts without a device. Trials run with the run store hidden
(``obs/store.py::suppressed``): they are probes, not runs.

**A timed-out trial on the card.** ``call_with_timeout`` abandons the
trial's thread, and nothing can cancel the kernels and allocations that
thread has queued: they run on and would be timed into the next trial.
So on a CUDA device (``stop_on_timeout``, the default there) a timeout
drops its candidate, retries nothing and ends the measuring: the plan
comes from the trials that finished before it, else from the model. The
trial itself sets its thread's device explicitly, and times each pair
between CUDA events on its thread's current stream, so work queued before
its start event is not counted.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, Optional

from distributed_sddmm_tpu_torch.autotune.candidates import Candidate
from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.obs import metrics, trace
from distributed_sddmm_tpu_torch.obs import store as obs_store
from distributed_sddmm_tpu_torch.resilience.retry import (
    Backoff, CallTimeout, call_with_timeout,
)

_LOG = logging.getLogger(__name__)


class MeasureTimeout(CallTimeout):
    """One measured trial exceeded its wall-clock budget."""


def _build_kernel(cand: Candidate, device=None):
    """The kernel a candidate names: the plain ``torch`` kernel (with its
    segment budget), the banked CUDA kernel of its variant, or the CUDA
    tile kernel, at the family's precision. A variant id this code does
    not know raises ``ValueError``: nothing falls back to the generic
    kernel quietly."""
    from distributed_sddmm_tpu_torch.codegen import make_banked_kernel
    from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
    from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel

    if cand.kernel == "torch":
        return TorchKernel(gather_budget=cand.gather_budget)
    precision = cand.kernel.removeprefix("cuda-")
    if cand.variant:
        return make_banked_kernel(cand.variant, precision=precision, device=device)
    return CudaTileKernel(precision, device=device)


def default_trial(S, problem: Problem, cand: Candidate, trials: int, warmup: int,
                  device=None, world=None) -> dict:
    """The measured (``wall``) trial: the candidate's strategy (its kernel
    through :func:`_build_kernel`), ``warmup`` then ``trials`` fused pairs
    on dummy operands, each between CUDA events on the calling thread's
    current stream (the host clock on the CPU), so a trial never
    synchronises the device and can run beside a live runner on a stream
    of its own. The fastest pair counts: a pair that the host held up (a
    live replica's runner and load share it) says nothing of the
    candidate. Returns a harness-shaped record (``overall_throughput`` in
    GFLOP/s) with every pair's ms in order. A kernel that does not build
    raises: the candidate is dropped, never answered by another."""
    import torch

    from distributed_sddmm_tpu_torch.bench import harness
    from distributed_sddmm_tpu_torch.common import MatMode

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev)
    alg = harness.make_algorithm(cand.algorithm, S, problem.R, c=cand.c,
                                 kernel=_build_kernel(cand, dev), device=dev, world=world,
                                 wire=cand.wire)
    A, B = alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B)
    s_vals = alg.like_s_values(1.0)
    for _ in range(warmup):
        alg.fused_spmm(A, B, s_vals, MatMode.A)
    pairs = []
    for _ in range(max(int(trials), 1)):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            alg.fused_spmm(A, B, s_vals, MatMode.A)
            end.record()
            end.synchronize()
            pairs.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            alg.fused_spmm(A, B, s_vals, MatMode.A)
            pairs.append(time.perf_counter() - t0)
    seconds = min(pairs)
    return {"overall_throughput": 4.0 * S.nnz * alg.R / seconds / 1e9,
            "ms_per_pair": seconds * 1e3, "pairs_ms": [t * 1e3 for t in pairs],
            "trial": "wall"}


def measure_candidates(
    S,
    problem: Problem,
    cands: list[Candidate],
    *,
    trials: int = 2,
    warmup: int = 1,
    timeout_s: float = 120.0,
    retries: int = 1,
    backoff_s: float = 2.0,
    jitter: float = 0.25,
    max_elapsed_s: float = 900.0,
    trial_fn: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
    monotonic: Callable[[], float] = time.monotonic,
    rng=None,
    device=None,
    world=None,
    stop_on_timeout: Optional[bool] = None,
) -> list[tuple[Candidate, dict]]:
    """Measure each candidate; return the ``(candidate, record)`` pairs that
    gave a number, fastest first by measured throughput.

    A candidate gets up to ``retries + 1`` attempts, each under
    ``timeout_s``, with ``backoff_s * 2**attempt * (1 + U(0, jitter))``
    sleeps between them; ``max_elapsed_s`` caps a candidate's attempts. A
    ``ValueError`` (a grid or R the strategy refuses, an unknown variant)
    drops the candidate at once. ``stop_on_timeout`` (default: True on a
    CUDA ``device``; see the module doc) makes a timeout end the
    measuring. ``trial_fn(S, problem, candidate, trials, warmup) ->
    record`` replaces the harness trial."""
    import torch

    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card and torch.device(device).index is None:
        # The trial threads start on card 0: name this thread's card.
        device = torch.device("cuda", torch.cuda.current_device())
    if stop_on_timeout is None:
        stop_on_timeout = on_card
    run = trial_fn or functools.partial(default_trial, device=device, world=world)
    # A trial is a probe, not a run: kept in the run store it would share
    # the real run's key and axes and skew the gate's rolling baseline.
    with obs_store.suppressed():
        out = []
        for cand in cands:
            backoff = Backoff(base_s=backoff_s, jitter=jitter, max_delay_s=float("inf"),
                              max_elapsed_s=max_elapsed_s, rng=rng)
            t_start = monotonic()
            last_err = None
            for attempt in range(retries + 1):
                with trace.span("autotune:trial", algorithm=cand.algorithm, c=cand.c,
                                kernel=cand.kernel, attempt=attempt) as sp:
                    try:
                        rec = call_with_timeout(
                            lambda: run(S, problem, cand, trials, warmup),
                            timeout_s, label=f"trial:{cand.algorithm}",
                        )
                        sp.set(gflops=rec.get("overall_throughput"))
                        out.append((cand, rec))
                        last_err = None
                        break
                    except ValueError as e:
                        sp.set(failed=type(e).__name__)
                        last_err = e
                        break  # a deterministic refusal: retrying wastes budget
                    except Exception as e:  # noqa: BLE001 -- a failure drops the candidate
                        sp.set(failed=type(e).__name__)
                        last_err = e
                        if stop_on_timeout and isinstance(e, TimeoutError):
                            break
                if attempt < retries:
                    d = backoff.delay(attempt)
                    if not backoff.budget_left(monotonic() - t_start, d):
                        break
                    metrics.GLOBAL.add("autotune_trial_retries")
                    sleep(d)
            if last_err is not None:
                metrics.GLOBAL.add("autotune_candidates_dropped")
                trace.event("autotune_candidate_dropped", algorithm=cand.algorithm, c=cand.c,
                            kernel=cand.kernel, error=type(last_err).__name__)
                _LOG.warning("autotune dropped %s c=%s kernel=%s: %s: %s", cand.algorithm,
                             cand.c, cand.kernel, type(last_err).__name__, last_err)
                if stop_on_timeout and isinstance(last_err, TimeoutError):
                    break
    out.sort(key=lambda cr: cr[1].get("overall_throughput", 0.0), reverse=True)
    return out
