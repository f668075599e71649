"""Algorithm factory and timed trial loop (counterpart of
``bench/harness.py``).

The same five algorithm names as the JAX package, all ported, over any
world of ``parallel/comm.py``: the two 1.5D dense-shift fusions and the
1.5D sparse shift, sequential or overlapped (``overlap``), and the two
2.5D Cannon variants. Four apps: ``vanilla`` (fused SDDMM->SpMM pairs),
``attention`` (fused block-sparse attention over a mask), ``gat`` (the
multi-head GAT forward pass, ``models/gat.py``) and ``als`` (alternating
steps of ALS-CG, ``models/als.py``). Untimed warmup precedes the timed
trials, whose throughput is ``2 * nnz * 2 * R * trials / elapsed`` GFLOP/s
for every app (an SDDMM and an SpMM of ``2 * nnz * R`` flops each, nnz of
the whole matrix, so a rate at p ranks compares directly with p = 1's;
for ALS a trial is an alternating step, which runs about
``2 * (cg_iters + 2)`` pairs, and for GAT a forward pass, at the last
layer's R). The elapsed time is the host clock around the trials, which
end in a device synchronise.

The run sits in a ``bench`` trace span (and a ``bench`` profiler range
while capturing). The record's ``metrics`` is the strategy's
``OpMetrics.to_dict()``, the JAX record's fields; while tracing it carries
``run_id`` and ``trace_path`` (and the manifest is refreshed with the
device's facts), under a fault plan ``faults_fired`` (the firings of this
run), and under the watchdog ``anomalies`` (its summary of this run).
"""

from __future__ import annotations

import json
import time
from typing import Optional

from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.device import device_label, synchronize
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.models.gat import GAT, GATLayer
from distributed_sddmm_tpu_torch.obs import manifest as obs_manifest
from distributed_sddmm_tpu_torch.obs import profiler as obs_profiler
from distributed_sddmm_tpu_torch.obs import trace as obs_trace
from distributed_sddmm_tpu_torch.obs import watchdog as obs_watchdog
from distributed_sddmm_tpu_torch.parallel.base import (
    DistributedSparse, realized_kernel_variant,
)
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.resilience import CheckpointStore, faults
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

ALGORITHM_FACTORIES = {
    "15d_fusion1": lambda S, R, c, **kw: DenseShift15D(
        S, R=R, c=c, fusion_approach=1, **kw),
    "15d_fusion2": lambda S, R, c, **kw: DenseShift15D(
        S, R=R, c=c, fusion_approach=2, **kw),
    "15d_sparse": lambda S, R, c, **kw: SparseShift15D(S, R=R, c=c, **kw),
    "25d_dense_replicate": lambda S, R, c, **kw: CannonDense25D(S, R=R, c=c, **kw),
    "25d_sparse_replicate": lambda S, R, c, **kw: CannonSparse25D(S, R=R, c=c, **kw),
}
#: The JAX package's strategies the port lacks: none.
NOT_PORTED = ()

#: Strategies with a double-buffered local-kernel-overlap ring
#: (``--fusion overlap``): the 1.5D shift family. The 2.5D Cannon
#: strategies have none.
OVERLAP_CAPABLE = ("15d_fusion1", "15d_fusion2", "15d_sparse")

#: Strategies with a fused block-sparse attention op: the 1.5D dense-shift
#: pair. The row denominator needs every logit of its row before any SpMM
#: contribution flows, which the dense-shift layout satisfies between its
#: two ring passes; the sparse-shift and Cannon layouts move the values
#: with the ring.
ATTENTION_CAPABLE = ("15d_fusion1", "15d_fusion2")
APPS = ("vanilla", "attention", "gat", "als")
APPS_NOT_PORTED = ()


def make_algorithm(name: str, S: HostCOO, R: int, c: int = 1, kernel=None,
                   device=None, attention: bool = False, world=None,
                   overlap: bool = False, wire=None, **kw) -> DistributedSparse:
    """Instantiate one of the named algorithm configurations on ``world``
    (None: ``parallel/comm.world_from_env``); ``overlap=True`` selects the
    double-buffered ring (shift strategies only); ``attention=True``
    asserts that it can run fused attention; ``wire`` is the
    wire-precision policy (``parallel/wire.py``; None: the environment's,
    the f32 identity wire when unset)."""
    if attention and name not in ATTENTION_CAPABLE:
        raise ValueError(
            f"fused attention is implemented for the 1.5D dense-shift "
            f"strategies {ATTENTION_CAPABLE}; {name} cannot carry the "
            "softmax row denominator on its traveling accumulator"
        )
    if name not in ALGORITHM_FACTORIES:
        raise ValueError(f"unknown algorithm {name!r}; available: "
                         f"{sorted(ALGORITHM_FACTORIES)}")
    if overlap:
        if name not in OVERLAP_CAPABLE:
            raise ValueError(
                f"fusion 'overlap' is implemented for the 1.5D shift "
                f"strategies {OVERLAP_CAPABLE}; {name} has no "
                "double-buffered variant"
            )
        kw["overlap"] = True
    return ALGORITHM_FACTORIES[name](S, R, c, kernel=kernel, device=device,
                                     world=world, wire=wire, **kw)


def _run_vanilla(alg: DistributedSparse, fused: bool, trials: int, warmup: int):
    """``fusedSpMM`` pairs, or sddmmA then spmmA; returns the seconds of
    the timed trials."""
    A = alg.dummy_initialize(MatMode.A)
    B = alg.dummy_initialize(MatMode.B)
    s_vals = alg.like_s_values(1.0)

    def one_trial():
        if fused:
            return alg.fused_spmm(A, B, s_vals, MatMode.A)
        mid = alg.sddmm_a(A, B, s_vals)
        return alg.spmm_a(A, B, mid), mid

    for _ in range(warmup):
        one_trial()
    synchronize(alg.device)
    alg.reset_performance_timers()
    t0 = time.perf_counter()
    for _ in range(trials):
        one_trial()
    synchronize(alg.device)
    return time.perf_counter() - t0


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _attention_hbm_bytes(alg: DistributedSparse, s_vals, A, B) -> dict:
    """Counted device-memory traffic of one attention call, fused against
    unfused, from the shapes of what each op reads and writes once: a
    count, not a measurement. Every op reads its inputs and writes its
    outputs once; the unfused SDDMM -> softmax -> SpMM sequence is three
    ops, so the logits and the weights make a round trip between them and
    the tile structure is read by each. Only shapes and types of ``A`` and
    ``B`` are read."""
    t = alg.S_tiles
    targs = (t.row_ptr, t.rows, t.cols, s_vals)
    out = A  # the output has A's shape and type
    fused = _bytes(A, B, *targs) + _bytes(out, s_vals)
    sddmm = _bytes(A, B, *targs) + _bytes(s_vals)
    softmax = _bytes(*targs, s_vals) + _bytes(s_vals)
    spmm = _bytes(B, *targs) + _bytes(out)
    unfused = sddmm + softmax + spmm
    return {"fused_bytes": fused, "unfused_bytes": unfused,
            "savings_frac": 1.0 - fused / max(unfused, 1)}


def _run_attention(alg: DistributedSparse, fused: bool, trials: int,
                   warmup: int):
    """Fused attention calls (or the three-op unfused baseline with
    ``fused=False``) on the dummy operands; returns the seconds of the
    timed trials and ``{"attention_hbm": ...}``."""
    A = alg.dummy_initialize(MatMode.A)
    B = alg.dummy_initialize(MatMode.B)
    s_vals = alg.like_s_values(1.0)

    def one_trial():
        if fused:
            return alg.fused_attention(A, B, s_vals)
        return alg.attention_unfused(A, B, s_vals)

    for _ in range(warmup):
        one_trial()
    synchronize(alg.device)
    alg.reset_performance_timers()
    t0 = time.perf_counter()
    for _ in range(trials):
        one_trial()
    synchronize(alg.device)
    elapsed = time.perf_counter() - t0
    return elapsed, {"attention_hbm": _attention_hbm_bytes(alg, s_vals, A, B)}


def _gat_layers(R: int, num_layers: int = 3) -> list[GATLayer]:
    """The GAT of the JAX benchmark: heads (4, 4, 6), ``features_per_head
    = R``, each layer's input the previous layer's output."""
    layers, in_feat = [], R
    for h in [4, 4, 6][:num_layers]:
        layers.append(GATLayer(input_features=in_feat, features_per_head=R, num_heads=h))
        in_feat = R * h
    return layers


def _run_gat(alg: DistributedSparse, trials: int, warmup: int, num_layers: int = 3):
    """Forward passes of the benchmark GAT on the dummy input."""
    gat = GAT(_gat_layers(alg.R, num_layers), alg)
    for _ in range(warmup):
        gat.forward()
    synchronize(alg.device)
    alg.reset_performance_timers()
    t0 = time.perf_counter()
    for _ in range(trials):
        gat.forward()
    synchronize(alg.device)
    return time.perf_counter() - t0, {"gat_heads": [layer.num_heads for layer in gat.layers]}


def _run_als(alg: DistributedSparse, trials: int, warmup: int, cg_iters: int = 10,
             S: Optional[HostCOO] = None, checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 1, resume: bool = False):
    """``trials`` alternating ALS steps (one warmup step first, then the
    embeddings start afresh), with a checkpoint store under
    ``checkpoint_dir`` when given."""
    als = DistributedALS(alg, S_host=S)
    als.initialize_embeddings()
    if warmup:
        als.run_cg(1, cg_iters=cg_iters)
        als.initialize_embeddings()
    store = CheckpointStore(checkpoint_dir) if checkpoint_dir else None
    synchronize(alg.device)
    alg.reset_performance_timers()
    t0 = time.perf_counter()
    als.run_cg(trials, cg_iters=cg_iters, checkpoint=store,
               checkpoint_every=checkpoint_every, resume=resume)
    synchronize(alg.device)
    elapsed = time.perf_counter() - t0
    stats = {"als_residual": als.compute_residual(), "cg_iters": cg_iters}
    if als.degraded:
        stats["als_degraded"] = als.degraded
    return elapsed, stats


def benchmark_algorithm(
    S: HostCOO,
    algorithm_name: str,
    output_file: Optional[str],
    fused: bool,
    R: int,
    c: int = 1,
    app: str = "vanilla",
    trials: int = 5,
    warmup: int = 1,
    kernel=None,
    device=None,
    mask: Optional[str] = None,
    world=None,
    overlap: bool = False,
    breakdown: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    wire=None,
    extra_info: Optional[dict] = None,
) -> dict:
    """Run one configuration of an app; append a JSON record to
    ``output_file`` (if given; process 0 of a world of processes) and
    return it. With ``attention`` ``S`` is the mask and ``mask`` its spec,
    which the record carries. ``breakdown`` replaces ``perf_stats`` by the
    fused pair's region attribution (``measure_breakdown``). The
    checkpoint arguments are ALS's (``run_cg``). ``wire`` is the
    wire-precision policy; the record's ``wire`` is the realized policy's
    label. ``extra_info`` is merged into the record (the CLI's ``plan``).
    Field names follow the JAX package's record for what this port
    measures."""
    if app not in APPS:
        raise ValueError(f"unknown app {app!r}; expected {' | '.join(APPS)}")
    if breakdown and (app != "vanilla" or not fused):
        # Fail before any measurement: the attribution times the fusedSpMM
        # op, so it would mix ops and units into unfused or attention
        # records.
        raise ValueError(
            "--breakdown requires app='vanilla' and fused=True (it "
            "attributes the fusedSpMM op)"
        )
    # Cursors: the plan's and the watchdog's lists are process-wide, and a
    # record carries only what fired during its own run.
    fault_plan = faults.active()
    events_before = len(fault_plan.events) if fault_plan is not None else 0
    watchdog = obs_watchdog.active()
    anomalies_before = len(watchdog.events) if watchdog is not None else 0
    alg = make_algorithm(algorithm_name, S, R, c, kernel=kernel, device=device,
                         attention=app == "attention", world=world,
                         overlap=overlap, wire=wire)
    with obs_trace.span("bench", algorithm=algorithm_name, app=app, R=R, c=c,
                        fused=bool(fused), trials=trials), obs_profiler.annotate("bench"):
        if app == "attention":
            elapsed, app_stats = _run_attention(alg, fused, trials, warmup)
        elif app == "gat":
            elapsed, app_stats = _run_gat(alg, trials, warmup)
        elif app == "als":
            elapsed, app_stats = _run_als(alg, trials, warmup, S=S,
                                          checkpoint_dir=checkpoint_dir,
                                          checkpoint_every=checkpoint_every, resume=resume)
        else:
            elapsed, app_stats = _run_vanilla(alg, fused, trials, warmup), {}
    throughput = 2.0 * S.nnz * 2.0 * alg.R * trials / max(elapsed, 1e-12) / 1e9
    perf_stats = alg.json_perf_statistics()
    if breakdown:
        # The breakdown replaces the whole-call counters, so comm time is
        # not counted twice into Computation.
        perf_stats = alg.measure_breakdown(
            alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B),
            alg.like_s_values(1.0), op="fusedSpMM", trials=trials)
    record = {
        "algorithm": algorithm_name,
        "app": app,
        "R": alg.R,
        "c": c,
        "fused": bool(fused),
        "fusion": "overlap" if alg.overlap else "sequential",
        "mask": mask if app == "attention" else None,
        "num_trials": trials,
        "elapsed": elapsed,
        "overall_throughput": throughput,
        "kernel": getattr(alg.kernel, "name", type(alg.kernel).__name__),
        "kernel_variant": realized_kernel_variant(alg),
        # The realized wire policy; its label keeps role overrides apart.
        "wire": alg.wire.label,
        "device": device_label(alg.device),
        "num_processes": alg.world.num_processes,
        "process_index": alg.world.process_index,
        "alg_info": alg.json_algorithm_info(),
        "perf_stats": perf_stats,
        "metrics": alg.metrics.to_dict(),
        **app_stats,
        **(extra_info or {}),
    }
    if obs_trace.enabled():
        record["run_id"] = obs_trace.run_id()
        record["trace_path"] = obs_trace.trace_path()
        obs_manifest.write_for_trace(obs_trace.tracer(), device=alg.device)
    if fault_plan is not None:
        record["faults_fired"] = [{"site": site, "kind": kind, "call": n}
                                  for site, kind, n in fault_plan.events[events_before:]]
    if watchdog is not None:
        record["anomalies"] = watchdog.summary(since=anomalies_before)
    if output_file and alg.world.process_index == 0:
        with open(output_file, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record
