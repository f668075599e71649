"""Algorithm factory and timed trial loop (counterpart of
``bench/harness.py``).

The same five algorithm names as the JAX package; the two 1.5D dense-shift
fusions are ported. Two apps: ``vanilla`` (fused SDDMM->SpMM pairs) and
``attention`` (fused block-sparse attention over a mask). One untimed
warmup precedes the timed trials, whose throughput is
``2 * nnz * 2 * R * trials / elapsed`` GFLOP/s (an SDDMM and an SpMM of
``2 * nnz * R`` flops each). The elapsed time is the host clock around the
trials, which end in a device synchronise.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.device import device_label, synchronize
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

ALGORITHM_FACTORIES = {
    "15d_fusion1": lambda S, R, c, **kw: DenseShift15D(
        S, R=R, c=c, fusion_approach=1, **kw),
    "15d_fusion2": lambda S, R, c, **kw: DenseShift15D(
        S, R=R, c=c, fusion_approach=2, **kw),
}
NOT_PORTED = ("15d_sparse", "25d_dense_replicate", "25d_sparse_replicate")

#: Strategies with a fused block-sparse attention op: the 1.5D dense-shift
#: pair. The row denominator needs every logit of its row before any SpMM
#: contribution flows, which the dense-shift layout satisfies between its
#: two ring passes; the sparse-shift and Cannon layouts move the values
#: with the ring.
ATTENTION_CAPABLE = ("15d_fusion1", "15d_fusion2")
APPS = ("vanilla", "attention")
APPS_NOT_PORTED = ("gat", "als")


def make_algorithm(name: str, S: HostCOO, R: int, c: int = 1, kernel=None,
                   device=None, attention: bool = False,
                   **kw) -> DistributedSparse:
    """Instantiate one of the named algorithm configurations;
    ``attention=True`` asserts that it can run fused attention."""
    if attention and name not in ATTENTION_CAPABLE:
        raise ValueError(
            f"fused attention is implemented for the 1.5D dense-shift "
            f"strategies {ATTENTION_CAPABLE}; {name} cannot carry the "
            "softmax row denominator on its traveling accumulator"
        )
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, queue A item 10)")
    if name not in ALGORITHM_FACTORIES:
        raise ValueError(f"unknown algorithm {name!r}; available: "
                         f"{sorted(ALGORITHM_FACTORIES) + list(NOT_PORTED)}")
    return ALGORITHM_FACTORIES[name](S, R, c, kernel=kernel, device=device, **kw)


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
) -> dict:
    """Run one ``vanilla`` or ``attention`` configuration; append a JSON
    record to ``output_file`` (if given) and return it. With ``attention``
    ``S`` is the mask and ``mask`` its spec, which the record carries.
    Field names follow the JAX package's record for what this port
    measures."""
    if app in APPS_NOT_PORTED:
        raise NotImplementedError(
            f"app {app!r} is not ported yet (ROADMAP.md, queue A items 8-9)")
    if app not in APPS:
        raise ValueError(f"unknown app {app!r}; expected "
                         f"{' | '.join(APPS + APPS_NOT_PORTED)}")
    alg = make_algorithm(algorithm_name, S, R, c, kernel=kernel, device=device,
                         attention=app == "attention")
    if app == "attention":
        elapsed, app_stats = _run_attention(alg, fused, trials, warmup)
    else:
        elapsed, app_stats = _run_vanilla(alg, fused, trials, warmup), {}
    throughput = 2.0 * S.nnz * 2.0 * alg.R * trials / max(elapsed, 1e-12) / 1e9
    record = {
        "algorithm": algorithm_name,
        "app": app,
        "R": alg.R,
        "c": c,
        "fused": bool(fused),
        "fusion": "sequential",
        "mask": mask if app == "attention" else None,
        "num_trials": trials,
        "elapsed": elapsed,
        "overall_throughput": throughput,
        "kernel": getattr(alg.kernel, "name", type(alg.kernel).__name__),
        "device": device_label(alg.device),
        "alg_info": alg.json_algorithm_info(),
        "perf_stats": alg.json_perf_statistics(),
        "metrics": {k: dict(v) for k, v in alg.metrics.items()},
        **app_stats,
    }
    if output_file:
        with open(output_file, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record
