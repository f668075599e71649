"""Algorithm factory and timed trial loop (counterpart of
``bench/harness.py``).

The same five algorithm names as the JAX package; the two 1.5D dense-shift
fusions are ported. One untimed warmup precedes the timed trials, whose
throughput is ``2 * nnz * 2 * R * trials / elapsed`` GFLOP/s (an SDDMM and
an SpMM of ``2 * nnz * R`` flops each). The elapsed time is the host clock
around the trials, which end in a device synchronise.
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


def make_algorithm(name: str, S: HostCOO, R: int, c: int = 1, kernel=None,
                   device=None, **kw) -> DistributedSparse:
    """Instantiate one of the named algorithm configurations."""
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


def benchmark_algorithm(
    S: HostCOO,
    algorithm_name: str,
    output_file: Optional[str],
    fused: bool,
    R: int,
    c: int = 1,
    trials: int = 5,
    warmup: int = 1,
    kernel=None,
    device=None,
) -> dict:
    """Run one ``vanilla`` configuration (the ALS and GAT apps are not
    ported yet: ROADMAP.md, queue A items 8-9); append a JSON record to
    ``output_file`` (if given) and return it. Field names follow the JAX
    package's record for what this port measures."""
    alg = make_algorithm(algorithm_name, S, R, c, kernel=kernel, device=device)
    elapsed = _run_vanilla(alg, fused, trials, warmup)
    throughput = 2.0 * S.nnz * 2.0 * alg.R * trials / max(elapsed, 1e-12) / 1e9
    record = {
        "algorithm": algorithm_name,
        "app": "vanilla",
        "R": alg.R,
        "c": c,
        "fused": bool(fused),
        "fusion": "sequential",
        "num_trials": trials,
        "elapsed": elapsed,
        "overall_throughput": throughput,
        "kernel": getattr(alg.kernel, "name", type(alg.kernel).__name__),
        "device": device_label(alg.device),
        "alg_info": alg.json_algorithm_info(),
        "perf_stats": alg.json_perf_statistics(),
        "metrics": {k: dict(v) for k, v in alg.metrics.items()},
    }
    if output_file:
        with open(output_file, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record
