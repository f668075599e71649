"""External-competitor baseline: scipy CSR SpMM on the host CPU
(counterpart of ``bench/baseline.py``).

The reference benchmarked against PETSc ``MatMatMult`` with the same JSON
schema and FLOP accounting (``petsc_baseline/spmm_test.cpp:111-157``);
here the competitor is scipy's CSR SpMM. This is the one entry point that
runs on the host by design: it uses no card and takes no ``--device``.
Same record schema: ``2 * R * nnz * iters`` FLOPs over wall time.
"""

from __future__ import annotations

import json
import time

import numpy as np

from distributed_sddmm_tpu_torch.utils.coo import HostCOO


def run_baseline(S: HostCOO, R: int = 128, iters: int = 10,
                 output_file: str | None = None) -> dict:
    """scipy CSR @ dense, accumulated into one output, PETSc-style
    accounting."""
    csr = S.to_scipy()
    B = np.random.default_rng(0).standard_normal((S.N, R))
    out = np.zeros((S.M, R))

    out += csr @ B  # warm caches
    t0 = time.perf_counter()
    for _ in range(iters):
        out += csr @ B
    elapsed = time.perf_counter() - t0

    record = {
        "baseline": "scipy-csr-spmm",
        "m": S.M, "n": S.N, "nnz": S.nnz, "r": R,
        "num_iterations": iters,
        "elapsed": elapsed,
        # ``petsc_baseline/spmm_test.cpp:138-144`` accounting.
        "overall_throughput": 2.0 * R * S.nnz * iters / elapsed / 1e9,
        "device": "host",
    }
    if output_file:
        with open(output_file, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record
