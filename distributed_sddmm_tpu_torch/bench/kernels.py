"""One-device local-kernel sweep (counterpart of ``bench/kernels.py``; the
reference's ``local_kernel_benchmark``): matrix size, nnz a row and R over
the local SDDMM, SpMM and fused kernels, printed as a GFLOP/s table.

Kernels: ``cuda-f32`` and ``cuda-bf16`` (the tile kernels of
``ops/cuda_kernels.py`` on one tile built as ``DenseShift15D`` builds it
at p = 1) and ``torch`` (the plain gather-dot SDDMM and ``index_add_``
SpMM of ``ops/kernels.py`` on the flat COO arrays, which has no fused
kernel: its fused pair is an SDDMM then an SpMM, timed as one). The
default pair is ``torch`` and ``cuda-bf16``, the counterparts of the JAX
sweep's ``xla`` and ``pallas``. A time is CUDA events around ``trials``
launches after a warmup launch, ending in a synchronise, over the count
(the host clock on the CPU). The JAX sweep's tiling knobs (``bm``, ``bn``,
``group``, ``chunk``, ``scatter_form``, ``batch_step``) have no
counterpart here; a record names its ``device`` instead.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from distributed_sddmm_tpu_torch.device import device_label, resolve_device, synchronize
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

# The reference sweeps logM 13-16, nnz/row 8-128, R 8-4096
# (``local_kernel_benchmark.cpp:276-280``); the JAX package's subset.
DEFAULT_LOG_M = [13, 14, 15, 16]
DEFAULT_NNZ_PER_ROW = [8, 32, 128]
DEFAULT_R = [32, 128, 512]
KERNELS = ("cuda-f32", "cuda-bf16", "torch")
DEFAULT_KERNELS = ["torch", "cuda-bf16"]


def _time(fn, trials: int, dev: torch.device) -> float:
    """Seconds a call of ``fn``: one warmup call, then ``trials`` calls
    between two CUDA events (the host clock on the CPU)."""
    fn()
    synchronize(dev)
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(trials):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / trials
    t0 = time.perf_counter()
    for _ in range(trials):
        fn()
    return (time.perf_counter() - t0) / trials


def tile_strategy(S: HostCOO, R: int, device) -> DenseShift15D:
    """The p = 1 dense shift whose one tile the CUDA kernels run on (its
    own kernel is not called; ``set_r_value`` moves it to another R)."""
    return DenseShift15D(S, R=R, c=1, fusion_approach=2, world=LocalWorld(1),
                         kernel=CudaTileKernel("f32", device=device), device=device)


def dense_operands(S: HostCOO, R: int) -> tuple:
    """``(A, B)``: N(0, 1) float32 from ``default_rng(0)``, as the JAX
    sweep draws them."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((S.M, R)).astype(np.float32),
            rng.standard_normal((S.N, R)).astype(np.float32))


def bench_one(S: HostCOO, R: int, kernel_name: str, trials: int, device,
              alg: DenseShift15D | None = None, dense: tuple | None = None) -> dict:
    """One record: the SDDMM, SpMM and fused pair of ``kernel_name`` on
    ``S`` (its values) with the operands ``dense`` (None:
    :func:`dense_operands`); the CUDA kernels on ``alg``'s tile (None:
    :func:`tile_strategy`)."""
    dev = resolve_device(device)
    if kernel_name not in KERNELS:
        raise ValueError(f"unknown kernel {kernel_name!r}; expected one of {KERNELS}")
    A_np, B_np = dense_operands(S, R) if dense is None else dense
    if kernel_name == "torch":
        kern = TorchKernel()
        rows = torch.from_numpy(S.rows).to(dev)
        cols = torch.from_numpy(S.cols).to(dev)
        vals = torch.from_numpy(S.vals.astype(np.float32)).to(dev)
        A, B = torch.from_numpy(A_np).to(dev), torch.from_numpy(B_np).to(dev)
        t_sddmm = _time(lambda: kern.sddmm(rows, cols, vals, A, B), trials, dev)
        t_spmm = _time(lambda: kern.spmm(rows, cols, vals, B, S.M), trials, dev)
        t_fused = _time(lambda: kern.spmm(rows, cols, kern.sddmm(rows, cols, vals, A, B),
                                          B, S.M), trials, dev)
    else:
        kern = CudaTileKernel(kernel_name.removeprefix("cuda-"), device=dev)
        if alg is None:
            alg = tile_strategy(S, R, dev)
        alg.set_r_value(R)
        tile = alg.S_tiles.tile(0, 0)
        sv = alg.scatter_s_values(S.vals)[0, 0]
        at, bt = kern.prep(alg.put_a(A_np)), kern.prep(alg.put_b(B_np))
        t_sddmm = _time(lambda: kern.sddmm_tile(tile, sv, at, bt), trials, dev)
        t_spmm = _time(lambda: kern.spmm_tile(tile, sv, bt), trials, dev)
        t_fused = _time(lambda: kern.fused_tile(tile, sv, at, bt), trials, dev)
    flops = 2.0 * S.nnz * R
    return {
        "M": S.M, "N": S.N, "nnz": S.nnz, "R": R, "kernel": kernel_name,
        "sddmm_ms": t_sddmm * 1e3, "spmm_ms": t_spmm * 1e3,
        "fused_pair_ms": t_fused * 1e3,
        "sddmm_gflops": flops / t_sddmm / 1e9,
        "spmm_gflops": flops / t_spmm / 1e9,
        "fused_pair_gflops": 2 * flops / t_fused / 1e9,
        "device": device_label(dev),
    }


def run_kernel_benchmark(log_m_values=None, nnz_per_row_values=None, r_values=None,
                         kernels=tuple(DEFAULT_KERNELS), trials: int = 5,
                         output_file: str | None = None, device=None) -> list:
    """Sweep and print the kernel table; returns every record. The
    matrices are the R-mat of each ``(log_m, nnz a row)`` (seed 0) with
    N(0, 1) values from ``default_rng(1)``."""
    dev = resolve_device(device)
    log_m_values = log_m_values or DEFAULT_LOG_M
    nnz_per_row_values = nnz_per_row_values or DEFAULT_NNZ_PER_ROW
    r_values = r_values or DEFAULT_R
    header = (f"{'M':>9} {'nnz':>10} {'R':>5} {'kernel':>12} "
              f"{'SDDMM':>9} {'SpMM':>9} {'fused':>9}   (GFLOP/s)")
    print(header)
    print("-" * len(header))
    records = []
    for log_m in log_m_values:
        for npr in nnz_per_row_values:
            S = HostCOO.rmat(log_m, npr, seed=0, device=dev)
            S = S.with_values(np.random.default_rng(1).standard_normal(S.nnz))
            alg = None
            for R in r_values:
                dense = dense_operands(S, R)
                for name in kernels:
                    if alg is None and name != "torch":
                        alg = tile_strategy(S, R, dev)
                    rec = bench_one(S, R, name, trials, dev, alg, dense)
                    records.append(rec)
                    print(f"{rec['M']:>9} {rec['nnz']:>10} {rec['R']:>5} "
                          f"{rec['kernel']:>12} {rec['sddmm_gflops']:>9.2f} "
                          f"{rec['spmm_gflops']:>9.2f} {rec['fused_pair_gflops']:>9.2f}",
                          flush=True)
                    if output_file:
                        with open(output_file, "a") as f:
                            f.write(json.dumps(rec) + "\n")
    return records
