"""Distributed SDDMM/SpMM strategy base: dense buffers, sparse values,
public ops and per-op counters (counterpart of ``parallel/base.py``).

Dense operands are float32 tensors of the canonical shape ``(M_pad, R)`` /
``(N_pad, R)`` on the strategy's device; sparse values live in the tile
layout of ``parallel/sharding.py``. Ops return new tensors. In place of the
JAX package's observability and resilience machinery, every public op adds
its call count and seconds (host clock around the op, ending in a device
synchronise) to a plain per-op counter.
"""

from __future__ import annotations

import abc
import time

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.device import resolve_device, synchronize
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.sharding import TileSet


def realized_kernel_variant(alg):
    """The codegen variant a run really executed, as records report it:
    the strategy's :attr:`DistributedSparse.kernel_variant_realized` (None
    means generic); only an object without that property falls back to
    its kernel's ``variant_id``."""
    missing = object()
    realized = getattr(alg, "kernel_variant_realized", missing)
    if realized is not missing:
        return realized
    return getattr(getattr(alg, "kernel", None), "variant_id", None)


class DistributedSparse(abc.ABC):
    """Base class of the distributed strategies."""

    algorithm_name: str = ""
    proc_grid_names: tuple = ()

    #: Type of the dense operands and the sparse values.
    dtype = torch.float32

    def __init__(self, M: int, N: int, R: int, c: int, p: int, kernel=None,
                 device=None):
        self.device = resolve_device(device)
        self.M, self.N, self.R, self.c, self.p = M, N, R, c, p
        self.kernel = kernel if kernel is not None else CudaTileKernel(device=self.device)
        #: ``{op: {"calls": n, "seconds": s}}`` over the public ops.
        self.metrics: dict[str, dict] = {}
        self.grid_dims = (p // c, c, 1)
        # Subclasses set these before use:
        self.M_pad: int = -1
        self.N_pad: int = -1
        self.S_tiles: TileSet = None
        self.ST_tiles: TileSet = None

    # ---------------------------- dense buffers ---------------------------- #

    def dense_shape(self, mode: MatMode) -> tuple:
        return (self.M_pad if mode == MatMode.A else self.N_pad, self.R)

    def like_a_matrix(self, value: float) -> torch.Tensor:
        return torch.full(self.dense_shape(MatMode.A), value, dtype=self.dtype,
                          device=self.device)

    def like_b_matrix(self, value: float) -> torch.Tensor:
        return torch.full(self.dense_shape(MatMode.B), value, dtype=self.dtype,
                          device=self.device)

    def dummy_initialize(self, mode: MatMode) -> torch.Tensor:
        """Deterministic ``value = globalRow * R + globalCol`` fill,
        computed in float32 like the JAX package's."""
        n_rows = self.dense_shape(mode)[0]
        rows = torch.arange(n_rows, dtype=self.dtype, device=self.device)[:, None]
        col = torch.arange(self.R, dtype=self.dtype, device=self.device)
        return rows * self.R + col

    def _put(self, host, n_pad: int) -> torch.Tensor:
        host = torch.as_tensor(host)
        buf = torch.zeros((n_pad, self.R), dtype=self.dtype, device=self.device)
        buf[: host.shape[0]] = host.to(device=self.device, dtype=self.dtype)
        return buf

    def put_a(self, host) -> torch.Tensor:
        """A host ``(M, R)`` matrix (numpy or tensor), zero-padded to M_pad."""
        return self._put(host, self.M_pad)

    def put_b(self, host) -> torch.Tensor:
        return self._put(host, self.N_pad)

    def host_a(self, A: torch.Tensor) -> np.ndarray:
        """A in global ``(M, R)`` row order on the host, padding stripped."""
        return A.detach().cpu().numpy().reshape(self.M_pad, self.R)[: self.M]

    def host_b(self, B: torch.Tensor) -> np.ndarray:
        return B.detach().cpu().numpy().reshape(self.N_pad, self.R)[: self.N]

    # ---------------------------- sparse values ---------------------------- #

    def like_s_values(self, value: float) -> torch.Tensor:
        return self.S_tiles.like_values(value)

    def like_st_values(self, value: float) -> torch.Tensor:
        return self.ST_tiles.like_values(value)

    def scatter_s_values(self, host_vals) -> torch.Tensor:
        return self.S_tiles.scatter_values(host_vals)

    def gather_s_values(self, dev_vals: torch.Tensor) -> np.ndarray:
        return self.S_tiles.gather_values(dev_vals)

    def scatter_st_values(self, host_vals) -> torch.Tensor:
        return self.ST_tiles.scatter_values(host_vals)

    def gather_st_values(self, dev_vals: torch.Tensor) -> np.ndarray:
        return self.ST_tiles.gather_values(dev_vals)

    # ------------------------------ public ops ----------------------------- #

    @abc.abstractmethod
    def sddmm_a(self, A, B, s_vals):
        """``s_vals * (A @ B^T sampled at pattern(S))`` in S's tile layout."""

    @abc.abstractmethod
    def sddmm_b(self, A, B, st_vals):
        """SDDMM with values in S^T's tile layout."""

    @abc.abstractmethod
    def spmm_a(self, A, B, s_vals):
        """``S @ B`` in A's shape."""

    @abc.abstractmethod
    def spmm_b(self, A, B, st_vals):
        """``S^T @ A`` in B's shape."""

    def fused_spmm(self, A, B, s_vals, mode: MatMode = MatMode.A):
        """SDDMM then SpMM; returns ``(new_dense, sddmm_vals)``. The base
        version chains the two public ops."""
        if mode == MatMode.A:
            mid = self.sddmm_a(A, B, s_vals)
            return self.spmm_a(A, B, mid), mid
        mid = self.sddmm_b(A, B, s_vals)
        return self.spmm_b(A, B, mid), mid

    def fused_attention(self, A, B, s_vals, mode: MatMode = MatMode.A):
        """Block-sparse attention: SDDMM, row-wise masked softmax, SpMM;
        returns ``(new_dense, attention_weights)``.

        Not supported in the base: a row's denominator must see every
        logit of the row before any SpMM contribution flows, which the
        1.5D dense-shift layout satisfies between its two ring passes;
        the sparse-shift and Cannon layouts move values and structure
        with the ring, so the denominator cannot ride the traveling
        accumulator."""
        raise NotImplementedError(
            f"fused attention is not implemented for "
            f"{self.algorithm_name or type(self).__name__}: the softmax "
            "row denominator cannot ride this strategy's traveling "
            "accumulator (use the 1.5D dense-shift strategies)"
        )

    def initial_shift(self, A, B, mode: KernelMode):
        """Pre-skew dense operands where the strategy needs it (identity)."""
        return A, B

    def de_shift(self, A, B, mode: KernelMode):
        return A, B

    @staticmethod
    def fingerprint(x) -> float:
        x64 = np.asarray(x, dtype=np.float64)
        return float(np.sum(x64 * x64))

    @property
    def kernel_variant_realized(self):
        """The variant id that shaped this strategy's tile sets (None:
        generic, including tile sets built without a variant). Either tile
        set carrying it labels the run."""
        return (getattr(self.S_tiles, "blk_variant", None)
                or getattr(self.ST_tiles, "blk_variant", None))

    # ------------------------------- counters ------------------------------ #

    def _timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(self.device)
        rec = self.metrics.setdefault(name, {"calls": 0, "seconds": 0.0})
        rec["calls"] += 1
        rec["seconds"] += time.perf_counter() - t0
        return out

    def reset_performance_timers(self) -> None:
        self.metrics.clear()

    def json_perf_statistics(self) -> dict:
        """Per-op seconds, sorted by op name."""
        return {k: self.metrics[k]["seconds"] for k in sorted(self.metrics)}

    def json_algorithm_info(self) -> dict:
        return {
            "alg_name": self.algorithm_name,
            "m": self.M,
            "n": self.N,
            "nnz": self.S_tiles.nnz if self.S_tiles else 0,
            "r": self.R,
            "p": self.p,
            "c": self.c,
            "dim_interpretations": list(self.proc_grid_names),
            "dim_values": list(self.grid_dims[: len(self.proc_grid_names)]),
            "nnz_procs": self.S_tiles.nnz_per_device.reshape(-1).tolist()
            if self.S_tiles else [],
            "nnz_tpose_procs": self.ST_tiles.nnz_per_device.reshape(-1).tolist()
            if self.ST_tiles else [],
        }
