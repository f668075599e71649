"""Distributed SDDMM/SpMM strategy base: dense buffers, sparse values,
public ops and per-op counters (counterpart of ``parallel/base.py``).

A strategy runs on a world of ranks (``parallel/comm.py``) laid out on a
grid (``parallel/mesh.py``). Dense operands are float32 row blocks: rank
``(i, j, k)`` owns block ``i * nc + j`` of ``M_pad / (nr * nc)`` rows (the
JAX package's ``P(("rows", "cols"), None)``, replicated over ``layers``).
Under a :class:`~distributed_sddmm_tpu_torch.parallel.comm.LocalWorld` a
dense operand stays the global ``(M_pad, R)`` / ``(N_pad, R)`` tensor, and
each rank's block is a view of its rows; under a ``DistWorld`` it is the
process's own block. Sparse values live in the tile layout of
``parallel/sharding.py``, one slot a rank held. Ops return new tensors.
In place of the JAX package's observability and resilience machinery,
every public op adds its call count and seconds (host clock around the op,
ending in a device synchronise) to a plain per-op counter.
"""

from __future__ import annotations

import abc
import time

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.device import resolve_device, synchronize
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.loops import ABLATION_MODES, ablation_mode
from distributed_sddmm_tpu_torch.parallel.mesh import COLS, ROWS, GridSpec
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

    def __init__(self, M: int, N: int, R: int, c: int, world, grid: GridSpec,
                 kernel=None, device=None):
        self.device = resolve_device(device)
        self.M, self.N, self.R, self.c, self.p = M, N, R, c, grid.p
        self.world, self.grid = world, grid
        self.comm = world.comm(grid, self.device)
        #: The dense block (and tile slot) of each rank held, in slot order.
        self.blocks = [i * grid.nc + j for i, j, _ in self.comm.coords]
        self.kernel = kernel if kernel is not None else CudaTileKernel(device=self.device)
        #: ``{op: {"calls": n, "seconds": s}}`` over the public ops.
        self.metrics: dict[str, dict] = {}
        # Subclasses set these before use:
        self.M_pad: int = -1
        self.N_pad: int = -1
        self.S_tiles: TileSet = None
        self.ST_tiles: TileSet = None

    # ---------------------------- dense buffers ---------------------------- #

    def _block_rows(self, mode: MatMode) -> int:
        n_pad = self.M_pad if mode == MatMode.A else self.N_pad
        return n_pad // (self.grid.nr * self.grid.nc)

    def dense_shape(self, mode: MatMode) -> tuple:
        """The global ``(M_pad, R)`` / ``(N_pad, R)`` in one process, a
        rank's block under a world of processes."""
        if self.comm.in_process:
            return (self.M_pad if mode == MatMode.A else self.N_pad, self.R)
        return (self._block_rows(mode), self.R)

    def _row0(self, mode: MatMode) -> int:
        """The global row of this process's first dense row."""
        return 0 if self.comm.in_process else self.blocks[0] * self._block_rows(mode)

    def like_a_matrix(self, value: float) -> torch.Tensor:
        return torch.full(self.dense_shape(MatMode.A), value, dtype=self.dtype,
                          device=self.device)

    def like_b_matrix(self, value: float) -> torch.Tensor:
        return torch.full(self.dense_shape(MatMode.B), value, dtype=self.dtype,
                          device=self.device)

    def dummy_initialize(self, mode: MatMode) -> torch.Tensor:
        """Deterministic ``value = globalRow * R + globalCol`` fill,
        computed in float32 like the JAX package's."""
        n_rows, row0 = self.dense_shape(mode)[0], self._row0(mode)
        rows = torch.arange(row0, row0 + n_rows, dtype=self.dtype,
                            device=self.device)[:, None]
        col = torch.arange(self.R, dtype=self.dtype, device=self.device)
        return rows * self.R + col

    def _put(self, host, mode: MatMode) -> torch.Tensor:
        host = torch.as_tensor(host)
        buf = torch.zeros(self.dense_shape(mode), dtype=self.dtype, device=self.device)
        row0 = self._row0(mode)
        part = host[row0: row0 + buf.shape[0]]
        buf[: part.shape[0]] = part.to(device=self.device, dtype=self.dtype)
        return buf

    def put_a(self, host) -> torch.Tensor:
        """A host ``(M, R)`` matrix (numpy or tensor), zero-padded to M_pad
        (this process's block of it under a world of processes)."""
        return self._put(host, MatMode.A)

    def put_b(self, host) -> torch.Tensor:
        return self._put(host, MatMode.B)

    def _all_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's part of a dense operand or of the values,
        concatenated in block order (an all-gather under a world of
        processes)."""
        if self.comm.in_process:
            return x
        return self.comm.all_gather([x], (ROWS, COLS))[0]

    def host_a(self, A: torch.Tensor) -> np.ndarray:
        """A in global ``(M, R)`` row order on the host, padding stripped."""
        A = self._all_blocks(A)
        return A.detach().cpu().numpy().reshape(self.M_pad, self.R)[: self.M]

    def host_b(self, B: torch.Tensor) -> np.ndarray:
        B = self._all_blocks(B)
        return B.detach().cpu().numpy().reshape(self.N_pad, self.R)[: self.N]

    def _blocks(self, X: torch.Tensor, mode: MatMode) -> list:
        """Each held rank's block of a dense operand (views, in one
        process)."""
        if not self.comm.in_process:
            return [X]
        n = self._block_rows(mode)
        return [X[b * n: (b + 1) * n] for b in self.blocks]

    def _assemble(self, blocks: list) -> torch.Tensor:
        """The inverse of :meth:`_blocks` for an output."""
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks)

    # ---------------------------- sparse values ---------------------------- #

    def like_s_values(self, value: float) -> torch.Tensor:
        return self.S_tiles.like_values(value)

    def like_st_values(self, value: float) -> torch.Tensor:
        return self.ST_tiles.like_values(value)

    def scatter_s_values(self, host_vals) -> torch.Tensor:
        return self.S_tiles.scatter_values(host_vals)

    def gather_s_values(self, dev_vals: torch.Tensor) -> np.ndarray:
        return self.S_tiles.gather_values(self._all_blocks(dev_vals))

    def scatter_st_values(self, host_vals) -> torch.Tensor:
        return self.ST_tiles.scatter_values(host_vals)

    def gather_st_values(self, dev_vals: torch.Tensor) -> np.ndarray:
        return self.ST_tiles.gather_values(self._all_blocks(dev_vals))

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

    # ------------------------- feature width (GAT) ------------------------- #

    def set_r_value(self, R: int) -> None:
        """Change the inner dimension R. Nothing a strategy keeps is sized
        by R: dense buffers, ring buffers and ``comm_profile`` all take the
        new width from here or from the operands of each call."""
        self.R = R

    def _unskew_cols(self, X: torch.Tensor, mode: MatMode) -> torch.Tensor:
        """Resident layout -> global column order (identity: no ported
        strategy skews its columns)."""
        return X

    def _skew_cols(self, X: torch.Tensor, mode: MatMode) -> torch.Tensor:
        """Global column order -> resident layout (identity)."""
        return X

    def dense_project(self, X: torch.Tensor, W: torch.Tensor, mode: MatMode) -> torch.Tensor:
        """The local projection ``X @ W`` in the canonical layout (the GAT
        head's matrix product; ``W`` is ``(R_in, R_out)`` in global column
        order, and each process projects its own rows). float32 matmuls
        run without TF32: resolving the device pinned it off."""
        self.set_r_value(W.shape[1])
        return self._skew_cols(torch.matmul(self._unskew_cols(X, mode), W), mode)

    def concat_heads(self, heads: list, mode: MatMode) -> torch.Tensor:
        """The per-head outputs side by side on the feature dimension, in
        the canonical layout."""
        self.set_r_value(sum(h.shape[-1] for h in heads))
        return self._skew_cols(torch.cat([self._unskew_cols(h, mode) for h in heads],
                                         dim=-1), mode)

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

    def measure_breakdown(self, A, B, s_vals, op: str = "fusedSpMM",
                          trials: int = 3) -> dict:
        """Region attribution {Replication, Propagation, Computation} by
        timing the op under the three ablation modes of
        ``parallel/loops.py`` (one untimed call each first):

        * Computation = t(local)            -- every collective ablated;
        * Replication = t(no_ring) - t(local) -- gathers and reduce-scatters real;
        * Propagation = t(full) - t(no_ring)  -- ring hops real.

        Times are totals over ``trials`` calls (the unit of
        :meth:`json_perf_statistics`), host clock around calls that end in
        a device synchronise. Returns the op name (Computation),
        ``replication``, ``ppermute`` and ``<op>_total``. Overlap of
        communication and compute makes the split approximate."""
        runners = {
            "fusedSpMM": lambda: self.fused_spmm(A, B, s_vals),
            "sddmmA": lambda: self.sddmm_a(A, B, s_vals),
            "spmmA": lambda: self.spmm_a(A, B, s_vals),
        }
        if op not in runners:
            raise ValueError(f"op must be one of {sorted(runners)}")
        times = {}
        for mode in ABLATION_MODES:
            with ablation_mode(mode):
                runners[op]()
                synchronize(self.device)
                t0 = time.perf_counter()
                for _ in range(trials):
                    runners[op]()
                synchronize(self.device)
                times[mode] = time.perf_counter() - t0
        comp = times["local"]
        return {
            op: comp,
            "replication": max(times["no_ring"] - comp, 0.0),
            "ppermute": max(times["full"] - times["no_ring"], 0.0),
            f"{op}_total": times["full"],
        }

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
            "adjacency_mode": self.grid.adjacency,
            "p": self.p,
            "c": self.c,
            "dim_interpretations": list(self.proc_grid_names),
            "dim_values": list(self.grid.dims[: len(self.proc_grid_names)]),
            "nnz_procs": self.S_tiles.nnz_per_device.reshape(-1).tolist()
            if self.S_tiles else [],
            "nnz_tpose_procs": self.ST_tiles.nnz_per_device.reshape(-1).tolist()
            if self.ST_tiles else [],
        }
