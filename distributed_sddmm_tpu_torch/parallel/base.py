"""Distributed SDDMM/SpMM strategy base: dense buffers, sparse values,
public ops and per-op counters (counterpart of ``parallel/base.py``).

A strategy runs on a world of ranks (``parallel/comm.py``) laid out on a
grid (``parallel/mesh.py``). A dense operand is float32 and split into
``p`` disjoint blocks, one a rank, each ``(block_rows, width)``: a row
block of the whole width for the dense-shift strategy (the JAX package's
``P(("rows", "cols"), None)``), a set of rows of one R-slice for the
R-split strategies (sparse shift, both Cannon variants). A strategy says
which global rows and columns each rank's block holds (:meth:`_dense_map`);
the host converters, the fills and the column skews follow from that. Under
a :class:`~distributed_sddmm_tpu_torch.parallel.comm.LocalWorld` a dense
operand is one tensor of the ``p`` blocks stacked in rank order,
``(p * block_rows, width)``, and each rank's block is a contiguous view of
it; under a ``DistWorld`` it is the process's own block. Sparse values live
in the tile layout of ``parallel/sharding.py``, one slot a rank held. Ops
return new tensors. In place of the JAX package's observability and
resilience machinery, every public op adds its call count and seconds
(host clock around the op, ending in a device synchronise) to a plain
per-op counter.
"""

from __future__ import annotations

import abc
import time

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.device import resolve_device, synchronize
from distributed_sddmm_tpu_torch.ops.autograd import FusedTile, SddmmTile, SpmmTile
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.comm import refuse_grad
from distributed_sddmm_tpu_torch.parallel.loops import ABLATION_MODES, ablation_mode
from distributed_sddmm_tpu_torch.parallel.mesh import AXES, GridSpec
from distributed_sddmm_tpu_torch.parallel.sharding import (
    BankedTileView, TileSet, TileView, packed_structure, unpack_structure,
)
from distributed_sddmm_tpu_torch.tools import costmodel


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
    #: The ``tools/costmodel.py`` model of the strategy's layout (None: no
    #: analytic model, as for the dense shift, whose ``comm_profile``
    #: counts each collective itself).
    cost_model_name: str | None = None
    #: True for the strategies that split the dense operands' R dimension.
    r_split = False
    #: The double-buffered ring build (the shift strategies that have one).
    overlap = False
    #: True while a timed call runs (``_timed``).
    _timing = False

    #: Type of the dense operands and the sparse values.
    dtype = torch.float32

    def __init__(self, M: int, N: int, R: int, c: int, world, grid: GridSpec,
                 kernel=None, device=None):
        self.device = resolve_device(device)
        self.M, self.N, self.R, self.c, self.p = M, N, R, c, grid.p
        self.world, self.grid = world, grid
        self.comm = world.comm(grid, self.device)
        #: The grid device (dense block and tile slot) of each rank held,
        #: in slot order: ``(i * nc + j) * nh + k``.
        self.blocks = [(i * grid.nc + j) * grid.nh + k for i, j, k in self.comm.coords]
        self.kernel = kernel if kernel is not None else CudaTileKernel(device=self.device)
        #: ``{op: {"calls": n, "seconds": s}}`` over the public ops.
        self.metrics: dict[str, dict] = {}
        self._maps: dict = {}
        #: Moving tiles between processes: each tile set's packed
        #: structure, and the device bands of the tiles a ring brings.
        self._packed: dict = {}
        self._bands: dict = {}
        # Subclasses set these before use:
        self.M_pad: int = -1
        self.N_pad: int = -1
        self.S_tiles: TileSet = None
        self.ST_tiles: TileSet = None

    # ---------------------------- dense buffers ---------------------------- #

    def _block_rows(self, mode: MatMode) -> int:
        n_pad = self.M_pad if mode == MatMode.A else self.N_pad
        return n_pad // (self.grid.nr * self.grid.nc)

    def _n_slices(self) -> int:
        """Into how many R-slices the strategy splits a dense operand."""
        return 1

    def _dense_map(self, mode: MatMode, width: int) -> tuple:
        """``(rows [p, block_rows], col0 [p])`` int64 numpy: the global rows
        of each grid device's block of a ``(n_pad, width)`` operand, and the
        first of the ``width / _n_slices()`` consecutive global columns it
        holds. The dense shift's: device ``d`` holds rows ``[d *
        block_rows, (d + 1) * block_rows)``, every column."""
        n = self._block_rows(mode)
        return (np.arange(self.p * n, dtype=np.int64).reshape(self.p, n),
                np.zeros(self.p, dtype=np.int64))

    def _held_map(self, mode: MatMode, width: int) -> tuple:
        """:meth:`_dense_map` of the held ranks: ``(rows, col0, block
        width)``, rows and col0 as device tensors."""
        key = (mode, width)
        if key not in self._maps:
            rows, col0 = self._dense_map(mode, width)
            self._maps[key] = (torch.from_numpy(rows[self.blocks]).to(self.device),
                               torch.from_numpy(col0[self.blocks]).to(self.device),
                               width // self._n_slices())
        return self._maps[key]

    def dense_shape(self, mode: MatMode, width: int | None = None) -> tuple:
        """The held ranks' blocks stacked: ``(held * block_rows,
        block_width)`` (the global ``(M_pad, R)`` / ``(N_pad, R)`` for the
        dense shift in one process)."""
        rows, _, w = self._held_map(mode, self.R if width is None else width)
        return (rows.numel(), w)

    def like_a_matrix(self, value: float) -> torch.Tensor:
        return torch.full(self.dense_shape(MatMode.A), value, dtype=self.dtype,
                          device=self.device)

    def like_b_matrix(self, value: float) -> torch.Tensor:
        return torch.full(self.dense_shape(MatMode.B), value, dtype=self.dtype,
                          device=self.device)

    def dummy_initialize(self, mode: MatMode) -> torch.Tensor:
        """Deterministic ``value = globalRow * R + globalCol`` fill,
        computed in float32 like the JAX package's."""
        rows, col0, w = self._held_map(mode, self.R)
        cols = col0[:, None] + torch.arange(w, device=self.device)
        out = rows.to(self.dtype)[:, :, None] * self.R + cols.to(self.dtype)[:, None, :]
        return out.reshape(-1, w)

    def _from_global(self, G: torch.Tensor, mode: MatMode) -> torch.Tensor:
        """A global-order ``(n_pad, width)`` tensor -> the held blocks."""
        rows, col0, w = self._held_map(mode, G.shape[-1])
        if not self.r_split:  # whole rows, blocks in rank order
            return G if self.comm.in_process else G.index_select(0, rows[0])
        return torch.cat([G[:, c0:c0 + w].index_select(0, r)
                          for r, c0 in zip(rows, col0.tolist())])

    def _global_index(self, mode: MatMode, width: int) -> torch.Tensor:
        """``[n_pad * n_slices]`` int64 on the device: the row of the stacked
        blocks (every rank's) that holds each (global row, R-slice), row
        major; every pair is held exactly once."""
        key = ("global", mode, width)
        if key not in self._maps:
            rows, col0 = self._dense_map(mode, width)
            n = self._n_slices()
            idx = np.empty((rows.size // n, n), dtype=np.int64)
            idx[rows, (col0 // (width // n))[:, None]] = np.arange(rows.size).reshape(rows.shape)
            self._maps[key] = torch.from_numpy(idx.reshape(-1)).to(self.device)
        return self._maps[key]

    def _to_global(self, X: torch.Tensor, mode: MatMode) -> torch.Tensor:
        """Every rank's blocks (gathered under a world of processes) -> the
        global-order ``(n_pad, width)`` tensor: one row gather, so autograd
        sees it as such."""
        X = self._all_blocks(X)
        if not self.r_split:
            return X
        width = X.shape[-1] * self._n_slices()
        return X.index_select(0, self._global_index(mode, width)).reshape(-1, width)

    def _put(self, host, mode: MatMode) -> torch.Tensor:
        host = torch.as_tensor(host).to(device=self.device, dtype=self.dtype)
        n_pad = self.M_pad if mode == MatMode.A else self.N_pad
        G = torch.zeros((n_pad, self.R), dtype=self.dtype, device=self.device)
        G[: host.shape[0]] = host
        return self._from_global(G, mode)

    def put_a(self, host) -> torch.Tensor:
        """A host ``(M, R)`` matrix (numpy or tensor), zero-padded to M_pad,
        as the held blocks."""
        return self._put(host, MatMode.A)

    def put_b(self, host) -> torch.Tensor:
        return self._put(host, MatMode.B)

    def _all_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's part of a dense operand or of the values,
        concatenated in rank order (an all-gather under a world of
        processes)."""
        if self.comm.in_process:
            return x
        return self.comm.all_gather([x], AXES)[0]

    def host_a(self, A: torch.Tensor) -> np.ndarray:
        """A in global ``(M, R)`` row order on the host, padding stripped."""
        return self._to_global(A.detach(), MatMode.A).cpu().numpy()[: self.M]

    def host_b(self, B: torch.Tensor) -> np.ndarray:
        return self._to_global(B.detach(), MatMode.B).cpu().numpy()[: self.N]

    def _blocks(self, X: torch.Tensor, mode: MatMode) -> list:
        """Each held rank's block of a dense operand (contiguous views)."""
        n = X.shape[0] // len(self.blocks)
        return [X[h * n: (h + 1) * n] for h in range(len(self.blocks))]

    def _assemble(self, blocks: list) -> torch.Tensor:
        """The inverse of :meth:`_blocks` for an output."""
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks)

    # ---------------------------- local kernels ---------------------------- #

    @property
    def _tiled(self) -> bool:
        return getattr(self.kernel, "is_tiled", False)

    def _prep(self, x):
        return self.kernel.prep(x) if self._tiled else x

    def _prep_each(self, xs: list) -> list:
        """The kernel's type of each block, cast once per distinct tensor
        (ranks that share a gathered block share its cast)."""
        done: dict = {}
        for x in xs:
            if id(x) not in done:
                done[id(x)] = self._prep(x)
        return [done[id(x)] for x in xs]

    def _grad(self, *xs) -> bool:
        """True when autograd must see this kernel call: grad mode is on and
        an operand requires grad. A world of processes refuses (its
        collectives are not differentiable)."""
        if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
            return False
        if not self.comm.in_process:
            refuse_grad()
        return True

    def _k_sddmm(self, t: TileView, vals, at, bt):
        """One tile's SDDMM: the tile kernel (through :class:`SddmmTile`
        when a grad is wanted), or the flat protocol."""
        grad = self._grad(vals, at, bt)
        if not self._tiled:
            return self.kernel.sddmm(t.rows, t.cols, vals, at, bt)
        if grad:
            return SddmmTile.apply(self.kernel, t, vals, at, bt)
        return self.kernel.sddmm_tile(t, vals, at, bt)

    def _k_spmm(self, t: TileView, vals, bt):
        grad = self._grad(vals, bt)
        if not self._tiled:
            return self.kernel.spmm(t.rows, t.cols, vals, bt, t.n_rows)
        if grad:
            return SpmmTile.apply(self.kernel, t, vals, bt)
        return self.kernel.spmm_tile(t, vals, bt)

    def _k_fused(self, t: TileView, vals, at, bt):
        grad = self._grad(vals, at, bt)
        if not self._tiled:
            mid = self.kernel.sddmm(t.rows, t.cols, vals, at, bt)
            return self.kernel.spmm(t.rows, t.cols, mid, bt, t.n_rows), mid
        if grad:
            return FusedTile.apply(self.kernel, t, vals, at, bt)
        return self.kernel.fused_tile(t, vals, at, bt)

    # ---------------------------- moving tiles ----------------------------- #
    # The sparse shift and the dense-replicating Cannon strategies send the
    # tile itself round a ring. In one process a hop relabels: the ring
    # carries the held ranks' tile views, and a rank receives the view its
    # neighbour held. Between processes it carries each tile's structure
    # packed in one int32 vector (``row_ptr``, ``rows``, ``cols``; every
    # tile of a set has one frame and one cap). A banked tile's row bands
    # are the host banding's of the tile that arrived: every process built
    # the banding of the whole set, so the receiver moves the bands of the
    # tiles its ring brings to the device once and looks them up by the
    # sending device, which the ring step fixes.

    def _tile_states(self, tiles: TileSet) -> list:
        """What a ring carries of each held rank's own tile."""
        views = [tiles.tile(h, 0) for h in range(len(self.blocks))]
        if self.comm.in_process:
            return views
        if id(tiles) not in self._packed:
            self._packed[id(tiles)] = [packed_structure(v) for v in views]
        return self._packed[id(tiles)]

    def _tile_view(self, tiles: TileSet, state, src: int) -> TileView:
        """The tile a rank holds: ``state`` as the ring brought it, which
        grid device ``src`` sent (under the full program)."""
        if self.comm.in_process:
            return state
        view = unpack_structure(state, tiles.tile(0, 0))
        if tiles.bands is None:
            return view
        key = (id(tiles), src)
        if key not in self._bands:
            self._bands[key] = tuple(b.to(self.device) for b in
                                     tiles.banding.tiles[src * tiles.n_tiles])
        return BankedTileView(view.row_ptr, view.rows, view.cols, view.n_rows,
                              view.n_cols, bands=self._bands[key])

    # ---------------------------- sparse values ---------------------------- #

    def like_s_values(self, value: float) -> torch.Tensor:
        return self.S_tiles.like_values(value)

    def like_st_values(self, value: float) -> torch.Tensor:
        return self.ST_tiles.like_values(value)

    def scatter_s_values(self, host_vals) -> torch.Tensor:
        return self.S_tiles.scatter_values(host_vals)

    def gather_s_values(self, dev_vals: torch.Tensor) -> np.ndarray:
        return self.S_tiles.gather_values(self._all_blocks(dev_vals.detach()))

    def scatter_st_values(self, host_vals) -> torch.Tensor:
        return self.ST_tiles.scatter_values(host_vals)

    def gather_st_values(self, dev_vals: torch.Tensor) -> np.ndarray:
        return self.ST_tiles.gather_values(self._all_blocks(dev_vals.detach()))

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
        """Pre-skew dense operands where the strategy needs it (identity;
        the Cannon strategies move their moving operand)."""
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
        """Resident layout -> global column order. The identity for the
        dense shift, whose blocks hold whole rows (each process projects
        its own). An R-split strategy's block holds some columns of some
        rows (and the sparse-replicating Cannon's a skewed choice of them):
        there it is the global ``(n_pad, width)`` operand, gathered under a
        world of processes."""
        return self._to_global(X, mode) if self.r_split else X

    def _skew_cols(self, X: torch.Tensor, mode: MatMode) -> torch.Tensor:
        """Global column order -> resident layout (the inverse)."""
        return self._from_global(X, mode) if self.r_split else X

    def batch_dot(self, x: torch.Tensor, y: torch.Tensor, mode: MatMode) -> torch.Tensor:
        """Per-row dot products of two operands in the canonical layout, one
        a row of the held blocks (``x.shape[:-1]``): the whole row's dot
        wherever its R-slices lie. The dense shift's blocks hold whole
        rows; an R-split strategy sums the partial dots of the blocks that
        hold the same rows (the psum over the R-split axis that XLA
        inserts in the JAX package): by the dense map in one process, by
        an all-reduce over ``r_split_axis`` between processes. Each (row,
        R-slice) is counted once."""
        part = torch.sum(x * y, dim=-1)
        if not self.r_split:
            return part
        if not self.comm.in_process:
            return self.comm.all_reduce([part], self.r_split_axis)[0]
        rows = self._held_map(mode, x.shape[-1] * self._n_slices())[0].reshape(-1)
        n_pad = self.M_pad if mode == MatMode.A else self.N_pad
        full = part.new_zeros(n_pad).index_add(0, rows, part)
        return full.index_select(0, rows)

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
        heads = [self._unskew_cols(h, mode) for h in heads]
        self.set_r_value(sum(h.shape[-1] for h in heads))
        return self._skew_cols(torch.cat(heads, dim=-1), mode)

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
        """Run ``fn(*args)`` as the op ``name``: host clock around the call
        and a device synchronise, added to ``metrics[name]``. A call inside
        another timed call (a public op inside an app's unit of work: an
        ALS CG iteration, a GAT layer) runs untimed, so the unit is what
        the counters show and it synchronises once."""
        if self._timing:
            return fn(*args)
        t0 = time.perf_counter()
        self._timing = True
        try:
            out = fn(*args)
        finally:
            self._timing = False
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

    def comm_profile(self, op: str, pairs: float = 1.0) -> list[dict]:
        """Per-call collective profile, the JAX base's: one ``modeled``
        entry of the strategy's analytic model (``tools/costmodel.py``),
        its pair volume scaled by the op's pair fraction, priced at the
        float32 wire's 4 bytes a word; empty for an op the model does not
        cover, a strategy without a model or a grid it cannot price. A
        ``LocalWorld`` moves none of it."""
        model = self.cost_model_name
        frac = costmodel.OP_PAIRS.get(op)
        if model is None or frac is None or self.S_tiles is None:
            return []
        try:
            words = costmodel.pair_words(model, self.M_pad, self.N_pad, self.R,
                                         self.S_tiles.nnz, self.p, self.c)
        except ValueError:
            return []
        return [{"collective": "modeled", "axis": None, "count": 0,
                 "words": words * frac * pairs, "bytes": 4.0 * words * frac * pairs,
                 "in_model": True}]

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
