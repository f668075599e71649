"""Time the SDDMM, fused and SpMM tile kernels, the attention stats kernel,
the heavy rows' second pass and the serve kernels of several source trees
on the same inputs, on one card, in turns.

    python3 -m distributed_sddmm_tpu_torch.bench.kernel_ab LABEL=TREE ... [-o FILE]
        [--only-pass2 | --only-serve] [--chunks C,...]

A TREE is a directory that holds ``distributed_sddmm_tpu_torch/ops/`` (its
``_build.py`` and ``csrc/``): this checkout (``new=.``), or an older
commit's kernels unpacked under a gitignored directory::

    mkdir -p .chip_archive/parent
    git archive <commit> distributed_sddmm_tpu_torch/ops | tar -x -C .chip_archive/parent

Each tree's kernels build into that tree's own ``_build/`` and load with
ctypes; every tree is called through the same C entry points (the C ABI
of ``_build.SIGNATURES``) on the tiles and operands this checkout builds,
R=128 unless named, standard-normal operands, f32 and bf16:

* ``headline`` and ``full``: the uniform R-mat at log_m=16 and 20
  (edge_factor 32), the ``DenseShift15D`` S tile: ``sddmm_tile``,
  ``fused_tile``, ``spmm_tile``; at log_m=16 also R = 32, 64, 256, 512;
* ``window64``: the ``window:64`` attention tile at 2**20 tokens:
  ``sddmm_tile``, ``spmm_tile``, and ``attn_stats_tile`` (f32) on
  standard-normal logits with 10% of the gates zeroed; ``window16``: the
  attention headline's ``window:16`` tile at 2**16 tokens,
  ``attn_stats_tile``;
* ``graph500_16`` and ``graph500_20``: the Graph500 R-mat banded by its
  selected variant: the row-list bands (``sddmm_rows``, ``fused_rows``,
  ``spmm_rows``, a launch per band as the banked op makes them) and the
  heavy band's pass 1 (``sddmm_split``, ``fused_split``, ``spmm_split``);
* ``bigbird_16`` and ``bigbird_20``: the ``bigbird:w=8,g=2,r=2``
  attention tile at 2**16 and 2**20 tokens banked by its selected
  variant: the stats of the row-list bands (``attn_stats_rows``) and of
  the heavy band's segments (``attn_stats_split``), f32, on logits and
  gates as for ``window64``; these lines also time this checkout's plain
  version (``plain_ms``) and ``torch.sparse.softmax`` of the same rows
  (``library_ms``, stats and weights: a yardstick the port never calls);
* the heavy band's second pass, f32: ``split_reduce`` on ``graph500_16``,
  ``graph500_20``, ``bigbird_16`` and ``bigbird_20`` (the same mask at
  2**20 tokens), on a standard-normal workspace ``[n_seg, R]``, and
  ``attn_stats_merge`` on ``bigbird_16`` and ``bigbird_20``, on the
  segment stats that ``attn_stats_split`` gives for the inputs above.
  Each tree gets the inputs of its own C entry point (the signature in
  its ``_build.SIGNATURES``: the parent's kernels take the segment table,
  these the unit table of ``codegen/banded.py``). These lines also carry
  ``launch_floor_ms``, a one-element ``zero_()`` timed the same way in
  the same case, and ``graph_ms``, each tree's and the floor's device
  time a launch when ``REPS`` launches are captured in one CUDA graph and
  replayed (no host time between launches). With ``--chunks``, the trees
  of the current entry points are timed again with the unit table built
  at each of those chunk sizes (``codegen/banded.py::REDUCE_CHUNK``).
  They carry ``plain_ms`` too, this checkout's plain version;
* the serve kernels (``ops/csrc/serve_kernels.cu``), f32, standard-normal
  operands: ``score_rows`` at the ALS scores (8 queries x 2**20 items,
  R = 128, into an ``out`` of ld N + 1 as ``serve/workloads.py`` makes it;
  again at 2 and 1 queries, ``als_b2`` and ``als_b1``, the batches that a
  100 Hz stream mostly makes) and at the GAT head (1 query x 512 nodes
  gathered through ``tidx`` from 2**20 rows of 512 features), and
  ``fold_in_solve`` at 8 requests, L = 64, R = 128, on the ALS factor,
  each request's rated slots drawn as the ALS workload draws a payload
  (1 + Poisson(4)), and at the first 2 and 1 of them (``fold_in_b2``,
  ``fold_in_b1``). Each tree gets the
  arguments of its own entry point, shaped by its own
  ``ops/serve_kernels.py`` (``score_launch`` and ``fold_in_launch``; the
  parent's ``score_rows`` takes its shared memory alone, and its
  ``fold_in_solve`` a thread a row). Besides the trees' readings these
  lines carry ``max_abs_diff_vs_plain`` (each tree against
  this checkout's plain version: 0.0 is bit-equal),
  ``two_launches_equal``, ``bound_ms`` and ``bound_by`` (the bytes the
  call needs over the HBM rate, or its operations over the f32 rate),
  ``library_ms`` (``x @ B.T``; ``X[nodes] @ w``: yardsticks the port never
  calls) and for ``fold_in_solve`` ``torch_ms`` (the torch composition:
  ``bmm`` Gram, ``cholesky``, ``cholesky_solve``) and ``latency_floor_ms``:
  the kernel's chain of 3R dependent steps, R Cholesky columns each
  ending in ``__fsqrt_rn`` and R steps of each substitution each an
  ``__fdiv_rn``, every step behind at least one ``__fadd_rn``: R (t_sqrt +
  t_add) + 2R (t_div + t_add), with each t the time of one dependent step
  of a chain of ``LATENCY_STEPS`` in one thread (``step_ns``: the kernel of
  ``bench/csrc/step_latency.cu``, built beside the kernels).

Each case runs the trees in the order given, then in reverse (A B B A),
each reading CUDA events around ``REPS`` calls after a warmup call. It
prints one JSON line per case: each tree's two readings (ms per call),
the largest difference of its outputs from the first tree's, absolute
(``max_abs_diff_vs_first``: 0.0 where they agree bit for bit) and over
the largest magnitude (``rel_diff_vs_first``); for the stats also
whether ``m`` equals the first tree's and the largest relative difference
of each ``d`` (``d_rel_diff_vs_first``). The first line names the card
and its power limit; the second gives each tree's build time and the
ptxas report (registers, spills) of its walk, pass-2 and serve kernels. With
``-o`` the lines are also appended to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

from distributed_sddmm_tpu_torch import masks
from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.bench.harness import make_algorithm
from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel, banded, select_variant
from distributed_sddmm_tpu_torch.ops import _build, cuda_kernels, serve_kernels
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

REPS = 20
#: HBM rate of one H100 SXM (NVIDIA data sheet), for the bounds of the
#: banked stats and pass-2 lines.
HBM_BYTES_PER_S = 3.35e12
#: (case, log_m) of the uniform R-mat tiles, the attention tile's (log2
#: tokens, mask) and the Graph500 R-mat sizes.
RMAT = (("headline", 16), ("full", 20))
WINDOW = (20, "window:64")
WINDOW16 = (16, "window:16")
BIGBIRD = (16, "bigbird:w=8,g=2,r=2")
BIGBIRD_LOG_NS = (16, 20)
#: Arguments of the pass-2 entry points that take the segment table (the
#: kernels before the unit table).
PARENT_ARGS = {"split_reduce": 7, "attn_stats_merge": 8}
GRAPH500_LOG_MS = (16, 20)
R_MAIN = 128
R_SWEEP = (32, 64, 256, 512)
GRAPH500 = {"a": 0.57, "b": 0.19, "c": 0.19, "d": 0.05}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: f32 rate of one H100 SXM outside the tensor cores (NVIDIA data sheet).
F32_FLOP_PER_S = 67e12
#: Serve cases: the ALS scores (queries, items, R), the GAT head (queries,
#: nodes, rows, features), the fold-in on the ALS factor (requests, L).
SERVE_ALS = (8, 1 << 20, 128)
SERVE_GAT = (1, 512, 1 << 20, 512)
#: Batch sizes of the ALS scores and the fold-in: the full batch, and the
#: one or two requests that most batches of a 100 Hz stream hold.
SERVE_ALS_BATCHES = (8, 2, 1)
SERVE_FOLD = (8, 64)
LATENCY_STEPS = 1 << 20


def load_tree(root: str) -> dict:
    """Build and load one tree's kernel library."""
    path = pathlib.Path(root).resolve() / "distributed_sddmm_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_tree_build_{abs(hash(str(path)))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    info = mod.build()
    lib = ctypes.CDLL(info["path"])
    for name, argtypes in mod.SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tile_error_string.argtypes = [ctypes.c_int]
    lib.tile_error_string.restype = ctypes.c_char_p
    # The tree's serve wrappers, for their launch shapes alone.
    path = path.with_name("serve_kernels.py")
    spec = importlib.util.spec_from_file_location(f"_tree_serve_{abs(hash(str(path)))}", path)
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)
    walks = {k: v for k, v in _build.ptxas_report(info["log"]).items()
             if any(n in k for n in ("walk_kernel", "split_reduce", "attn_merge",
                                     "fold_in_solve", "score_rows"))}
    return {"lib": lib, "sigs": mod.SIGNATURES, "serve": serve, "build_seconds": info["seconds"],
            "cached": info["cached"], "walk_ptxas": walks}


def _call(lib, name: str, *args) -> None:
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.tile_error_string(rc).decode()})")


def _p(t):
    return None if t is None else t.data_ptr()


def _alloc(shape, zero: bool, dev):
    return (torch.zeros if zero else torch.empty)(shape, dtype=torch.float32, device=dev)


def run_op(lib, op: str, tile, bands, sv, at, bt, zero: bool):
    """One call of ``op`` as the port's wrapper (or the banked op, for a
    band kind) makes it; returns the outputs it writes. ``zero``: outputs
    start at 0, so the unwritten parts compare equal."""
    dev = sv.device
    R, bf16 = bt.shape[1], int(bt.dtype == torch.bfloat16)
    vec = int(R % 4 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, cap = tile.n_rows, tile.cap
    common = (_p(tile.cols), _p(sv))
    if op == "sddmm_tile":
        mid = _alloc(cap, zero, dev)
        _call(lib, op, _p(tile.row_ptr), None, *common, _p(at), _p(bt), _p(mid), n, n, cap,
              1, R, bf16, vec, stream)
        return (mid,)
    if op == "spmm_tile":
        out = _alloc((n, R), zero, dev)
        _call(lib, op, _p(tile.row_ptr), None, *common, _p(bt), _p(out), n, R, bf16, vec,
              stream)
        return (out,)
    if op == "fused_tile":
        mid, out = _alloc(cap, zero, dev), _alloc((n, R), zero, dev)
        _call(lib, op, _p(tile.row_ptr), None, *common, _p(at), _p(bt), _p(out), _p(mid),
              n, n, cap, 1, R, bf16, vec, stream)
        return out, mid
    lists = [b for b in bands if not b.heavy]
    heavy = [b for b in bands if b.heavy]
    mid = _alloc(cap, zero, dev)
    if op in ("sddmm_rows", "fused_rows", "spmm_rows"):
        out = _alloc((n, R), zero, dev) if op != "sddmm_rows" else None
        for i, b in enumerate(lists):
            if op == "sddmm_rows":
                _call(lib, "sddmm_tile", _p(tile.row_ptr), _p(b.rows), *common, _p(at),
                      _p(bt), _p(mid), b.n_rows, n, cap, int(i == 0), R, bf16, vec, stream)
            elif op == "spmm_rows":
                _call(lib, "spmm_tile", _p(tile.row_ptr), _p(b.rows), *common, _p(bt),
                      _p(out), b.n_rows, R, bf16, vec, stream)
            else:
                _call(lib, "fused_tile", _p(tile.row_ptr), _p(b.rows), *common, _p(at),
                      _p(bt), _p(out), _p(mid), b.n_rows, n, cap, int(i == 0), R, bf16,
                      vec, stream)
        return {"sddmm_rows": (mid,), "spmm_rows": (out,)}.get(op, (out, mid))
    hb = heavy[0]
    seg = (_p(hb.seg_row), _p(hb.seg_beg), _p(hb.seg_end))
    if op == "spmm_split":
        work = _alloc((hb.n_seg, R), zero, dev)
        _call(lib, op, *seg, *common, _p(bt), _p(work), hb.n_seg, R, bf16, vec, stream)
        return (work,)
    if op == "sddmm_split":
        _call(lib, op, _p(tile.row_ptr), *seg, *common, _p(at), _p(bt), _p(mid), hb.n_seg,
              n, cap, 0, R, bf16, vec, stream)
        return (mid,)
    work = _alloc((hb.n_seg, R), zero, dev)
    _call(lib, op, _p(tile.row_ptr), *seg, *common, _p(at), _p(bt), _p(work), _p(mid),
          hb.n_seg, n, cap, 0, R, bf16, vec, stream)
    return work, mid


def run_stats(lib, op: str, tile, bands, gate, z, zero: bool):
    """One call of an attention stats op as the port's wrapper (or the
    banked op, for a band kind) makes it; returns ``(m, d)``."""
    dev = gate.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = tile.n_rows
    if op == "attn_stats_split":
        hb = next(b for b in bands if b.heavy)
        wm, wd = _alloc(hb.n_seg, zero, dev), _alloc(hb.n_seg, zero, dev)
        _call(lib, op, _p(hb.seg_beg), _p(hb.seg_end), _p(gate), _p(z), _p(wm), _p(wd),
              hb.n_seg, stream)
        return wm, wd
    m, d = _alloc(n, zero, dev), _alloc(n, zero, dev)
    if op == "attn_stats_tile":
        _call(lib, op, _p(tile.row_ptr), None, _p(gate), _p(z), _p(m), _p(d), n, stream)
    for b in (b for b in bands if not b.heavy):  # attn_stats_rows
        _call(lib, "attn_stats_tile", _p(tile.row_ptr), _p(b.rows), _p(gate), _p(z), _p(m),
              _p(d), b.n_rows, stream)
    return m, d


def pass2_args(tree: dict, op: str, band, inp: dict, out: dict) -> tuple:
    """The C arguments but the stream (the last) of one pass-2 call by
    ``tree``'s entry point: the parent's (the segment table, PARENT_ARGS
    arguments) or the unit table's."""
    old = len(tree["sigs"][op]) == PARENT_ARGS[op]
    if op == "split_reduce":
        work, dst = inp["work"], out["out"]
        R = dst.shape[1]
        if old:
            return _p(band.seg_ptr), _p(band.rows), _p(work), _p(dst), band.n_rows, R
        return (*unit_ptrs(band), _p(work), _p(dst), _p(out["partial"]), band.n_short,
                band.n_units, band.chunk, R, int(R % 4 == 0))
    wm, wd, m, d = inp["wm"], inp["wd"], out["m"], out["d"]
    if old:
        return _p(band.seg_ptr), _p(band.rows), _p(wm), _p(wd), _p(m), _p(d), band.n_rows
    return (*unit_ptrs(band), _p(wm), _p(wd), _p(m), _p(d), _p(out["partial"]),
            band.n_short, band.n_units, band.chunk)


def unit_ptrs(band) -> tuple:
    return (_p(band.seg_ptr), _p(band.rows), _p(band.unit_row), _p(band.unit_beg),
            _p(band.unit_end), _p(band.counters))


def graph_ms(make, reps: int = REPS):
    """Device ms a call when ``reps`` calls are captured in one CUDA graph
    and replayed: ``make()`` gives the call, bound to the stream current
    when it is made (the graph captures on its own). ``(ms, None)``, or
    ``(None, reason)`` where the capture fails."""
    try:
        make()()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn = make()
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, str(e).strip().splitlines()[0]
    return time_ms(g.replay, 3) / reps, None


def time_ms(fn, reps: int = REPS) -> float:
    """Device ms per call: CUDA events around ``reps`` calls after a warmup."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_diff(got, want) -> float:
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def abs_diff(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def in_turns(trees: dict, run) -> dict:
    """Each tree's two readings of ``run(lib)``, trees in order then
    reversed."""
    ms = {label: [] for label in trees}
    for label in [*trees, *reversed(trees)]:
        lib = trees[label]["lib"]
        ms[label].append(time_ms(lambda: run(lib)))
    return ms


def compare(trees: dict, case: str, op: str, tile, bands, sv, A, B, emit) -> None:
    """Every tree on one case, in turns; one JSON line per precision."""
    nnz = int(tile.row_ptr[-1])
    for prec, dtype in DTYPES.items():
        at, bt = A.to(dtype).contiguous(), B.to(dtype).contiguous()
        first = None
        diffs, abs_diffs = {}, {}
        for label, t in trees.items():
            got = run_op(t["lib"], op, tile, bands, sv, at, bt, zero=True)
            torch.cuda.synchronize()
            first = got if first is None else first
            diffs[label] = rel_diff(got, first)
            abs_diffs[label] = abs_diff(got, first)
            del got
        ms = in_turns(trees, lambda lib: run_op(lib, op, tile, bands, sv, at, bt,
                                                 zero=False))
        emit({"case": case, "op": op, "precision": prec, "R": B.shape[1], "nnz": nnz,
              "ms": ms, "max_abs_diff_vs_first": abs_diffs, "rel_diff_vs_first": diffs})


def band_coo(tile, z, bands, n_cols: int):
    """The band rows' logits as a coalesced COO matrix (for
    ``torch.sparse.softmax``)."""
    rows = torch.cat([b.rows for b in bands]).long()
    slots, owner = cuda_kernels._ranges(tile.row_ptr[rows], tile.row_ptr[rows + 1])
    idx = torch.stack([owner, tile.cols[slots].long()])
    return torch.sparse_coo_tensor(idx, z[slots], (rows.numel(), n_cols),
                                   check_invariants=False).coalesce()


def stats_yardsticks(op: str, tile, bands, gate, z) -> dict:
    """This checkout's plain version of a banked stats op and one
    ``torch.sparse.softmax`` call over the same rows, ms a call."""
    dev = gate.device
    if op == "attn_stats_split":
        hb = [b for b in bands if b.heavy]

        def plain():
            cuda_kernels.attn_stats_split_plain(tile, hb[0], gate, z)
    else:
        hb = [b for b in bands if not b.heavy]
        m, d = _alloc(tile.n_rows, False, dev), _alloc(tile.n_rows, False, dev)

        def plain():
            for b in hb:
                cuda_kernels.attn_stats_rows_plain(tile, b, gate, z, m, d)
    coo = band_coo(tile, z, hb, tile.n_cols)
    return {"plain_ms": time_ms(plain, 3),
            "library_ms": time_ms(lambda: torch.sparse.softmax(coo, 1))}


def compare_stats(trees: dict, case: str, op: str, tile, bands, gate, z, emit) -> None:
    """Every tree on one attention stats case, in turns; one JSON line."""
    first = None
    diffs, abs_diffs, m_equal, d_rel = {}, {}, {}, {}
    for label, t in trees.items():
        got = run_stats(t["lib"], op, tile, bands, gate, z, zero=True)
        torch.cuda.synchronize()
        first = got if first is None else first
        diffs[label] = rel_diff(got, first)
        abs_diffs[label] = abs_diff(got, first)
        m_equal[label] = torch.equal(got[0], first[0])
        d_rel[label] = float(((got[1] - first[1]).abs()
                              / first[1].abs().clamp_min(1e-30)).max())
    ms = in_turns(trees, lambda lib: run_stats(lib, op, tile, bands, gate, z, zero=False))
    # Bound: 8 B a slot read; 12 B a row (row_ptr, m, d) or 16 a segment.
    if op == "attn_stats_split":
        hb = next(b for b in bands if b.heavy)
        moved = 8 * hb.n_slots + 16 * hb.n_seg
    elif bands:
        lists = [b for b in bands if not b.heavy]
        moved = sum(8 * b.n_slots + 12 * b.n_rows for b in lists)
    else:
        moved = 8 * int(tile.row_ptr[-1]) + 12 * tile.n_rows
    extra = stats_yardsticks(op, tile, bands, gate, z) if bands else {}
    emit({"case": case, "op": op, "precision": "f32", "nnz": int(tile.row_ptr[-1]),
          "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "ms": ms, "max_abs_diff_vs_first": abs_diffs, "rel_diff_vs_first": diffs,
          "m_equal_to_first": m_equal, "d_rel_diff_vs_first": d_rel, **extra})


def compare_pass2(trees: dict, case: str, op: str, band, inp: dict, emit,
                  chunks=()) -> None:
    """Every tree on one pass-2 case (f32), in turns; one JSON line, then
    one a chunk size of ``chunks`` for the trees of the current entry
    points. Outputs are preallocated, so a timed call is the C call."""
    dev = band.rows.device
    n_out = int(band.rows.max()) + 1 if band.n_rows else 1
    R = inp["work"].shape[1] if op == "split_reduce" else None

    def outputs(b, zero: bool):
        n_part = b.n_units - b.n_short
        if op == "split_reduce":
            return {"out": _alloc((n_out, R), zero, dev),
                    "partial": _alloc((max(n_part, 1), R), False, dev)}
        return {"m": _alloc(n_out, zero, dev), "d": _alloc(n_out, zero, dev),
                "partial": _alloc((2, max(n_part, 1)), False, dev)}

    rows = band.rows.long()
    floor = torch.zeros(1, device=dev)
    for chunk in (None, *chunks):
        b = band if chunk is None else dataclasses.replace(
            band, chunk=chunk, unit_row=None, unit_beg=None, unit_end=None,
            counters=None).to(dev)
        sel = {label: t for label, t in trees.items()
               if chunk is None or len(t["sigs"][op]) != PARENT_ARGS[op]}
        first = None
        abs_diffs, diffs, equal_runs, calls = {}, {}, {}, {}
        for label, t in sel.items():
            o = outputs(b, zero=True)
            args = pass2_args(t, op, b, inp, o)
            runs = []
            for _ in range(2):
                _call(t["lib"], op, *args, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                runs.append(tuple(v[rows].clone() for k, v in o.items() if k != "partial"))
            equal_runs[label] = all(torch.equal(x, y) for x, y in zip(*runs))
            got = runs[0]
            first = got if first is None else first
            abs_diffs[label] = abs_diff(got, first)
            diffs[label] = rel_diff(got, first)
            calls[label] = (getattr(t["lib"], op), args, o)  # o: keeps args' memory

        def maker(label):
            """The C call on the stream current when the call is made."""
            fn, args, _ = calls[label]

            def make():
                bound = (*args, torch.cuda.current_stream().cuda_stream)
                return lambda: fn(*bound)
            return make

        ms = {label: [] for label in sel}
        for label in [*sel, *reversed(sel)]:
            ms[label].append(time_ms(maker(label)()))
        graph, graph_err = {}, {}
        for label in sel:
            graph[label], err = graph_ms(maker(label))
            if err:
                graph_err[label] = err
        moved = (b.n_seg * R * 4 + b.n_rows * (8 + R * 4) if op == "split_reduce"
                 else 8 * b.n_seg + 16 * b.n_rows)
        line = {"case": case, "op": op, "precision": "f32", "R": R, "rows": b.n_rows,
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "segments": b.n_seg, "chunk": b.chunk, "units": b.n_units,
                "short_rows": b.n_short, "ms": ms, "launch_floor_ms": [
                    time_ms(floor.zero_), time_ms(floor.zero_)],
                "graph_ms": graph,
                "graph_launch_floor_ms": graph_ms(lambda: floor.zero_)[0],
                "max_abs_diff_vs_first": abs_diffs, "rel_diff_vs_first": diffs,
                "two_launches_equal": equal_runs,
                "counters_zero": bool((b.counters == 0).all())}
        if graph_err:
            line["graph_error"] = graph_err
        if chunk is None:
            o = outputs(b, zero=False)
            if op == "split_reduce":
                line["plain_ms"] = time_ms(
                    lambda: cuda_kernels.split_reduce_plain(b, inp["work"], o["out"]), 3)
            else:
                line["plain_ms"] = time_ms(lambda: cuda_kernels.attn_stats_merge_plain(
                    b, inp["wm"], inp["wd"], o["m"], o["d"]), 3)
        emit(line)


def pass2_inputs(tile, alg, dev, seed: int, stats: bool) -> tuple:
    """The heavy band and its pass-2 inputs: a standard-normal workspace,
    and for the stats the segment pairs of ``attn_stats_split`` (this
    checkout's)."""
    hb = next(b for b in tile.bands if b.heavy)
    gen = torch.Generator(device=dev).manual_seed(seed)
    inp = {"work": torch.randn(hb.n_seg, R_MAIN, generator=gen, device=dev)}
    if stats:
        gate, z = stats_inputs(alg, dev, seed)
        inp["wm"], inp["wd"] = cuda_kernels.attn_stats_split(tile, hb, gate, z)
    return hb, inp


def operands(alg, R: int, dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tiles = alg.S_tiles
    A = torch.randn(alg.M_pad, R, generator=gen, device=dev)
    B = torch.randn(alg.N_pad, R, generator=gen, device=dev)
    sv = (tiles.mask * torch.randn(tiles.shape, generator=gen, device=dev))[0, 0].contiguous()
    return sv, A, B


def stats_inputs(alg, dev, seed: int):
    """Standard-normal logits and gates with 10% zeroed (0 at pads)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    real = alg.S_tiles.mask[0, 0]
    z = torch.randn(real.shape, generator=gen, device=dev) * real
    gate = real * (torch.rand(real.shape, generator=gen, device=dev) >= 0.1)
    return gate.contiguous(), z.contiguous()


def run_cases(trees: dict, dev, emit, chunks=(), pass2_only: bool = False) -> None:
    """Every case of the module docstring, each tree in turns; with
    ``pass2_only`` the second-pass cases alone."""
    if not pass2_only:
        walk_cases(trees, dev, emit)
    banked_cases(trees, dev, emit, chunks, pass2_only)
    if not pass2_only:
        serve_cases(trees, dev, emit)


def walk_cases(trees: dict, dev, emit) -> None:
    """The uniform R-mat and window cases."""
    for case, log_m in RMAT:
        S = HostCOO.rmat(log_m, 32, device=dev)
        alg = make_algorithm("15d_fusion2", S, R_MAIN,
                             kernel=CudaTileKernel("f32", device=dev), device=dev)
        tile = alg.S_tiles.tile(0, 0)
        for R in (R_MAIN, *R_SWEEP) if case == "headline" else (R_MAIN,):
            sv, A, B = operands(alg, R, dev, seed=0)
            for op in ("sddmm_tile", "fused_tile", "spmm_tile"):
                compare(trees, case, op, tile, (), sv, A, B, emit)
        del alg, tile, sv, A, B, S
    S = masks.from_spec(WINDOW[1], 1 << WINDOW[0])
    alg = make_algorithm("15d_fusion2", S, R_MAIN, kernel=CudaTileKernel("f32", device=dev),
                         device=dev, attention=True)
    tile = alg.S_tiles.tile(0, 0)
    sv, A, B = operands(alg, R_MAIN, dev, seed=0)
    for op in ("sddmm_tile", "spmm_tile"):
        compare(trees, "window64", op, tile, (), sv, A, B, emit)
    compare_stats(trees, "window64", "attn_stats_tile", tile, (), *stats_inputs(alg, dev, 1),
                  emit)
    del alg, tile, sv, A, B, S
    S = masks.from_spec(WINDOW16[1], 1 << WINDOW16[0])
    alg = make_algorithm("15d_fusion2", S, R_MAIN, kernel=CudaTileKernel("f32", device=dev),
                         device=dev, attention=True)
    compare_stats(trees, "window16", "attn_stats_tile", alg.S_tiles.tile(0, 0), (),
                  *stats_inputs(alg, dev, 1), emit)
    del alg, S


def banked_cases(trees: dict, dev, emit, chunks, pass2_only: bool) -> None:
    """The Graph500 and bigbird cases."""
    for log_m in GRAPH500_LOG_MS:
        S = HostCOO.rmat(log_m, 32, **GRAPH500, device=dev)
        variant = select_variant(Problem.from_coo(S, R_MAIN))
        alg = make_algorithm("15d_fusion2", S, R_MAIN,
                             kernel=BankedCudaKernel(variant, "f32", device=dev), device=dev)
        tile = alg.S_tiles.tile(0, 0)
        if not pass2_only:
            sv, A, B = operands(alg, R_MAIN, dev, seed=0)
            for op in ("sddmm_rows", "fused_rows", "spmm_rows", "sddmm_split",
                       "fused_split", "spmm_split"):
                compare(trees, f"graph500_{log_m}", op, tile, tile.bands, sv, A, B, emit)
            del sv, A, B
        hb, inp = pass2_inputs(tile, alg, dev, 4, stats=False)
        compare_pass2(trees, f"graph500_{log_m}", "split_reduce", hb, inp, emit, chunks)
        del alg, tile, S, hb, inp
    for log_n in BIGBIRD_LOG_NS:
        S = masks.from_spec(BIGBIRD[1], 1 << log_n)
        variant = select_variant(Problem.from_coo(S, R_MAIN))
        alg = make_algorithm("15d_fusion2", S, R_MAIN,
                             kernel=BankedCudaKernel(variant, "f32", device=dev), device=dev,
                             attention=True)
        tile = alg.S_tiles.tile(0, 0)
        if not pass2_only:
            gate, z = stats_inputs(alg, dev, 2)
            for op in ("attn_stats_rows", "attn_stats_split"):
                compare_stats(trees, f"bigbird_{log_n}", op, tile, tile.bands, gate, z, emit)
        hb, inp = pass2_inputs(tile, alg, dev, 4, stats=True)
        for op in ("split_reduce", "attn_stats_merge"):
            compare_pass2(trees, f"bigbird_{log_n}", op, hb, inp, emit, chunks)
        del alg, tile, S, hb, inp


def score_args(tree: dict, Q, T, tidx, out, sms: int) -> tuple:
    """The C arguments but the stream of one ``score_rows`` call by
    ``tree``'s entry point, shaped by the tree's own wrapper module (the
    parent's takes its shared memory alone)."""
    n_i, R = Q.shape
    n_j = T.shape[0] if tidx is None else tidx.numel()
    head = (_p(Q), _p(T), _p(tidx), _p(out), n_i, n_j, R, out.shape[1], T.shape[0])
    serve = tree["serve"]
    if not hasattr(serve, "score_launch"):
        return (*head, serve.score_smem_bytes(n_i, R))
    shape = serve.score_launch(n_i, n_j, R, sms)
    return (*head, shape["blocks"], shape["threads"], shape["rchunk"], shape["smem"])


def fold_args(tree: dict, B, idx, rt, mk, lam: float, x) -> tuple:
    """The same for ``fold_in_solve`` (the parent's: a thread a row)."""
    b, L = idx.shape
    N, R = B.shape
    serve = tree["serve"]
    shape = serve.fold_in_launch(L, R) if hasattr(serve, "fold_in_launch") else {
        "threads": min(1024, max(32, -(-R // 32) * 32)), "smem": serve.fold_in_smem_bytes(L, R)}
    return (_p(B), _p(idx), _p(rt), _p(mk), lam, _p(x), b, L, R, N, shape["threads"],
            shape["smem"])


def serve_bound(moved: float, ops: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a serve kernel that moves ``moved``
    bytes and does ``ops`` f32 operations."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fold_in_torch(B, idx, ratings, mask, lam: float):
    """The fold-in as a torch composition (``bmm`` Gram, ``cholesky``,
    ``cholesky_solve``): a yardstick for ``fold_in_solve`` that the port
    never calls."""
    rows = B[idx.long()] * mask[..., None]
    eye = torch.eye(B.shape[1], device=B.device)
    gram = rows.transpose(1, 2) @ rows + lam * eye
    rhs = (rows * (ratings * mask)[..., None]).sum(1)
    return torch.cholesky_solve(rhs[..., None], torch.linalg.cholesky(gram))[..., 0]


def step_latency_lib() -> ctypes.CDLL:
    """``bench/csrc/step_latency.cu``, built beside the kernels' library."""
    src = pathlib.Path(__file__).resolve().parent / "csrc" / "step_latency.cu"
    lib = ctypes.CDLL(str(_build.build_source(src)))
    lib.step_latency.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_void_p]
    lib.step_latency.restype = ctypes.c_int
    return lib


def step_ns(dev) -> dict:
    """ns of one dependent ``__fadd_rn``, ``__fdiv_rn`` and ``__fsqrt_rn``
    step: a chain of LATENCY_STEPS in one thread, CUDA events around the
    launch."""
    lib = step_latency_lib()
    out = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ns = {}
    for op, (name, a, b) in enumerate((("fadd", 1.0, 1e-7), ("fdiv", 1.5, 1.0000001),
                                        ("fsqrt", 2.0, 0.0))):
        ns[name] = time_ms(lambda: _call(lib, "step_latency", _p(out), LATENCY_STEPS, op, a, b,
                                         stream), 3) * 1e6 / LATENCY_STEPS
    return ns


def compare_serve(trees: dict, case: str, op: str, args_of, outputs, plain, emit,
                  **extra) -> None:
    """Every tree on one serve case, in turns; one JSON line. ``args_of(tree)``
    gives the C arguments but the stream, ``outputs`` the tensors they
    write, ``plain()`` this checkout's plain version of them. A timed call
    is the C call alone; ``graph_ms`` is each tree's device time a launch,
    ``REPS`` launches in one CUDA graph."""
    want = (plain(),)
    args = {label: args_of(t) for label, t in trees.items()}
    got, equal_runs = {}, {}
    for label, t in trees.items():
        runs = []
        for _ in range(2):
            for o in outputs:
                o.fill_(float("nan"))
            _call(t["lib"], op, *args[label], torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            runs.append(tuple(o.clone() for o in outputs))
        equal_runs[label] = all(torch.equal(x, y) for x, y in zip(*runs))
        got[label] = runs[0]
    first = next(iter(got.values()))

    def maker(label):
        fn = getattr(trees[label]["lib"], op)

        def make():
            bound = (*args[label], torch.cuda.current_stream().cuda_stream)
            return lambda: fn(*bound)
        return make

    ms = {label: [] for label in trees}
    for label in [*trees, *reversed(trees)]:
        ms[label].append(time_ms(maker(label)()))
    emit({"case": case, "op": op, "precision": "f32", "ms": ms,
          "graph_ms": {label: graph_ms(maker(label))[0] for label in trees},
          "max_abs_diff_vs_first": {label: abs_diff(g, first) for label, g in got.items()},
          "max_abs_diff_vs_plain": {label: abs_diff(g, want) for label, g in got.items()},
          "two_launches_equal": equal_runs, **extra})


def serve_cases(trees: dict, dev, emit) -> None:
    """The serve kernels at the serving shapes (the module docstring)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    _, N, R = SERVE_ALS
    T = torch.randn(N, R, generator=gen, device=dev)
    for n_i in SERVE_ALS_BATCHES:
        Q = torch.randn(n_i, R, generator=gen, device=dev)
        out = torch.empty(n_i, N + 1, device=dev)
        compare_serve(trees, "als" if n_i == SERVE_ALS[0] else f"als_b{n_i}", "score_rows",
                      lambda t: score_args(t, Q, T, None, out, sms), [out[:, :N]],
                      lambda: serve_kernels.score_rows_plain(Q, T), emit,
                      n_i=n_i, n_j=N, R=R, ld_out=N + 1,
                      launch=serve_kernels.score_launch(n_i, N, R, sms),
                      **serve_bound(N * R * 4 + n_i * R * 4 + n_i * N * 4, 2 * n_i * N * R),
                      library_ms=time_ms(lambda: Q @ T.T))
    b_max, L = SERVE_FOLD
    rng = np.random.default_rng(11)
    idx = np.zeros((b_max, L), np.int32)
    rt = np.zeros((b_max, L), np.float32)
    mk = np.zeros((b_max, L), np.float32)
    for i in range(b_max):
        n = int(min(1 + rng.poisson(4), L))
        idx[i, :n] = rng.choice(N, size=n, replace=False)
        rt[i, :n] = rng.standard_normal(n)
        mk[i, :n] = 1.0
    lam = 0.1
    ns = step_ns(dev)
    floor = (R * (ns["fsqrt"] + ns["fadd"]) + 2 * R * (ns["fdiv"] + ns["fadd"])) * 1e-6
    for b in SERVE_ALS_BATCHES:
        # The first b requests of the batch of SERVE_FOLD[0].
        fi, frt, fmk = (torch.from_numpy(a[:b]).to(dev) for a in (idx, rt, mk))
        x = torch.empty(b, R, device=dev)
        real = int(fmk.sum())
        compare_serve(trees, "fold_in" if b == b_max else f"fold_in_b{b}", "fold_in_solve",
                      lambda t: fold_args(t, T, fi, frt, fmk, lam, x), [x],
                      lambda: serve_kernels.fold_in_solve_plain(T, fi, frt, fmk, lam), emit,
                      b=b, L=L, R=R, rated=real,
                      **serve_bound(real * R * 4 + b * L * 12 + b * R * 4,
                                    real * R * (R + 1) + 2 * real * R
                                    + b * (R ** 3 / 3 + 2 * R * R)),
                      library_ms=None,
                      torch_ms=time_ms(lambda: fold_in_torch(T, fi, frt, fmk, lam)),
                      step_ns=ns, latency_floor_ms=floor)
    del T
    n_i, n_j, n_t, F = SERVE_GAT
    X = torch.randn(n_t, F, generator=gen, device=dev)
    w = torch.randn(n_i, F, generator=gen, device=dev)
    tidx = torch.randint(0, n_t, (n_j,), generator=gen, device=dev, dtype=torch.int32)
    s = torch.empty(n_i, n_j, device=dev)
    compare_serve(trees, "gat", "score_rows", lambda t: score_args(t, w, X, tidx, s, sms),
                  [s], lambda: serve_kernels.score_rows_plain(w, X, tidx), emit,
                  n_i=n_i, n_j=n_j, R=F, launch=serve_kernels.score_launch(n_i, n_j, F, sms),
                  **serve_bound(n_j * F * 4 + F * 4 + n_j * 4, 2 * n_j * F),
                  library_ms=time_ms(lambda: X[tidx.long()] @ w[0]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="LABEL=DIR, e.g. new=. parent=.chip_archive/parent")
    ap.add_argument("-o", "--output", help="append the JSON lines to this file")
    ap.add_argument("--chunks", default="",
                    help="comma-separated pass-2 chunk sizes to time besides the default")
    ap.add_argument("--only-pass2", action="store_true",
                    help="run the pass-2 cases alone (Graph500 and bigbird)")
    ap.add_argument("--only-serve", action="store_true",
                    help="run the serve kernels' cases alone")
    args = ap.parse_args(argv)
    chunks = tuple(int(c) for c in args.chunks.split(",") if c)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA card")
    dev = torch.device("cuda")
    out_file = open(args.output, "a") if args.output else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out_file:
            out_file.write(line + "\n")
            out_file.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    trees = {}
    for spec in args.trees:
        label, _, root = spec.partition("=")
        trees[label] = load_tree(root)
    emit({"builds": {label: {k: v for k, v in t.items() if k not in ("lib", "sigs", "serve")}
                     for label, t in trees.items()}})

    t0 = time.perf_counter()
    if args.only_serve:
        serve_cases(trees, dev, emit)
    else:
        run_cases(trees, dev, emit, chunks, args.only_pass2)
    emit({"done": True, "seconds": time.perf_counter() - t0})
    if out_file:
        out_file.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
