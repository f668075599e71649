"""Drive the PyTorch / CUDA port on one NVIDIA card and hold each of its
hand-written kernels against its plain PyTorch version.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
last line is printed):

1. device   -- CUDA must be present; the card's name and power limit.
2. build    -- ``nvcc`` builds every ``ops/csrc/*.cu`` (sm_90a), one
   process per source, all started together.
3. kernels  -- at the headline tile (R-mat log_m=16, edge_factor=32, R=128,
   the ``DenseShift15D`` S tile), each kernel against its plain version on
   standard-normal operands, in f32 and bf16. Error is the max abs
   difference over the max abs plain value: <= 1e-5 in f32 (the same f32
   sums in another order), <= 1e-2 in bf16 (bf16 rounding points are the
   same, but a last-bit change of ``mid`` can move one rounded contribution
   by one bf16 step). Pad slots must give ``mid == 0`` exactly, and two
   launches must agree bit for bit (no atomics).
4. verify   -- the main path: ``make_algorithm("15d_fusion2"/"15d_fusion1")``
   run through the port's verify protocol at the headline size, in f32 and
   bf16; fingerprints against the float64 oracle within 1e-4 (f32, the JAX
   package's verify tolerance) and 1e-2 (bf16). The launch counters, zeroed
   just before each run and read just after, must show every kernel ran.
5. full     -- R-mat log_m=20, edge_factor=32, R=128, ``15d_fusion2``, in f32
   and bf16: warmup pairs, then timed fused pairs (GFLOP/s by ``bench.py``'s
   formula ``2*nnz*2*R*pairs/elapsed``), sampled rows against a float64
   host reference, peak device memory; then each kernel's time per launch at
   these shapes beside its plain version, its bound, and one PyTorch call
   that computes the same function (a yardstick the port never calls).
6. attention_verify -- block-sparse attention at the headline size
   (2**16 tokens, R=128, self-attention on ``X = N(0,1)/sqrt(R)``, the serve
   path's data) through ``make_algorithm("15d_fusion2", attention=True)``
   for the masks ``window:16`` and ``bigbird:w=8,g=2,r=2``, in f32 and
   bf16, A and B modes: ``out`` within 1e-4 (f32) / 1e-2 (bf16) of the
   float64 oracle's max abs value, weights within 1e-5 (f32) / 1e-2 (bf16)
   absolute; fused equals unfused bit for bit; each fused call launches
   exactly one SDDMM, attn_stats, attn_norm and SpMM kernel, each then
   timed alone on the inputs the call gives it (breakdown). First, on the
   window mask's tile (kernels_headline), the two attention kernels against
   their plain versions on standard-normal logits with 10% of the gates
   zeroed and one fully masked row: m and d within 1e-5 relative, weights
   within 1e-6 absolute, masked and pad slots exactly 0, two launches
   equal; each timed beside its bound and ``torch.sparse.softmax`` of the
   same logits (one call for the pair).
7. attention_full -- 2**20 tokens, ``window:64`` (135.3M nonzeros), R=128,
   ``15d_fusion2``, f32 and bf16: the harness's own loop
   (``_run_attention``), fused and unfused, with GFLOP/s by its formula and
   the counted bytes; each kernel of one call timed alone (breakdown, as
   in phase 6); 64 sampled rows on the normal data against float64 on the
   host; peak device memory; then the attention kernels against their
   plain versions at this tile (kernels_full).
8. cli -- ``bench.cli.main(["er", "16", "32", "15d_fusion2", "128", "1",
   "--app", "attention", ...])`` on the card; the record it appends.
9. kernels line -- ``{"kernels": [...]}``.
10. last line -- ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from distributed_sddmm_tpu_torch import masks
from distributed_sddmm_tpu_torch.bench import cli, harness
from distributed_sddmm_tpu_torch.bench.harness import make_algorithm
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.ops import _build, cuda_kernels
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import ATTN_NEG
from distributed_sddmm_tpu_torch.utils import oracle, verify
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

HEADLINE = {"log_m": 16, "edge_factor": 32, "R": 128}
FULL = {"log_m": 20, "edge_factor": 32, "R": 128}
PRECISIONS = ("f32", "bf16")
KERNEL_TOL = {"f32": 1e-5, "bf16": 1e-2}
VERIFY_RTOL = {"f32": 1e-4, "bf16": 1e-2}
WARMUP_PAIRS, TIMED_PAIRS = 3, 20
KERNEL_REPS, PLAIN_REPS = 20, 3

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and
# the float32 rate outside the tensor cores, where these kernels do their
# arithmetic in both precisions (bf16 operands are widened to f32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SOURCE = "distributed_sddmm_tpu_torch/ops/csrc/tile_kernels.cu"
ATTN_SOURCE = "distributed_sddmm_tpu_torch/ops/csrc/attn_kernels.cu"
REPLACES = {
    "sddmm_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:327",
    "spmm_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:341",
    "fused_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:305",
    "attn_stats_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:419",
    "attn_norm_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:465",
}
OPS = ("sddmm_tile", "spmm_tile", "fused_tile")
ATTN_OPS = ("attn_stats_tile", "attn_norm_tile")

# Attention: the headline size, with both masks of the README, and the
# full cell (the README's headline mask at 2**20 tokens). The attention
# kernels are float32 in both precision modes.
ATTN_HEADLINE = {"log_n": 16, "R": 128, "masks": ("window:16", "bigbird:w=8,g=2,r=2")}
ATTN_FULL = {"log_n": 20, "R": 128, "mask": "window:64"}
ATTN_OUT_RTOL = {"f32": 1e-4, "bf16": 1e-2}
ATTN_PROBS_ATOL = {"f32": 1e-5, "bf16": 1e-2}
ATTN_STATS_RTOL, ATTN_P_ATOL = 1e-5, 1e-6
ATTN_WARMUP, ATTN_TRIALS, ATTN_CALL_REPS = 2, 10, 3
DEAD_ROW = 3
#: Kernel launches of one fused attention call at p = 1.
ATTN_CALL = {"sddmm_tile": 1, "spmm_tile": 1, "fused_tile": 0,
             "attn_stats_tile": 1, "attn_norm_tile": 1}
PLAIN = {
    "sddmm_tile": cuda_kernels.sddmm_tile_plain,
    "spmm_tile": cuda_kernels.spmm_tile_plain,
    "fused_tile": cuda_kernels.fused_tile_plain,
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def call(kernel: CudaTileKernel, op: str, tile, sv, at, bt):
    if op == "spmm_tile":
        return kernel.spmm_tile(tile, sv, bt)
    return getattr(kernel, op)(tile, sv, at, bt)


def call_plain(op: str, tile, sv, at, bt):
    if op == "spmm_tile":
        return PLAIN[op](tile, sv, bt)
    return PLAIN[op](tile, sv, at, bt)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def time_ms(fn, reps: int) -> float:
    """Device time per call: CUDA events around ``reps`` calls after one
    warmup call."""
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


def bound(op: str, nnz: int, M: int, N: int, R: int, esize: int) -> dict:
    """Least time for the work: each input read once and each output
    written once over HBM bandwidth, or the flops over the f32 rate,
    whichever is larger. ``gather_ms`` counts B as ``nnz`` gathered rows
    instead of once, the traffic when B does not stay in the 50 MB L2."""
    index = nnz * 8 + (M + 1) * 4          # cols + values, row_ptr
    a_in = M * R * esize
    out = M * R * 4
    mid = nnz * 4
    moved = {"sddmm_tile": index + a_in + mid,
             "spmm_tile": index + out,
             "fused_tile": index + a_in + mid + out}[op]
    flops = {"sddmm_tile": 2 * nnz * R + nnz,
             "spmm_tile": 2 * nnz * R,
             "fused_tile": 4 * nnz * R + nnz}[op]
    t_bytes = (moved + N * R * esize) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "gather_ms": max((moved + nnz * R * esize) / HBM_BYTES_PER_S * 1e3, t_ops),
    }


def attn_bound(op: str, nnz: int, n_rows: int) -> dict:
    """Least time of one attention kernel: ``attn_stats`` reads row_ptr,
    gate and logits (8 B a slot, 4 B a row) and writes m and d (8 B a row);
    ``attn_norm`` reads rows, gate and logits and writes p (16 B a slot)
    and reads m and d once (8 B a row). Operations: compare, subtract, exp
    and add a slot for the stats; subtract, exp and divide for the
    weights."""
    moved = (8 * nnz + 12 * n_rows if op == "attn_stats_tile"
             else 16 * nnz + 8 * n_rows)
    ops = (4 if op == "attn_stats_tile" else 3) * nnz
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def launch_key(op: str, prec: str) -> tuple:
    """Launch-count key: the attention kernels are float32 in both modes."""
    return (op, "f32" if op in ATTN_OPS else prec)


def add_launches(launches: dict, counts: dict, prec: str) -> None:
    for op, n in counts.items():
        key = launch_key(op, prec)
        launches[key] = launches.get(key, 0) + n


def library_csr(tile, sv, n_cols: int):
    """The tile as a PyTorch CSR matrix with sorted columns (cuSPARSE's
    input), built once outside any timed region."""
    nnz = int(tile.row_ptr[-1])
    key = tile.rows[:nnz].long() * n_cols + tile.cols[:nnz].long()
    order = torch.argsort(key)
    return torch.sparse_csr_tensor(
        tile.row_ptr, tile.cols[:nnz][order], sv[:nnz][order],
        size=(tile.n_rows, n_cols), check_invariants=False)


def library_ms(op: str, csr, A, B, Bt) -> float | None:
    """One PyTorch call computing the op, timed as a yardstick:
    ``sampled_addmm`` (the sampled product ``A B^T`` at S's pattern, without
    the value scaling) for SDDMM, ``sparse.mm`` for SpMM, in the operands'
    type; the fused pair has no single call."""
    if op == "sddmm_tile":
        return time_ms(lambda: torch.sparse.sampled_addmm(csr, A, Bt, beta=0.0),
                       KERNEL_REPS)
    if op == "spmm_tile":
        return time_ms(lambda: torch.sparse.mm(csr, B), KERNEL_REPS)
    return None


def rel_err(got, want) -> tuple[float, float]:
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **info})
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    # ptxas's report of every instantiation: registers, spills.
    ptxas = [line.split(":", 1)[-1].strip() for line in info["log"].splitlines()
             if "Used" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "cached": info["cached"],
          "ptxas": ptxas})


def compare_kernels(alg, dev, label: str, entries: dict, reps_plain: int) -> None:
    """Every kernel against its plain version on standard-normal operands
    at ``alg``'s S tile; times the kernel, its plain version and the
    library call. Launches here are not the main path's and are not
    counted."""
    tiles = alg.S_tiles
    tile = tiles.tile(0, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(alg.M_pad, alg.R, generator=gen, device=dev)
    B = torch.randn(alg.N_pad, alg.R, generator=gen, device=dev)
    sv = (tiles.mask * torch.randn(tiles.shape, generator=gen, device=dev))[0, 0]
    pads = tiles.mask[0, 0] == 0
    nnz = int(tiles.nnz_per_tile[0, 0])
    Bt = B.t().contiguous()
    for prec in PRECISIONS:
        k = CudaTileKernel(prec, device=dev)
        at, bt = k.prep(A), k.prep(B)
        # The yardstick in the kernel's own operand type: bf16 values, A, B.
        lib_sv = sv if prec == "f32" else sv.bfloat16()
        csr = library_csr(tile, lib_sv, alg.N_pad)
        lib, lib_err = {}, {}
        for op in OPS:
            try:
                lib[op] = library_ms(op, csr, at, bt, k.prep(Bt))
            except RuntimeError as e:  # PyTorch refuses the type: say why
                if prec == "f32":
                    raise
                lib[op], lib_err[op] = None, str(e).strip().splitlines()[0]
        del csr
        for op in OPS:
            got = as_tuple(call(k, op, tile, sv, at, bt))
            again = as_tuple(call(k, op, tile, sv, at, bt))
            want = as_tuple(call_plain(op, tile, sv, at, bt))
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            abs_err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            require(rel <= KERNEL_TOL[prec],
                    f"{op}/{prec} at {label}: error {rel:.3e} > {KERNEL_TOL[prec]}")
            require(all(torch.equal(g, a) for g, a in zip(got, again)),
                    f"{op}/{prec} at {label}: two launches differ")
            if op != "spmm_tile":
                require(bool(torch.all(got[-1][pads] == 0)),
                        f"{op}/{prec} at {label}: nonzero mid at a pad slot")
            ms = time_ms(lambda: call(k, op, tile, sv, at, bt), KERNEL_REPS)
            plain_ms = time_ms(lambda: call_plain(op, tile, sv, at, bt), reps_plain)
            b = bound(op, nnz, alg.M_pad, alg.N_pad, alg.R, at.element_size())
            row = {"max_abs_err": abs_err, "max_rel_err": rel,
                   "tol": KERNEL_TOL[prec], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                   "bound_gather_ms": b["gather_ms"], "library_ms": lib[op],
                   "nnz": nnz}
            if op in lib_err:
                row["library_error"] = lib_err[op]
            entries.setdefault((op, prec), {})[label] = row
            emit({"phase": f"kernels_{label}", "kernel": op, "precision": prec,
                  **row})


def run_counted(fn):
    """Zero the launch counters, run ``fn`` (a drive of the main path),
    synchronise and read them."""
    cuda_kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, cuda_kernels.launch_counts()


def phase_verify(S, dev, launches: dict) -> None:
    want = verify.oracle_fingerprints(S, HEADLINE["R"])
    for prec in PRECISIONS:
        for fusion in (2, 1):
            alg = make_algorithm(f"15d_fusion{fusion}", S, HEADLINE["R"],
                                 kernel=CudaTileKernel(prec, device=dev),
                                 device=dev)
            got, counts = run_counted(lambda: verify.fingerprint_algorithm(alg, S))
            rel = {op: abs(got[op] / want[op] - 1) for op in want}
            emit({"phase": "verify", "algorithm": f"15d_fusion{fusion}",
                  "precision": prec, "rtol": VERIFY_RTOL[prec], "rel_err": rel,
                  "fingerprints": got, "oracle": want, "launches": counts})
            require(all(r <= VERIFY_RTOL[prec] for r in rel.values()),
                    f"verify 15d_fusion{fusion}/{prec}: {rel}")
            # fusion 2: sddmmA, spmmA, spmmB, one fused pair;
            # fusion 1: the fused pair is an SDDMM pass then an SpMM pass.
            expect = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
            expect.update({"sddmm_tile": 1, "spmm_tile": 2, "fused_tile": 1}
                          if fusion == 2 else
                          {"sddmm_tile": 2, "spmm_tile": 3, "fused_tile": 0})
            require(counts == expect,
                    f"verify 15d_fusion{fusion}/{prec}: launches {counts} != {expect}")
            add_launches(launches, counts, prec)


def sampled_reference(S: HostCOO, alg, out, mid, dev, rng) -> float:
    """Relative error of 64 sampled output rows and their ``mid`` values
    against float64 on the host (A = the dummy fill, B = 0.01)."""
    csr = S.to_scipy()
    rows = rng.choice(np.flatnonzero(np.diff(csr.indptr)), 64, replace=False)
    R = alg.R
    out_h = out[torch.as_tensor(rows, device=dev)].double().cpu().numpy()
    mid_h = alg.gather_s_values(mid)
    order = np.argsort(S.rows, kind="stable")  # host slot -> CSR position
    starts = np.searchsorted(S.rows[order], rows)
    err = 0.0
    for i, r in enumerate(rows):
        a = r * R + np.arange(R, dtype=np.float64)
        deg = csr.indptr[r + 1] - csr.indptr[r]
        m = float(a.sum()) * 0.01
        want_out = np.full(R, deg * m * 0.01)
        got_mid = mid_h[order[starts[i]: starts[i] + deg]]
        err = max(err, float(np.abs(out_h[i] - want_out).max() / np.abs(want_out).max()),
                  float(np.abs(got_mid - m).max() / abs(m)))
    return err


def phase_full(dev, launches: dict, entries: dict) -> dict:
    t0 = time.perf_counter()
    S = HostCOO.rmat(FULL["log_m"], FULL["edge_factor"], np.random.default_rng(0))
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    alg = make_algorithm("15d_fusion2", S, FULL["R"],
                         kernel=CudaTileKernel("f32", device=dev), device=dev)
    A = alg.dummy_initialize(MatMode.A)
    B = alg.like_b_matrix(0.01)
    s_vals = alg.like_s_values(1.0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    result = {"nnz": S.nnz, "M": S.M, "R": alg.R, "rmat_seconds": gen_s,
              "setup_seconds": setup_s}
    rng = np.random.default_rng(1)
    for prec in PRECISIONS:
        # The strategy's local kernel is a plain attribute: swapping it
        # reuses the tiles already on the card.
        alg.kernel = CudaTileKernel(prec, device=dev)

        def drive():
            for _ in range(WARMUP_PAIRS):
                alg.fused_spmm(A, B, s_vals, MatMode.A)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(TIMED_PAIRS):
                res = alg.fused_spmm(A, B, s_vals, MatMode.A)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t

        ((out, mid), elapsed), counts = run_counted(drive)
        require(counts["fused_tile"] == WARMUP_PAIRS + TIMED_PAIRS,
                f"full/{prec}: fused launches {counts}")
        add_launches(launches, counts, prec)
        require(tuple(out.shape) == (alg.M_pad, alg.R)
                and bool(torch.isfinite(out).all())
                and bool(torch.isfinite(mid).all()),
                f"full/{prec}: output not finite or of the wrong shape")
        err = sampled_reference(S, alg, out, mid, dev, rng)
        require(err <= VERIFY_RTOL[prec], f"full/{prec}: sampled rows off by {err:.3e}")
        gflops = 2.0 * S.nnz * 2.0 * alg.R * TIMED_PAIRS / elapsed / 1e9
        result[prec] = {"pairs": TIMED_PAIRS, "elapsed_s": elapsed,
                        "ms_per_pair": elapsed / TIMED_PAIRS * 1e3,
                        "gflops": gflops, "sampled_rel_err": err,
                        "launches": counts}
    result["peak_mem_main_path_bytes"] = torch.cuda.max_memory_allocated()
    compare_kernels(alg, dev, "full", entries, PLAIN_REPS)
    result["peak_mem_with_comparisons_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "full", **result})
    return result


# ---------------------------------------------------------------- attention


def attention_inputs(alg, dev, gen):
    """The S tile's attention kernel inputs: standard-normal logits, 10% of
    the gates zeroed and row DEAD_ROW fully masked (0 at pads)."""
    tiles = alg.S_tiles
    tile = tiles.tile(0, 0)
    real = tiles.mask[0, 0]
    z = torch.randn(tile.cap, generator=gen, device=dev) * real
    keep = torch.rand(tile.cap, generator=gen, device=dev) >= 0.1
    gate = real * keep
    lo, hi = (int(x) for x in tile.row_ptr[DEAD_ROW: DEAD_ROW + 2])
    require(hi > lo, f"row {DEAD_ROW} of the attention tile is empty")
    gate[lo:hi] = 0
    return tile, gate.contiguous(), z.contiguous()


def library_softmax(tile, z, n_cols: int):
    """``torch.sparse.softmax`` over the tile's COO logits along dim 1:
    with an all-ones gate the same function as the stats and weights pair
    (a yardstick the port never calls); the COO is built and coalesced
    outside the timed region."""
    nnz = int(tile.row_ptr[-1])
    idx = torch.stack([tile.rows[:nnz].long(), tile.cols[:nnz].long()])
    return torch.sparse_coo_tensor(idx, z[:nnz], (tile.n_rows, n_cols),
                                   check_invariants=False).coalesce()


def compare_attn_kernels(alg, dev, label: str, entries: dict, reps_plain: int) -> None:
    """``attn_stats_tile`` and ``attn_norm_tile`` against their plain
    versions at ``alg``'s S tile; both weights runs take the plain row
    stats, so each kernel is held on its own. Launches here are not the
    main path's and are not counted."""
    gen = torch.Generator(device=dev).manual_seed(0)
    tile, gate, z = attention_inputs(alg, dev, gen)
    nnz = int(alg.S_tiles.nnz_per_tile[0, 0])
    masked = gate == 0
    k = CudaTileKernel("f32", device=dev)
    m, d = k.attn_stats_tile(tile, gate, z)
    m2, d2 = k.attn_stats_tile(tile, gate, z)
    wm, wd = cuda_kernels.attn_stats_tile_plain(tile, gate, z)
    p = k.attn_norm_tile(tile, gate, z, wm, wd)
    p2 = k.attn_norm_tile(tile, gate, z, wm, wd)
    wp = cuda_kernels.attn_norm_tile_plain(tile, gate, z, wm, wd)
    torch.cuda.synchronize()
    stats_abs = max(float((m - wm).abs().max()), float((d - wd).abs().max()))
    stats_rel = max(float(((m - wm).abs() / wm.abs().clamp_min(1e-30)).max()),
                    float(((d - wd).abs() / wd.abs().clamp_min(1e-30)).max()))
    p_abs = float((p - wp).abs().max())
    require(stats_rel <= ATTN_STATS_RTOL,
            f"attn_stats_tile at {label}: error {stats_rel:.3e} > {ATTN_STATS_RTOL}")
    require(p_abs <= ATTN_P_ATOL,
            f"attn_norm_tile at {label}: error {p_abs:.3e} > {ATTN_P_ATOL}")
    require(bool(m[DEAD_ROW] == ATTN_NEG) and float(d[DEAD_ROW]) == 0.0,
            f"attn_stats_tile at {label}: the fully masked row has stats")
    require(bool(torch.all(p[masked] == 0)),
            f"attn_norm_tile at {label}: nonzero weight at a masked or pad slot")
    require(torch.equal(m, m2) and torch.equal(d, d2) and torch.equal(p, p2),
            f"attention kernels at {label}: two launches differ")
    coo = library_softmax(tile, z, alg.N_pad)
    lib = time_ms(lambda: torch.sparse.softmax(coo, 1), reps_plain)
    del coo
    runs = {
        "attn_stats_tile": (lambda: k.attn_stats_tile(tile, gate, z),
                            lambda: cuda_kernels.attn_stats_tile_plain(tile, gate, z),
                            stats_abs, stats_rel, ATTN_STATS_RTOL),
        "attn_norm_tile": (lambda: k.attn_norm_tile(tile, gate, z, wm, wd),
                           lambda: cuda_kernels.attn_norm_tile_plain(tile, gate, z, wm, wd),
                           p_abs, p_abs, ATTN_P_ATOL),
    }
    for op, (kern, plain, abs_err, rel, tol) in runs.items():
        b = attn_bound(op, nnz, tile.n_rows)
        row = {"max_abs_err": abs_err, "max_rel_err": rel, "tol": tol,
               "ms": time_ms(kern, KERNEL_REPS), "plain_ms": time_ms(plain, reps_plain),
               "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
               "bound_gather_ms": b["bound_ms"], "library_ms": lib,
               "library_covers": "attn_stats_tile + attn_norm_tile", "nnz": nnz}
        entries.setdefault((op, "f32"), {})[label] = row
        emit({"phase": f"kernels_{label}", "kernel": op, "precision": "f32", **row})


def attention_breakdown(alg, A, B, reps: int, mode: MatMode = MatMode.A) -> dict:
    """Device ms of each kernel of one fused attention call, timed alone
    on the inputs the call gives it (CUDA events), the ``prep`` casts of
    the two dense operands, and their sum; the call's time less this sum
    is host work, allocation and the value copies. Not counted as main
    path launches."""
    use_st = mode == MatMode.B
    tiles = alg.ST_tiles if use_st else alg.S_tiles
    stat, mov = (B, A) if use_st else (A, B)
    tile, k = tiles.tile(0, 0), alg.kernel
    sv = tiles.like_values(1.0)[0, 0]
    at, bt = k.prep(stat), k.prep(mov)
    z = k.sddmm_tile(tile, sv, at, bt)
    m, d = k.attn_stats_tile(tile, sv, z)
    p = k.attn_norm_tile(tile, sv, z, m, d)
    out = {
        "prep_ms": 2 * time_ms(lambda: k.prep(mov), reps),
        "sddmm_tile_ms": time_ms(lambda: k.sddmm_tile(tile, sv, at, bt), reps),
        "attn_stats_tile_ms": time_ms(lambda: k.attn_stats_tile(tile, sv, z), reps),
        "attn_norm_tile_ms": time_ms(lambda: k.attn_norm_tile(tile, sv, z, m, d), reps),
        "spmm_tile_ms": time_ms(lambda: k.spmm_tile(tile, p, bt), reps),
    }
    out["sum_ms"] = sum(out.values())
    return out


def rel_to(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def phase_attention_verify(dev, launches: dict, entries: dict,
                           log_n: int = ATTN_HEADLINE["log_n"],
                           R: int = ATTN_HEADLINE["R"],
                           specs=ATTN_HEADLINE["masks"]) -> dict:
    n = 1 << log_n
    X = (np.random.default_rng(0).standard_normal((n, R)) / np.sqrt(R)).astype(np.float32)
    ms_per_call = {}
    for spec in specs:
        S = masks.from_spec(spec, n)
        t0 = time.perf_counter()
        want = {MatMode.A: oracle.fused_attention_a(S, X, X),
                MatMode.B: oracle.fused_attention_a(S.transpose(), X, X)}
        oracle_s = time.perf_counter() - t0
        alg = make_algorithm("15d_fusion2", S, R, kernel=CudaTileKernel("f32", device=dev),
                             device=dev, attention=True)
        if spec == specs[0]:
            compare_attn_kernels(alg, dev, "headline", entries, KERNEL_REPS)
        A, B = alg.put_a(X), alg.put_b(X)
        vals = {MatMode.A: alg.like_s_values(1.0), MatMode.B: alg.like_st_values(1.0)}
        deg = np.bincount(S.rows, minlength=n)
        for prec in PRECISIONS:
            alg.kernel = CudaTileKernel(prec, device=dev)
            for mode in (MatMode.A, MatMode.B):
                (out, probs), counts = run_counted(
                    lambda: alg.fused_attention(A, B, vals[mode], mode))
                require(counts == ATTN_CALL,
                        f"attention {spec}/{prec}/{mode.name}: launches {counts}")
                add_launches(launches, counts, prec)
                out_u, probs_u = alg.attention_unfused(A, B, vals[mode], mode)
                require(torch.equal(out, out_u) and torch.equal(probs, probs_u),
                        f"attention {spec}/{prec}/{mode.name}: fused != unfused")
                require(bool(torch.isfinite(out).all()),
                        f"attention {spec}/{prec}/{mode.name}: output not finite")
                if mode == MatMode.A:
                    got_out, got_p = alg.host_a(out), alg.gather_s_values(probs)
                else:
                    got_out, got_p = alg.host_b(out), alg.gather_st_values(probs)
                out_err = rel_to(got_out, want[mode][0])
                p_err = float(np.abs(got_p - want[mode][1]).max())
                ms = time_ms(lambda: alg.fused_attention(A, B, vals[mode], mode),
                             ATTN_CALL_REPS)
                ms_per_call[f"{spec}/{prec}/{mode.name}"] = ms
                emit({"phase": "attention_verify", "mask": spec, "precision": prec,
                      "mode": mode.name, "n": n, "R": R, "nnz": S.nnz,
                      "max_row_nnz": int(deg.max()), "out_rel_err": out_err,
                      "out_rtol": ATTN_OUT_RTOL[prec], "probs_abs_err": p_err,
                      "probs_atol": ATTN_PROBS_ATOL[prec], "ms_per_call": ms,
                      "breakdown": attention_breakdown(alg, A, B, ATTN_CALL_REPS, mode),
                      "launches": counts, "oracle_seconds": oracle_s})
                require(out_err <= ATTN_OUT_RTOL[prec] and p_err <= ATTN_PROBS_ATOL[prec],
                        f"attention {spec}/{prec}/{mode.name}: out {out_err:.3e}, "
                        f"probs {p_err:.3e} off the float64 oracle")
        del alg, A, B, vals
    return ms_per_call


def sampled_attention_reference(S: HostCOO, alg, X, out, probs, rows) -> tuple:
    """Max relative error of the sampled output rows and max absolute
    error of their weights against float64 on the host (A = B = X, unit
    mask, so the logits are the dot products)."""
    out_h = out[torch.as_tensor(rows, device=out.device)].double().cpu().numpy()
    flat = probs.reshape(-1)
    starts = np.searchsorted(S.rows, rows)  # the mask is row-sorted
    ends = np.searchsorted(S.rows, rows, side="right")
    want_out, p_err = [], 0.0
    for r, lo, hi in zip(rows, starts, ends):
        xc = X[S.cols[lo:hi]].astype(np.float64)
        z = xc @ X[r].astype(np.float64)
        e = np.exp(z - z.max())
        p = e / e.sum()
        want_out.append(p @ xc)
        slots = torch.as_tensor(alg.S_tiles.host_to_flat[lo:hi], device=flat.device)
        p_err = max(p_err, float(np.abs(flat[slots].double().cpu().numpy() - p).max()))
    return rel_to(out_h, np.stack(want_out)), p_err


def phase_attention_full(dev, launches: dict, entries: dict,
                         log_n: int = ATTN_FULL["log_n"], R: int = ATTN_FULL["R"],
                         spec: str = ATTN_FULL["mask"],
                         reps_plain: int = PLAIN_REPS) -> dict:
    n = 1 << log_n
    t0 = time.perf_counter()
    S = masks.from_spec(spec, n)
    mask_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    alg = make_algorithm("15d_fusion2", S, R, kernel=CudaTileKernel("f32", device=dev),
                         device=dev, attention=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((n, R)) / np.sqrt(R)).astype(np.float32)
    rows = np.sort(rng.choice(n, 64, replace=False))
    result = {"mask": spec, "n": n, "R": R, "nnz": S.nnz, "mask_seconds": mask_s,
              "tile_setup_seconds": setup_s}
    calls = ATTN_WARMUP + ATTN_TRIALS
    for prec in PRECISIONS:
        alg.kernel = CudaTileKernel(prec, device=dev)
        res = {}
        for fused in (True, False):
            (elapsed, stats), counts = run_counted(
                lambda: harness._run_attention(alg, fused, ATTN_TRIALS, ATTN_WARMUP))
            require(counts == {op: n_ * calls for op, n_ in ATTN_CALL.items()},
                    f"attention_full/{prec}/fused={fused}: launches {counts}")
            add_launches(launches, counts, prec)
            res["fused" if fused else "unfused"] = {
                "trials": ATTN_TRIALS, "elapsed_s": elapsed,
                "ms_per_call": elapsed / ATTN_TRIALS * 1e3,
                "gflops": 2.0 * S.nnz * 2.0 * R * ATTN_TRIALS / elapsed / 1e9,
                "launches": counts}
        res["attention_hbm"] = stats["attention_hbm"]
        res["breakdown"] = attention_breakdown(alg, alg.dummy_initialize(MatMode.A),
                                               alg.dummy_initialize(MatMode.B),
                                               KERNEL_REPS // 2)
        A, B = alg.put_a(X), alg.put_b(X)
        out, probs = alg.fused_attention(A, B, alg.like_s_values(1.0))
        require(tuple(out.shape) == (alg.M_pad, R) and bool(torch.isfinite(out).all())
                and bool(torch.isfinite(probs).all()),
                f"attention_full/{prec}: output not finite or of the wrong shape")
        out_err, p_err = sampled_attention_reference(S, alg, X, out, probs, rows)
        res.update({"sampled_out_rel_err": out_err, "sampled_probs_abs_err": p_err})
        require(out_err <= ATTN_OUT_RTOL[prec] and p_err <= ATTN_PROBS_ATOL[prec],
                f"attention_full/{prec}: sampled rows off by {out_err:.3e} / {p_err:.3e}")
        del A, B, out, probs
        result[prec] = res
    result["peak_mem_main_path_bytes"] = torch.cuda.max_memory_allocated()
    compare_attn_kernels(alg, dev, "full", entries, reps_plain)
    result["peak_mem_with_comparisons_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "attention_full", **result})
    return result


def phase_cli(dev, launches: dict, log_m: int = 16, edge_factor: int = 32,
              R: int = 128, trials: int = 2) -> dict:
    """The ``er`` command in-process on the card (its default kernel,
    cuda-bf16), appending its record under the gitignored build directory."""
    path = _build.BUILD_DIR / "chip_smoke_cli.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    argv = ["er", str(log_m), str(edge_factor), "15d_fusion2", str(R), "1",
            "--app", "attention", "--mask", "window:16", "--trials", str(trials),
            "-o", str(path)]
    rc, counts = run_counted(lambda: cli.main(argv))
    rec = json.loads(path.read_text().splitlines()[-1])
    path.unlink()
    calls = trials + 1  # one warmup call
    require(rc == 0 and rec["app"] == "attention" and rec["mask"] == "window:16"
            and rec["device"] == torch.cuda.get_device_name(0)
            and rec["kernel"] == "cuda-bf16",
            f"cli: rc {rc}, record {rec['app']}/{rec['mask']}/{rec['device']}")
    require(counts == {op: n_ * calls for op, n_ in ATTN_CALL.items()},
            f"cli: launches {counts}")
    add_launches(launches, counts, "bf16")
    info = {k: rec[k] for k in ("app", "mask", "device", "kernel", "elapsed",
                                "overall_throughput", "attention_hbm")}
    emit({"phase": "cli", "argv": argv, "launches": counts, **info})
    return info


def main() -> int:
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    S16 = HostCOO.rmat(HEADLINE["log_m"], HEADLINE["edge_factor"],
                       np.random.default_rng(0))
    alg16 = make_algorithm("15d_fusion2", S16, HEADLINE["R"],
                           kernel=CudaTileKernel("f32", device=dev), device=dev)
    entries: dict = {}
    compare_kernels(alg16, dev, "headline", entries, KERNEL_REPS)
    del alg16
    launches: dict = {}
    phase_verify(S16, dev, launches)
    phase_full(dev, launches, entries)
    phase_attention_verify(dev, launches, entries)
    phase_attention_full(dev, launches, entries)
    phase_cli(dev, launches)

    kernels = []
    for (op, prec), shapes in entries.items():
        n = launches.get((op, prec), 0)
        require(n > 0, f"{op}/{prec} never launched on the main path")
        full, head = shapes["full"], shapes["headline"]
        kernels.append({
            "name": f"{op}[{prec}]", "route": "cuda",
            "source": ATTN_SOURCE if op in ATTN_OPS else SOURCE,
            "replaces": REPLACES[op], "launches": n,
            "max_abs_err": max(full["max_abs_err"], head["max_abs_err"]),
            "max_rel_err": max(full["max_rel_err"], head["max_rel_err"]),
            "tol": full["tol"],
            "ms": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "bound_gather_ms": full["bound_gather_ms"],
            "library_ms": full["library_ms"],
            **{k: full[k] for k in ("library_error", "library_covers") if k in full},
            "headline": {k: head[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bound_gather_ms",
                "library_ms", "max_abs_err")},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
