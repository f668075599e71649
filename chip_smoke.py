"""Drive the PyTorch / CUDA port on one NVIDIA card and hold each of its
hand-written kernels against its plain PyTorch version.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
last line is printed):

1. device   -- CUDA must be present; the card's name and power limit.
2. build    -- ``nvcc`` builds ``ops/csrc/tile_kernels.cu`` (sm_90a).
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
6. kernels line -- ``{"kernels": [...]}``.
7. last line -- ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from distributed_sddmm_tpu_torch.bench.harness import make_algorithm
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.ops import _build, cuda_kernels
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.utils import verify
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
REPLACES = {
    "sddmm_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:327",
    "spmm_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:341",
    "fused_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:305",
}
OPS = tuple(REPLACES)
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
    the value scaling) for SDDMM, ``sparse.mm`` for SpMM; the fused pair has
    no single call."""
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
    csr = library_csr(tile, sv, alg.N_pad)
    Bt = B.t().contiguous()
    for prec in PRECISIONS:
        k = CudaTileKernel(prec, device=dev)
        at, bt = k.prep(A), k.prep(B)
        lib = {op: library_ms(op, csr, A, B, Bt) if prec == "f32" else None
               for op in OPS}
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
            expect = ({"sddmm_tile": 1, "spmm_tile": 2, "fused_tile": 1}
                      if fusion == 2 else
                      {"sddmm_tile": 2, "spmm_tile": 3, "fused_tile": 0})
            require(counts == expect,
                    f"verify 15d_fusion{fusion}/{prec}: launches {counts} != {expect}")
            for op, n in counts.items():
                launches[(op, prec)] = launches.get((op, prec), 0) + n


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
        for op, n in counts.items():
            launches[(op, prec)] = launches.get((op, prec), 0) + n
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

    kernels = []
    for (op, prec), shapes in entries.items():
        n = launches.get((op, prec), 0)
        require(n > 0, f"{op}/{prec} never launched on the main path")
        full, head = shapes["full"], shapes["headline"]
        kernels.append({
            "name": f"{op}[{prec}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[op], "launches": n,
            "max_abs_err": max(full["max_abs_err"], head["max_abs_err"]),
            "max_rel_err": max(full["max_rel_err"], head["max_rel_err"]),
            "tol": full["tol"],
            "ms": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "bound_gather_ms": full["bound_gather_ms"],
            "library_ms": full["library_ms"],
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
