"""Analytic communication and compute cost models and the c-optimum
(counterpart of ``tools/costmodel.py``).

The reference notebook's first-order models (``fusion2model`` /
``fusionmodel1`` / ``unfusedmodel``) predict the best replication factor c
of the 1.5D algorithms from the words they move; the 2.5D models follow
Koanantakool et al.'s 2.5D volume accounting. Per-device word volumes of
one fused SDDMM + SpMM pair (A is M x R, B is N x R, S has nnz nonzeros,
p ranks, replication c):

* 1.5D dense shift (A replicated over c, B rides the ring):
    replicate = (c - 1)/c * (M * R * c / p)        [all_gather]
    ring      = (p/c - 1) * (N * R / p) * n_pass   [ppermute of B]
  fusion 2 makes one ring pass, fusion 1 two passes over one replication,
  unfused two passes and two replications. The SpMM reduce-scatter is the
  same for the three and is folded out, as in the notebook.
* 1.5D sparse shift (dense stationary R-split, the tile rides):
    replicate = (c - 1)/c * (N * R * c / p)
    ring      = (p/c - 1) * 3 * nnz / p * n_pass   [rows, cols, values]
* 2.5D Cannon, dense- or sparse-replicating: see the components below.

Compute: ``4 * nnz * R / p`` flops a pair at ``flops_rate``; latency:
``alpha_s`` a ring hop. ``pair_words`` counts elements whatever the wire;
``pair_bytes`` prices them under a wire-precision policy
(``parallel/wire.py``); both assemble from the same ``_*_components``.

The machine is the card's: :class:`Machine`'s defaults are an NVIDIA H100
SXM's link (the datasheet's NVLink rate), a hop latency measured on the
card, and the fused pair's flops rate from the port's own kernel records
(``bench kernels`` schema, :func:`measured_flops_rate`), else the literal
the repo's PERF.md records for that kernel family.

CLI: ``python -m distributed_sddmm_tpu_torch.tools.costmodel log_m
nnz_per_row R p`` prints the T(c) curves and c* as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib

from distributed_sddmm_tpu_torch.utils.buckets import pow2_bucket

_REPO = pathlib.Path(__file__).resolve().parents[2]

#: The fraction of one fused pair each op is (``obs/metrics.py``).
OP_PAIRS = {
    "fusedSpMM": 1.0, "fusedSpMMB": 1.0, "fusedAttn": 1.0, "fusedAttnB": 1.0,
    "cgStep": 1.0, "cgStepB": 1.0, "gatLayer": 1.0,
    "sddmmA": 0.5, "sddmmB": 0.5, "spmmA": 0.5, "spmmB": 0.5,
}

#: NVLink 4 on an H100 SXM: 450 GB/s a direction (900 GB/s both ways; the
#: NVIDIA H100 datasheet, spec, not measured), in float32 words a second.
DEFAULT_LINK_WORDS_PER_S = 450e9 / 4

#: Hop latency: one NCCL all-reduce of a single float32 at world size 1,
#: host clock around the call and a synchronise, 45.0 µs on an NVIDIA
#: H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase plans, recorded in
#: PERF.md). No link is crossed there: it is the floor under any hop
#: between cards.
DEFAULT_ALPHA_S = 4.50e-5

#: The fused pair's useful flops rate a kernel family reaches at the
#: headline grid point (R-mat log_m 16, 32 a row, R 128): ``bench kernels``
#: on an NVIDIA H100 80GB HBM3 at 700 W, recorded in PERF.md. The fallback
#: when no kernel records are found.
FALLBACK_FLOPS_RATES = {"cuda-bf16": 8.33e12, "cuda-f32": 5.08e12, "torch": 1.29e11}

#: The grid point ``(log_m, nnz/row bucket, R)`` whose measured rate the
#: defaults prefer: rates depend on intensity.
HEADLINE_CONFIG = (16, 32, 128)

#: Environment variable: the kernel-records file (``bench kernels -o``)
#: the flops rates are read from; default ``KERNELS_CUDA.jsonl`` at the
#: repo root.
KERNEL_RECORDS_ENV = "SDDMM_TORCH_KERNEL_RECORDS"


def kernel_records_path() -> pathlib.Path:
    """The kernel-records file, read a call so a caller can redirect it."""
    env = os.environ.get(KERNEL_RECORDS_ENV)
    return pathlib.Path(env) if env else _REPO / "KERNELS_CUDA.jsonl"


def measured_flops_rate(kernel_family: str = "cuda-bf16", path=None,
                        config: tuple | None = None) -> float | None:
    """Best measured fused-pair flops rate (flops/s) of one kernel family
    (``cuda-bf16``, ``cuda-f32`` or ``torch``) in a ``bench kernels``
    records file (default :func:`kernel_records_path`), optionally at one
    ``(log_m, nnz/row bucket, R)`` grid point. None without a match.
    Records store ``fused_pair_gflops = 2 * (2 * nnz * R) / t``, the rate
    :func:`pair_time` charges ``4 * nnz * R`` flops at."""
    p = pathlib.Path(path) if path is not None else kernel_records_path()
    try:
        lines = p.read_text().splitlines()
    except OSError:
        return None
    best = None
    for line in lines:
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(rec, dict) or rec.get("kernel") != kernel_family:
            continue
        if config is not None:
            M, nnz = rec.get("M") or 0, rec.get("nnz") or 0
            if M < 1 or (round(math.log2(M)), pow2_bucket(nnz / M), rec.get("R")) != \
                    tuple(config):
                continue
        g = rec.get("fused_pair_gflops")
        if g and (best is None or g > best):
            best = g
    return None if best is None else best * 1e9


def family_flops_rate(kernel_family: str) -> float:
    """The rate the model charges one kernel family: measured at the
    headline, else its best measured anywhere, else its fallback literal
    (the ``cuda-bf16`` one for a family without a literal)."""
    return (measured_flops_rate(kernel_family, config=HEADLINE_CONFIG)
            or measured_flops_rate(kernel_family)
            or FALLBACK_FLOPS_RATES.get(kernel_family, FALLBACK_FLOPS_RATES["cuda-bf16"]))


@dataclasses.dataclass(frozen=True)
class Machine:
    link_words_per_s: float = DEFAULT_LINK_WORDS_PER_S
    alpha_s: float = DEFAULT_ALPHA_S
    flops_rate: float = dataclasses.field(
        default_factory=lambda: family_flops_rate("cuda-bf16"))


# Per-model volume components: the one place each replicate / ring /
# reduce formula lives. ``pair_words`` and ``_discountable_terms`` both
# assemble from them, so the words view and the bytes view cannot drift.


def _dense_shift_components(M, N, R, p, c, n_pass, n_repl):
    """(replicated words, n_repl included; ring words)."""
    replicate = (c - 1) / c * (M * R * c / p)
    ring = (p / c - 1) * (N * R / p) * n_pass
    return n_repl * replicate, ring


def _dense_shift_words(M, N, R, p, c, n_pass, n_repl):
    replicate, ring = _dense_shift_components(M, N, R, p, c, n_pass, n_repl)
    return replicate + ring


def _sparse_shift_components(M, N, R, nnz, p, c, n_pass):
    """(replicate words, the whole ring's words, the ring's float-value
    third: rows and cols travel as integers and never take a discount)."""
    replicate = (c - 1) / c * (N * R * c / p)
    ring = (p / c - 1) * (3 * nnz / p) * n_pass
    ring_vals = (p / c - 1) * (nnz / p) * n_pass
    return replicate, ring, ring_vals


def _sparse_shift_words(M, N, R, nnz, p, c, n_pass):
    replicate, ring, _ = _sparse_shift_components(M, N, R, nnz, p, c, n_pass)
    return replicate + ring


def _sqrtpc(p: int, c: int) -> int:
    """sqrt(p/c) of a 2.5D grid; ValueError when p/c is not a square."""
    if c < 1 or p % c:
        raise ValueError(f"c={c} must divide p={p}")
    s = math.isqrt(p // c)
    if s * s * c != p:
        raise ValueError(f"2.5D models require p/c square (p={p}, c={c})")
    return s


def _cannon_dense_components(M, N, R, p, c):
    """(block_a, block_b, steps, fiber-broadcast words, fiber
    reduce-scatter words). block_a's ring share is the rotating OUTPUT (an
    accumulator for wire pricing); block_b's rides read-only."""
    s = _sqrtpc(p, c)
    block_a = (M / (s * c)) * (R / s)
    block_b = (N / (s * c)) * (R / s)
    steps = max(s // c, 1)
    replicate = (c - 1) / c * c * (block_a + block_b)
    reduce_out = (c - 1) / c * c * block_a
    return block_a, block_b, steps, replicate, reduce_out


def _cannon_dense_words(M, N, R, p, c):
    """Both dense blocks ride the Cannon rotation, each layer covering s/c
    of the s steps; the fiber carries the one-time dense broadcast and the
    output reduce-scatter."""
    block_a, block_b, steps, replicate, reduce_out = \
        _cannon_dense_components(M, N, R, p, c)
    return replicate + steps * (block_a + block_b) + reduce_out


def _cannon_sparse_components(M, N, R, nnz, p, c):
    """(block_a, block_b, steps, fiber reduce-scatter words): the dense
    variant's roles minus the ingest-time sparse replication, which the
    model does not charge a pair."""
    s = _sqrtpc(p, c)
    block_a = (M / s) * (R / (s * c))
    block_b = (N / s) * (R / (s * c))
    steps = max(s // c, 1)
    reduce_out = (c - 1) / c * c * block_a
    return block_a, block_b, steps, reduce_out


def _cannon_sparse_words(M, N, R, nnz, p, c):
    """The sparse tiles are resident; the dense blocks ride and the fiber
    carries the output reduction."""
    block_a, block_b, steps, reduce_out = \
        _cannon_sparse_components(M, N, R, nnz, p, c)
    return steps * (block_a + block_b) + reduce_out


def pair_words(alg: str, M: int, N: int, R: int, nnz: int, p: int, c: int) -> float:
    """Modeled per-device words (elements, whatever the wire) of one fused
    pair: the volume term of :func:`pair_time`. ValueError for a grid the
    model cannot take or an unknown model."""
    return _pair_words_hops(alg, M, N, R, nnz, p, c)[0]


def _discountable_terms(alg, M, N, R, nnz, p, c) -> list[tuple[str, float]]:
    """``(wire role, words)`` of every float-element term of one model:
    the payloads a reduced-precision policy could shrink, tagged with the
    role that decides whether it does. Integer index traffic (2/3 of the
    sparse shift's ring) is absent: indices never cast."""
    if alg in ("15d_fusion2", "15d_fusion1", "15d_unfused"):
        n_pass = 1 if alg == "15d_fusion2" else 2
        n_repl = 2 if alg == "15d_unfused" else 1
        replicate, ring = _dense_shift_components(M, N, R, p, c, n_pass, n_repl)
        return [("gather", replicate), ("ring", ring)]
    if alg == "15d_sparse":
        replicate, _ring, ring_vals = _sparse_shift_components(
            M, N, R, nnz, p, c, n_pass=1)
        return [("gather", replicate), ("ring", ring_vals)]
    if alg == "25d_dense":
        block_a, block_b, steps, replicate, reduce_out = \
            _cannon_dense_components(M, N, R, p, c)
        return [("ring", steps * block_b), ("ring_accum", steps * block_a),
                ("reduce", reduce_out), ("gather", replicate)]
    if alg == "25d_sparse":
        block_a, block_b, steps, reduce_out = \
            _cannon_sparse_components(M, N, R, nnz, p, c)
        return [("ring", steps * block_b), ("ring_accum", steps * block_a),
                ("reduce", reduce_out)]
    raise ValueError(f"unknown model {alg!r}")


def pair_bytes(alg: str, M: int, N: int, R: int, nnz: int, p: int, c: int,
               wire=None) -> float:
    """Modeled per-device bytes of one fused pair under a wire policy
    (None or ``"f32"``: the identity wire): ``4 * pair_words`` less each
    float term's realized discount, so the f32 policy is exactly four
    bytes a word and a policy earns the discount only where it casts."""
    from distributed_sddmm_tpu_torch.parallel.wire import wire_policy

    policy = wire_policy(wire if wire is not None else "f32")
    total = 4.0 * _pair_words_hops(alg, M, N, R, nnz, p, c)[0]
    for role, words in _discountable_terms(alg, M, N, R, nnz, p, c):
        total -= words * (4 - policy.bytes_for(role))
    return total


def _pair_words_hops(alg, M, N, R, nnz, p, c) -> tuple[float, float]:
    if c < 1 or p % c:
        raise ValueError(f"c={c} must divide p={p}")
    if alg == "15d_fusion2":
        return _dense_shift_words(M, N, R, p, c, n_pass=1, n_repl=1), p / c - 1
    if alg == "15d_fusion1":
        return _dense_shift_words(M, N, R, p, c, n_pass=2, n_repl=1), 2 * (p / c - 1)
    if alg == "15d_unfused":
        return _dense_shift_words(M, N, R, p, c, n_pass=2, n_repl=2), 2 * (p / c - 1)
    if alg == "15d_sparse":
        return _sparse_shift_words(M, N, R, nnz, p, c, n_pass=1), p / c - 1
    if alg == "25d_dense":
        return _cannon_dense_words(M, N, R, p, c), max(_sqrtpc(p, c) // c, 1)
    if alg == "25d_sparse":
        return _cannon_sparse_words(M, N, R, nnz, p, c), max(_sqrtpc(p, c) // c, 1)
    raise ValueError(f"unknown model {alg!r}")


def pair_time(alg: str, M: int, N: int, R: int, nnz: int, p: int, c: int,
              machine: Machine | None = None, wire=None) -> float:
    """Modeled seconds of one fused pair on p ranks at replication c
    (``alg`` in 15d_fusion1, 15d_fusion2, 15d_unfused, 15d_sparse,
    25d_dense, 25d_sparse). ValueError for a (p, c) the algorithm cannot
    run, as the strategy constructors refuse it. ``wire`` prices the
    volume in realized bytes (re-expressed in float32 words); None keeps
    the f32 words pricing."""
    machine = Machine() if machine is None else machine
    words, hops = _pair_words_hops(alg, M, N, R, nnz, p, c)
    if wire is not None:
        words = pair_bytes(alg, M, N, R, nnz, p, c, wire=wire) / 4.0
    compute = 4.0 * nnz * R / p / machine.flops_rate
    return words / machine.link_words_per_s + hops * machine.alpha_s + compute


def optimal_c(alg: str, M: int, N: int, R: int, nnz: int, p: int,
              machine: Machine | None = None) -> int:
    """argmin over c of :func:`pair_time`, over the divisors of p the
    algorithm accepts."""
    times = {}
    for c in range(1, p + 1):
        if p % c:
            continue
        try:
            times[c] = pair_time(alg, M, N, R, nnz, p, c, machine)
        except ValueError:
            continue
    if not times:
        raise ValueError(f"no legal c for {alg!r} at p={p}")
    return min(times, key=times.get)


def model_curves(M: int, N: int, R: int, nnz: int, p: int,
                 machine: Machine | None = None) -> dict:
    """``{alg: {c: seconds}}`` over the divisors of p: the notebook's T(c)
    curves."""
    cs = [c for c in range(1, p + 1) if p % c == 0]
    return {
        alg: {c: pair_time(alg, M, N, R, nnz, p, c, machine) for c in cs}
        for alg in ("15d_fusion2", "15d_fusion1", "15d_unfused", "15d_sparse")
    }


def main(argv=None) -> int:
    """Print the T(c) curves and c* of a configuration as JSON."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("log_m", type=int)
    ap.add_argument("nnz_per_row", type=int)
    ap.add_argument("R", type=int)
    ap.add_argument("p", type=int)
    ap.add_argument("--kernel", default="cuda-bf16", choices=sorted(FALLBACK_FLOPS_RATES),
                    help="the kernel family whose flops rate prices the compute term")
    args = ap.parse_args(argv)

    M = 1 << args.log_m
    nnz = M * args.nnz_per_row
    at_point = measured_flops_rate(
        args.kernel, config=(args.log_m, pow2_bucket(args.nnz_per_row), args.R))
    measured = measured_flops_rate(args.kernel, config=HEADLINE_CONFIG) \
        or measured_flops_rate(args.kernel)
    rate = at_point or family_flops_rate(args.kernel)
    source = ("measured at this grid point" if at_point
              else "measured, headline or best" if measured
              else "fallback literal (no kernel records)")
    machine = Machine(flops_rate=rate)
    curves = model_curves(M, M, args.R, nnz, args.p, machine)
    print(json.dumps({
        "config": {"log_m": args.log_m, "nnz_per_row": args.nnz_per_row,
                   "R": args.R, "p": args.p, "kernel": args.kernel},
        "machine": {"link_words_per_s": machine.link_words_per_s,
                    "alpha_s": machine.alpha_s, "flops_rate": rate,
                    "flops_rate_source": source},
        "models": {
            alg: {"c_optimal": min(series, key=series.get),
                  "ms_by_c": {str(c): round(t * 1e3, 4) for c, t in series.items()}}
            for alg, series in curves.items()
        },
    }, indent=2))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
