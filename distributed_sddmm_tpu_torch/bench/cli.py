"""Benchmark command line: ``python -m distributed_sddmm_tpu_torch.bench``
(counterpart of ``bench/cli.py``).

One subcommand so far, ``er``: an R-mat matrix of ``2**log_m`` rows and
``edge_factor`` edges a row, one algorithm, one R, one c. With
``--app attention`` the matrix is replaced by the ``--mask`` pattern over
as many tokens, and the run times fused block-sparse attention. Each run
prints one JSON summary line and appends its full record to ``-o``. Flags
whose machinery is not ported (tracing, faults, wire precision, overlap)
are not defined, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from distributed_sddmm_tpu_torch import masks
from distributed_sddmm_tpu_torch.bench.harness import (
    APPS, APPS_NOT_PORTED, benchmark_algorithm,
)
from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

KERNELS = ("cuda-f32", "cuda-bf16", "torch")


def _kernel(name: str | None, device):
    """The local kernel named by ``--kernel``; None is the strategy's own
    default (cuda-bf16 on a card, cuda-f32 on the CPU)."""
    if name is None:
        return CudaTileKernel(device=device)
    if name == "torch":
        return TorchKernel()
    return CudaTileKernel(name.removeprefix("cuda-"), device=device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="distributed_sddmm_tpu_torch.bench",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    er = sub.add_parser("er", help="synthetic R-mat benchmark")
    er.add_argument("log_m", type=int, help="log2 of matrix side")
    er.add_argument("edge_factor", type=int, help="average nnz per row")
    er.add_argument("alg", help="algorithm name (15d_fusion1 | 15d_fusion2)")
    er.add_argument("R", type=int)
    er.add_argument("c", type=int)
    er.add_argument("--app", default="vanilla", choices=APPS + APPS_NOT_PORTED)
    er.add_argument(
        "--mask", default="window:16", metavar="SPEC",
        help="with --app attention: the mask, window:<w>, "
        "bigbird:w=..,g=..,r=.. or graph (the R-mat matrix's own pattern); "
        "it replaces the matrix and rides into the record",
    )
    er.add_argument("--trials", type=int, default=5)
    er.add_argument("--warmup", type=int, default=1)
    er.add_argument("--fused", default="yes", choices=["yes", "no", "both"])
    er.add_argument("--kernel", default=None, choices=KERNELS,
                    help="local kernel (default: cuda-bf16 on cuda, "
                    "cuda-f32 on cpu)")
    er.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    er.add_argument("-o", "--output-file", default=None,
                    help="append JSON records here")
    return ap


def _maybe_mask(S: HostCOO, args) -> HostCOO:
    """With ``--app attention`` the benchmark matrix is the mask, built
    from ``--mask`` over the matrix's token count (``graph`` keeps the
    matrix's own pattern)."""
    if args.app != "attention":
        return S
    return masks.from_spec(args.mask, n=max(S.M, S.N), graph=S)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    S = HostCOO.rmat(args.log_m, args.edge_factor, np.random.default_rng(0))
    S = _maybe_mask(S, args)
    kernel = _kernel(args.kernel, device)
    for fused in [True, False] if args.fused == "both" else [args.fused == "yes"]:
        rec = benchmark_algorithm(
            S, args.alg, args.output_file, fused=fused, R=args.R, c=args.c,
            app=args.app, trials=args.trials, warmup=args.warmup,
            kernel=kernel, device=device,
            mask=args.mask if args.app == "attention" else None,
        )
        print(json.dumps({
            "algorithm": args.alg, "R": args.R, "c": args.c, "fused": fused,
            "elapsed": round(rec["elapsed"], 4),
            "GFLOPs": round(rec["overall_throughput"], 3),
        }), flush=True)
    return 0
