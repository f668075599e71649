"""Benchmark command line: ``python -m distributed_sddmm_tpu_torch.bench``
(counterpart of ``bench/cli.py``).

One subcommand so far, ``er``: an R-mat matrix of ``2**log_m`` rows and
``edge_factor`` edges a row, one R, one c, and one algorithm or a group of
them (``ALG_GROUPS``, the reference's ``bench_erdos_renyi.cpp:50-115``:
``15d``, ``25d``, ``all``), each member run in turn with a record of its
own. A member that refuses the configuration (a grid or R it cannot split,
an app or a fusion build it lacks) is reported on stderr and skipped, as
the JAX sweep driver skips it. With
``--app attention`` the matrix is replaced by the ``--mask`` pattern over
as many tokens, and the run times fused block-sparse attention;
``--app gat`` times the GAT forward pass and ``--app als`` alternating
ALS-CG steps, whose factors persist under ``--checkpoint-dir`` (every
``--checkpoint-every`` steps; ``--resume`` starts from the newest valid
checkpoint there). With
``--kernel-variant VID`` the local kernel is the banked CUDA kernel of that
codegen variant (``codegen/``), which refuses ``--kernel torch`` as the
JAX CLI refuses a kernel other than pallas. ``--fusion overlap`` runs the
double-buffered ring and ``--breakdown`` the region attribution, as in the
JAX CLI. The world comes from the environment
(``parallel/comm.world_from_env``): ``torchrun`` starts one rank a
process (NCCL on ``cuda``, gloo on ``cpu``), otherwise
``SDDMM_TORCH_LOCAL_RANKS=P`` runs P logical ranks in this process (default
1). Each run prints one JSON summary line and appends its full record to
``-o`` (process 0 only). Flags whose machinery is not ported (tracing,
faults, wire precision) are not defined, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch.distributed as dist

from distributed_sddmm_tpu_torch import masks
from distributed_sddmm_tpu_torch.bench.harness import (
    ALGORITHM_FACTORIES, APPS, benchmark_algorithm,
)
from distributed_sddmm_tpu_torch.codegen import make_banked_kernel
from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.comm import world_from_env
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

KERNELS = ("cuda-f32", "cuda-bf16", "torch")

# ``bench_erdos_renyi.cpp:50-115``: "15d" runs the three 1.5D strategies,
# "25d" both replication strategies.
ALG_GROUPS = {
    "15d": ["15d_fusion1", "15d_fusion2", "15d_sparse"],
    "25d": ["25d_dense_replicate", "25d_sparse_replicate"],
    "all": list(ALGORITHM_FACTORIES),
}


def resolve_algs(name: str) -> list[str]:
    """The algorithms an ``alg`` argument names: a group's members or the
    one algorithm."""
    if name in ALG_GROUPS:
        return ALG_GROUPS[name]
    if name in ALGORITHM_FACTORIES:
        return [name]
    raise SystemExit(
        f"unknown algorithm {name!r}; expected one of "
        f"{sorted(ALGORITHM_FACTORIES) + sorted(ALG_GROUPS)}"
    )


def _kernel(name: str | None, device, variant: str | None = None):
    """The local kernel named by ``--kernel``; None is the strategy's own
    default (cuda-bf16 on a card, cuda-f32 on the CPU). A ``variant`` id
    gives the banked kernel of that variant in the named precision."""
    if variant:
        if name == "torch":
            raise SystemExit("--kernel-variant requires a cuda kernel")
        precision = None if name is None else name.removeprefix("cuda-")
        return make_banked_kernel(variant, precision=precision, device=device)
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
    er.add_argument("alg", help="algorithm name or group (15d | 25d | all)")
    er.add_argument("R", type=int)
    er.add_argument("c", type=int)
    er.add_argument("--app", default="vanilla", choices=APPS)
    er.add_argument(
        "--mask", default="window:16", metavar="SPEC",
        help="with --app attention: the mask, window:<w>, "
        "bigbird:w=..,g=..,r=.. or graph (the R-mat matrix's own pattern); "
        "it replaces the matrix and rides into the record",
    )
    er.add_argument("--trials", type=int, default=5)
    er.add_argument("--warmup", type=int, default=1)
    er.add_argument("--fused", default="yes", choices=["yes", "no", "both"])
    er.add_argument(
        "--fusion", default="sequential", choices=["sequential", "overlap"],
        help="ring-loop build for the 1.5D shift strategies: 'sequential' "
        "(kernel then ppermute per tile) or 'overlap' (double-buffered "
        "local kernel overlap: the next tile's ppermute is issued before "
        "the current tile's kernel, the reference's BufferPair strategy); "
        "bit-identical results",
    )
    er.add_argument(
        "--breakdown", action="store_true",
        help="add {Replication, Propagation, Computation} region attribution "
        "to perf_stats (collective-ablation timing)",
    )
    er.add_argument("--kernel", default=None, choices=KERNELS,
                    help="local kernel (default: cuda-bf16 on cuda, "
                    "cuda-f32 on cpu)")
    er.add_argument("--kernel-variant", default=None, metavar="VID",
                    help="codegen variant id (v1.rb<thr>.<rs|rm|rl>): run the "
                    "banked CUDA kernel, one launch per row band")
    er.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="persist app state (ALS factors) under DIR atomically")
    er.add_argument("--checkpoint-every", type=int, default=1, metavar="N",
                    help="checkpoint every N alternating steps (with --checkpoint-dir)")
    er.add_argument("--resume", action="store_true",
                    help="resume from the newest valid checkpoint in --checkpoint-dir "
                    "instead of step 0 (corrupt checkpoints scan back; none = fresh)")
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
    if args.breakdown and (args.app != "vanilla" or args.fused != "yes"):
        raise SystemExit(
            "--breakdown requires --app vanilla and --fused yes "
            "(it attributes the fusedSpMM op)"
        )
    device = resolve_device(args.device)
    owns_group = not dist.is_initialized()
    world = world_from_env(device)
    try:
        S = HostCOO.rmat(args.log_m, args.edge_factor, np.random.default_rng(0))
        S = _maybe_mask(S, args)
        kernel = _kernel(args.kernel, device, args.kernel_variant)
        for alg in resolve_algs(args.alg):
            for fused in [True, False] if args.fused == "both" else [args.fused == "yes"]:
                try:
                    rec = benchmark_algorithm(
                        S, alg, args.output_file, fused=fused, R=args.R, c=args.c,
                        app=args.app, trials=args.trials, warmup=args.warmup,
                        kernel=kernel, device=device,
                        mask=args.mask if args.app == "attention" else None,
                        world=world, overlap=args.fusion == "overlap",
                        breakdown=args.breakdown, checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every, resume=args.resume,
                    )
                except (ValueError, NotImplementedError) as e:
                    # A grid, R, app or fusion build the member lacks.
                    print(f"skip {alg} R={args.R} c={args.c}: {e}", file=sys.stderr,
                          flush=True)
                    continue
                if world.process_index == 0:
                    print(json.dumps({
                        "algorithm": alg, "R": args.R, "c": args.c, "fused": fused,
                        "elapsed": round(rec["elapsed"], 4),
                        "GFLOPs": round(rec["overall_throughput"], 3),
                    }), flush=True)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return 0
