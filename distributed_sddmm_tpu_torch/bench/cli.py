"""Benchmark command line: ``python -m distributed_sddmm_tpu_torch.bench``
(counterpart of ``bench/cli.py``).

Subcommands:

* ``er``       -- R-mat synthetic benchmark (the reference's
  ``bench_erdos_renyi.cpp``): an R-mat matrix of ``2**log_m`` rows and
  ``edge_factor`` edges a row (seed 0, the JAX package's draw), one R, one
  c, and one algorithm or a group of them (``ALG_GROUPS``: ``15d``,
  ``25d``, ``all``), each member run in turn with a record of its own, or
  ``auto``: the autotuner's plan (``autotune/``) picks the algorithm, c,
  kernel variant and wire for each (matrix, R) under ``--plan-mode``,
  prints ``plan[<source>] ...`` on stderr and puts the plan into the
  record;
* ``file``     -- the same on a matrix-market file (``bench_file.cpp``),
  ``--permute`` applying a random row and column permutation (seed 0)
  first;
* ``heatmap``  -- an R sweep on one R-mat (``bench_heatmap.cpp``), one
  record an R of ``--r-values`` (default ``HEATMAP_R_VALUES``);
* ``permute``  -- randomly permute a ``.mtx`` file into
  ``<in>-permuted.mtx`` or ``-o`` (``random_permute.cpp``);
* ``kernels``  -- the one-device local-kernel sweep (``bench/kernels.py``,
  ``local_kernel_benchmark.cpp``);
* ``verify``   -- every algorithm's fingerprints against the float64
  oracle (``scratch.cpp``); exits 1 on a mismatch;
* ``baseline`` -- scipy CSR SpMM on the host (``bench/baseline.py``, the
  reference's PETSc baseline), the one subcommand that uses no card.

``er``, ``file`` and ``heatmap`` share their flags (``_add_common``). A
member of a group that refuses the configuration (a grid or R it cannot
split, an app or a fusion build it lacks) is reported on stderr and
skipped, as the JAX package's sweep skips it. With ``--app attention`` the
matrix is replaced by the ``--mask`` pattern over as many tokens, and the
run times fused block-sparse attention; ``--app gat`` times the GAT
forward pass and ``--app als`` alternating ALS-CG steps, whose factors
persist under ``--checkpoint-dir`` (every ``--checkpoint-every`` steps;
``--resume`` starts from the newest valid checkpoint there). With
``--kernel-variant VID`` the local kernel is the banked CUDA kernel of
that codegen variant (``codegen/``), which refuses ``--kernel torch`` as
the JAX CLI refuses a kernel other than pallas. ``--fusion overlap`` runs
the double-buffered ring and ``--breakdown`` the region attribution, as in
the JAX CLI. ``--wire bf16`` casts the collectives' gather and ring
payloads to bf16 on the wire (``parallel/wire.py``); the record's
``wire`` names the realized policy. With ``auto`` the plan's wire and c
supersede ``--wire`` and the positional c, and ``--kernel`` names the
kernel family (the precision) the plan may use.

Every subcommand that uses the card takes ``--device`` (default ``cuda``,
which raises without one; ``cpu`` runs the plain versions). The world
comes from the environment (``parallel/comm.world_from_env``):
``torchrun`` starts one rank a process (NCCL on ``cuda``, gloo on
``cpu``), otherwise ``SDDMM_TORCH_LOCAL_RANKS=P`` runs P logical ranks in
this process (default 1). Each run prints one JSON summary line and
appends its full record to ``-o`` (process 0 only). Flags whose machinery
is not ported (tracing, profiling, faults, the watchdog, the flight
recorder, the run store) and the subcommands that are not (``overlap``,
``serve``, ``fleet``, ``tune``, the run-store and trace tools, ``top``,
``lint``, ``env``) are not defined, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch.distributed as dist

from distributed_sddmm_tpu_torch import masks
from distributed_sddmm_tpu_torch.autotune import Problem, get_plan
from distributed_sddmm_tpu_torch.bench import kernels as kernel_bench
from distributed_sddmm_tpu_torch.bench.baseline import run_baseline
from distributed_sddmm_tpu_torch.bench.harness import (
    ALGORITHM_FACTORIES, APPS, benchmark_algorithm,
)
from distributed_sddmm_tpu_torch.codegen import make_banked_kernel
from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import TorchKernel
from distributed_sddmm_tpu_torch.parallel.comm import world_from_env
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.verify import verify_algorithms

KERNELS = ("cuda-f32", "cuda-bf16", "torch")

# ``bench_erdos_renyi.cpp:50-115``: "15d" runs the three 1.5D strategies,
# "25d" both replication strategies.
ALG_GROUPS = {
    "15d": ["15d_fusion1", "15d_fusion2", "15d_sparse"],
    "25d": ["25d_dense_replicate", "25d_sparse_replicate"],
    "all": list(ALGORITHM_FACTORIES),
}

# ``bench_heatmap.cpp:33-35``.
HEATMAP_R_VALUES = [64, 128, 192, 256, 320, 384, 448]


def resolve_algs(name: str) -> list[str]:
    """The algorithms an ``alg`` argument names: a group's members, the
    one algorithm, or ``auto`` (a plan a run, ``_run_configs``)."""
    if name == "auto":
        return ["auto"]
    if name in ALG_GROUPS:
        return ALG_GROUPS[name]
    if name in ALGORITHM_FACTORIES:
        return [name]
    raise SystemExit(
        f"unknown algorithm {name!r}; expected one of "
        f"{sorted(ALGORITHM_FACTORIES) + sorted(ALG_GROUPS) + ['auto']}"
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


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def _add_common(p: argparse.ArgumentParser) -> None:
    """The flags ``er``, ``file`` and ``heatmap`` share."""
    p.add_argument("--app", default="vanilla", choices=APPS)
    p.add_argument(
        "--mask", default="window:16", metavar="SPEC",
        help="with --app attention: the mask, window:<w>, "
        "bigbird:w=..,g=..,r=.. or graph (the matrix's own pattern); "
        "it replaces the matrix and rides into the record",
    )
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--fused", default="yes", choices=["yes", "no", "both"])
    p.add_argument(
        "--fusion", default="sequential", choices=["sequential", "overlap"],
        help="ring-loop build for the 1.5D shift strategies: 'sequential' "
        "(kernel then ppermute per tile) or 'overlap' (double-buffered "
        "local kernel overlap: the next tile's ppermute is issued before "
        "the current tile's kernel, the reference's BufferPair strategy); "
        "bit-identical results",
    )
    p.add_argument(
        "--breakdown", action="store_true",
        help="add {Replication, Propagation, Computation} region attribution "
        "to perf_stats (collective-ablation timing)",
    )
    p.add_argument("--kernel", default=None, choices=KERNELS,
                   help="local kernel (default: cuda-bf16 on cuda, cuda-f32 on cpu)")
    p.add_argument("--kernel-variant", default=None, metavar="VID",
                   help="codegen variant id (v1.rb<thr>.<rs|rm|rl>): run the "
                   "banked CUDA kernel, one launch per row band; plans select one "
                   "automatically via the algorithm 'auto'")
    p.add_argument(
        "--plan-mode", default="model", choices=["model", "auto", "measure"],
        help="with the algorithm 'auto': 'model' selects by cost model / "
        "cache only (fast, no trial runs); 'measure' times the top "
        "candidates first; 'auto' measures when possible",
    )
    p.add_argument(
        "--wire", default=None, choices=["f32", "bf16"],
        help="wire-precision policy for the distributed collectives "
        "(parallel/wire.py): 'bf16' halves gather/ring payload bytes "
        "with f32 accumulation everywhere; 'f32' (and the default, "
        "absent SDDMM_TORCH_WIRE) is the bit-identical identity wire. With "
        "the algorithm 'auto' the plan's comm_dtype axis supersedes this",
    )
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="persist app state (ALS factors) under DIR atomically")
    p.add_argument("--checkpoint-every", type=int, default=1, metavar="N",
                   help="checkpoint every N alternating steps (with --checkpoint-dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid checkpoint in --checkpoint-dir "
                   "instead of step 0 (corrupt checkpoints scan back; none = fresh)")
    _add_device(p)
    p.add_argument("-o", "--output-file", default=None, help="append JSON records here")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="distributed_sddmm_tpu_torch.bench",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    er = sub.add_parser("er", help="synthetic R-mat benchmark")
    er.add_argument("log_m", type=int, help="log2 of matrix side")
    er.add_argument("edge_factor", type=int, help="average nnz per row")
    er.add_argument("alg", help="algorithm name or group (15d | 25d | all)")
    er.add_argument("R", type=int)
    er.add_argument("c", type=int)
    _add_common(er)

    fi = sub.add_parser("file", help="matrix-market file benchmark")
    fi.add_argument("path", help=".mtx file")
    fi.add_argument("alg", help="algorithm name or group (15d | 25d | all)")
    fi.add_argument("R", type=int)
    fi.add_argument("c", type=int)
    fi.add_argument("--permute", action="store_true",
                    help="random row/col permutation (seed 0) first")
    _add_common(fi)

    hm = sub.add_parser("heatmap", help="R-value sweep on one synthetic matrix")
    hm.add_argument("log_m", type=int)
    hm.add_argument("edge_factor", type=int)
    hm.add_argument("c", type=int)
    hm.add_argument("--alg", default="all")
    hm.add_argument("--r-values", type=int, nargs="+", default=HEATMAP_R_VALUES)
    _add_common(hm)

    pm = sub.add_parser("permute", help="randomly permute a .mtx file")
    pm.add_argument("path")
    pm.add_argument("--seed", type=int, default=0)
    pm.add_argument("-o", "--output-file", default=None, help="default <in>-permuted.mtx")

    kn = sub.add_parser("kernels", help="one-device local-kernel sweep")
    kn.add_argument("--log-m", type=int, nargs="+", default=None)
    kn.add_argument("--nnz-per-row", type=int, nargs="+", default=None)
    kn.add_argument("--r-values", type=int, nargs="+", default=None)
    kn.add_argument("--kernels", nargs="+", default=kernel_bench.DEFAULT_KERNELS,
                    choices=KERNELS)
    kn.add_argument("--trials", type=int, default=5)
    _add_device(kn)
    kn.add_argument("-o", "--output-file", default=None)

    vf = sub.add_parser("verify", help="fingerprint cross-check of algorithms")
    vf.add_argument("--log-m", type=int, default=8)
    vf.add_argument("--edge-factor", type=int, default=8)
    vf.add_argument("--R", type=int, default=16)
    vf.add_argument("--c", type=int, default=1)
    vf.add_argument("--alg", default="all")
    vf.add_argument("--kernel", default="cuda-f32", choices=KERNELS)
    _add_device(vf)

    bl = sub.add_parser("baseline", help="external host-CPU SpMM baseline (no card)")
    bl.add_argument("log_m", type=int)
    bl.add_argument("edge_factor", type=int)
    bl.add_argument("R", type=int)
    bl.add_argument("--iters", type=int, default=10)
    bl.add_argument("-o", "--output-file", default=None)
    return ap


def _maybe_mask(S: HostCOO, args) -> HostCOO:
    """With ``--app attention`` the benchmark matrix is the mask, built
    from ``--mask`` over the matrix's token count (``graph`` keeps the
    matrix's own pattern)."""
    if args.app != "attention":
        return S
    return masks.from_spec(args.mask, n=max(S.M, S.N), graph=S)


def _plan(S: HostCOO, R: int, args, device, world):
    """The autotuner's plan for ``S`` at ``R`` under ``--plan-mode``, its
    ``plan[...]`` line printed on stderr (process 0)."""
    mode = args.plan_mode
    plan = get_plan(Problem.from_coo(S, R), world,
                    S=S if mode in ("auto", "measure") else None,
                    device=device, kernel=args.kernel, mode=mode)
    if world.process_index == 0:
        print(f"plan[{plan.source}] {plan.algorithm} c={plan.c} kernel={plan.kernel}"
              + (f" variant={plan.variant}" if plan.variant else "")
              + (f" wire={plan.wire}" if plan.wire else "")
              + (" (chunked)" if plan.gather_budget else ""),
              file=sys.stderr, flush=True)
    return plan


def _run_configs(S: HostCOO, args, device, world, r_values) -> list:
    """Every member of ``args.alg`` at every R of ``r_values`` and every
    fused setting: one record and one summary line each; a member that
    refuses is skipped with a line on stderr. ``auto`` runs the plan
    selected for each R, its c, kernel and wire superseding the
    positional c, ``--kernel-variant`` and ``--wire``."""
    records = []
    for alg in resolve_algs(args.alg):
        for R in r_values:
            plan = None
            if alg == "auto":
                plan = _plan(S, R, args, device, world)
                run_alg, run_c, kernel, wire = (plan.algorithm, plan.c,
                                                plan.make_kernel(device), plan.wire)
            else:
                run_alg, run_c, wire = alg, args.c, args.wire
                kernel = _kernel(args.kernel, device, args.kernel_variant)
            for fused in [True, False] if args.fused == "both" else [args.fused == "yes"]:
                try:
                    rec = benchmark_algorithm(
                        S, run_alg, args.output_file, fused=fused, R=R, c=run_c,
                        app=args.app, trials=args.trials, warmup=args.warmup,
                        kernel=kernel, device=device,
                        mask=args.mask if args.app == "attention" else None,
                        world=world, overlap=args.fusion == "overlap",
                        breakdown=args.breakdown, checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every, resume=args.resume,
                        wire=wire, extra_info={"plan": plan.to_dict()} if plan else None,
                    )
                except (ValueError, NotImplementedError) as e:
                    # A grid, R, app or fusion build the member lacks.
                    print(f"skip {run_alg} R={R} c={run_c}: {e}", file=sys.stderr,
                          flush=True)
                    continue
                records.append(rec)
                if world.process_index == 0:
                    print(json.dumps({
                        "algorithm": run_alg, "R": R, "c": run_c, "fused": fused,
                        "elapsed": round(rec["elapsed"], 4),
                        "GFLOPs": round(rec["overall_throughput"], 3),
                    }), flush=True)
    return records


@contextlib.contextmanager
def _world(device):
    """The world the environment describes; a process group this opened is
    destroyed on the way out."""
    owns_group = not dist.is_initialized()
    try:
        yield world_from_env(device)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _benchmark(args) -> int:
    """``er``, ``file`` and ``heatmap``: the matrix, then the runs."""
    if args.breakdown and (args.app != "vanilla" or args.fused != "yes"):
        raise SystemExit(
            "--breakdown requires --app vanilla and --fused yes "
            "(it attributes the fusedSpMM op)"
        )
    device = resolve_device(args.device)
    with _world(device) as world:
        if args.cmd == "file":
            S = HostCOO.load_mtx(args.path)
            if args.permute:
                S = S.random_permuted(seed=0)
        else:
            S = HostCOO.rmat(args.log_m, args.edge_factor, seed=0, device=device)
        r_values = args.r_values if args.cmd == "heatmap" else [args.R]
        _run_configs(_maybe_mask(S, args), args, device, world, r_values)
    return 0


def _verify(args) -> int:
    device = resolve_device(args.device)
    with _world(device) as world:
        ok = verify_algorithms(log_m=args.log_m, edge_factor=args.edge_factor, R=args.R,
                               c=args.c, alg_names=resolve_algs(args.alg),
                               kernel=_kernel(args.kernel, device), verbose=True,
                               device=device, world=world)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in ("er", "file", "heatmap"):
        return _benchmark(args)
    if args.cmd == "verify":
        return _verify(args)
    if args.cmd == "permute":
        out = args.output_file or args.path.replace(".mtx", "-permuted.mtx")
        S = HostCOO.load_mtx(args.path).random_permuted(seed=args.seed)
        S.save_mtx(out)
        print(f"wrote {out} ({S.M}x{S.N}, nnz={S.nnz})")
        return 0
    if args.cmd == "kernels":
        kernel_bench.run_kernel_benchmark(
            log_m_values=args.log_m, nnz_per_row_values=args.nnz_per_row,
            r_values=args.r_values, kernels=args.kernels, trials=args.trials,
            output_file=args.output_file, device=args.device)
        return 0
    if args.cmd == "baseline":
        S = HostCOO.rmat(args.log_m, args.edge_factor, seed=0)
        print(json.dumps(run_baseline(S, R=args.R, iters=args.iters,
                                      output_file=args.output_file)))
        return 0
    raise AssertionError(args.cmd)
