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
  reference's PETSc baseline), the one subcommand that uses no card;
* ``history``, ``compare``, ``gate``, ``backfill``, ``report-html`` -- the
  run store (``obs/store.py``): list the stored runs, compare two of them
  phase by phase, gate a run against the rolling baseline of its matching
  runs (exit 0 pass, 2 regression, 3 too few baseline runs; ``obs/
  regress.py``), ingest the repository's committed headline records, and
  write a self-contained HTML report (``obs/report.py``); a run is a run
  id, a unique prefix, ``latest`` or ``latest~N``, and ``--store DIR``
  names the store;
* ``serve``    -- the online serving load test (``serve/``): ``--app als``
  (user fold-in and top-k), ``gat`` (node scoring) or ``attention`` (token
  scoring over the ``--mask`` context) on the R-mat of ``--log-m`` and
  ``--edge-factor``, a warm engine on the planned strategy, open-loop
  Poisson arrivals at ``--rate`` for ``--duration`` seconds, every
  ``--oracle-every``-th reply against the float64 oracle; exit 0 clean, 1
  on an oracle mismatch, 2 on an SLO violation (``--slo``); the record
  goes to the run store as ``app=serve-<app>``. ``--telemetry [DIR]``
  samples the engine every ``--telemetry-interval`` seconds to
  ``artifacts/telemetry_torch/<run_id>.jsonl`` (``obs/telemetry.py``),
  ``--admin-port PORT`` serves ``/metrics``, ``/healthz``, ``/readyz``,
  ``/debug/requests`` and ``/snapshot`` (``obs/httpexp.py``; 0: an
  ephemeral port, printed as ``[admin] serving http://127.0.0.1:<port>``
  on stderr), ``--serve-http`` is replica mode (no load generator:
  ``POST /submit`` and ``POST /chaos`` until SIGTERM or SIGINT, then a
  drain, the whole record as the last stdout line, exit 0), and
  ``--tuner`` runs the closed-loop tuner against the live engine
  (``tuner/``);
* ``top``      -- the live view of a serving engine: the newest stream
  under ``artifacts/telemetry_torch/`` (or a named file), or the
  ``/snapshot`` of ``--admin-port``; ``--watch N`` refreshes, ``--serve
  PORT`` re-exports a stream as ``/metrics``;
* ``tune``     -- one offline re-tune of an R-mat problem: the incumbent
  plan, the run store's realized history mined, the whole candidate space
  re-ranked and measured (``--trial wall`` on the card, ``counted``
  elsewhere), a winner stored in the plan cache (``--dry-run`` writes
  nothing);
* ``report-trace``, ``trace-merge``, ``trace-export`` -- a trace's
  per-phase table (``tools/tracereport.py``), the merge of per-process
  shards into one trace (``obs/tracemerge.py``) and its Chrome export
  (``obs/traceexport.py``); each exits 2 on a trace that fails the schema.

The store and trace tools run nothing on a device.

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

Faults and in-run observability (``er``, ``file``, ``heatmap``,
``serve``), as in the JAX CLI: ``--faults SPEC`` installs a fault plan (``resilience/faults.py``;
the record lists ``faults_fired``), ``--trace [PATH]`` writes a JSONL trace
and its manifest (default ``artifacts/traces_torch/<run_id>.jsonl``),
``--profile DIR`` a ``torch.profiler`` Chrome trace of the whole run,
``--watchdog warn|strict`` watches for anomalies (the record's
``anomalies``; ``strict`` raises), and ``--flightrec [DIR]`` dumps the
recent spans on every anomaly (default ``artifacts/flightrec_torch/``);
with ``--flightrec`` armed, ``--profile`` means a short window an anomaly
instead of the whole run. Each has its ``SDDMM_TORCH_*`` environment
knob (``FAULTS``, ``TRACE``, ``PROFILE``, ``WATCHDOG``, ``FLIGHTREC``).
What a command turned on is turned off again when it returns.

Every record of ``er``, ``file``, ``heatmap`` and ``serve`` is persisted
as one run document into the run store (default
``artifacts/runstore_torch/``; process 0 only), after the timed loop and
after ``-o``.
``SDDMM_TORCH_RUNSTORE`` relocates the store (a path) or vetoes it
(``0``/``off``), and ``--no-runstore`` beats the environment.

Every subcommand that uses the card takes ``--device`` (default ``cuda``,
which raises without one; ``cpu`` runs the plain versions). The world
comes from the environment (``parallel/comm.world_from_env``):
``torchrun`` starts one rank a process (NCCL on ``cuda``, gloo on
``cpu``), otherwise ``SDDMM_TORCH_LOCAL_RANKS=P`` runs P logical ranks in
this process (default 1). Each run prints one JSON summary line and
appends its full record to ``-o`` (process 0 only). The subcommands that
are not ported (``overlap``, ``fleet``, ``lint``, ``env``) are not
defined, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch.distributed as dist

from distributed_sddmm_tpu_torch import masks
from distributed_sddmm_tpu_torch.autotune import Problem, get_plan
from distributed_sddmm_tpu_torch.bench import harness
from distributed_sddmm_tpu_torch.bench import kernels as kernel_bench
from distributed_sddmm_tpu_torch.bench.baseline import run_baseline
from distributed_sddmm_tpu_torch.bench.harness import (
    ALGORITHM_FACTORIES, APPS, benchmark_algorithm,
)
from distributed_sddmm_tpu_torch.codegen import make_banked_kernel
from distributed_sddmm_tpu_torch.device import device_label, resolve_device
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
    p.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="activate a fault-injection plan: inline JSON spec list (or "
        "{'seed','specs'} dict), @/path/to/plan.json, or the kind shorthand "
        "'delay,nan'; equivalent to SDDMM_TORCH_FAULTS (resilience/faults.py)",
    )
    p.add_argument(
        "--trace", nargs="?", const="1", default=None, metavar="PATH",
        help="emit a structured JSONL trace (spans, comm counters, resilience "
        "events) and its run manifest; PATH is a .jsonl file or a directory, "
        "default artifacts/traces_torch/<run_id>.jsonl (SDDMM_TORCH_TRACE)",
    )
    p.add_argument(
        "--profile", default=None, metavar="LOGDIR",
        help="capture a torch.profiler trace (CPU, and CUDA on the card) of the "
        "run into LOGDIR as a Chrome trace, a named range per timed op "
        "(SDDMM_TORCH_PROFILE)",
    )
    p.add_argument(
        "--watchdog", default=None, choices=["warn", "strict"],
        help="in-run anomaly monitor: step-time spikes and drift, repair "
        "storms, comm against the cost model; 'warn' reports (anomaly trace "
        "events and the record's 'anomalies'), 'strict' raises "
        "(SDDMM_TORCH_WATCHDOG)",
    )
    p.add_argument(
        "--flightrec", nargs="?", const="1", default=None, metavar="DIR",
        help="arm the anomaly flight recorder: every watchdog anomaly dumps the "
        "recent spans and the counters (and a short profiler window with "
        "--profile) to artifacts/flightrec_torch/<run_id>/; DIR relocates "
        "(SDDMM_TORCH_FLIGHTREC)",
    )
    p.add_argument(
        "--no-runstore", action="store_true",
        help="do not persist records into the run store (default "
        "artifacts/runstore_torch/, or SDDMM_TORCH_RUNSTORE); beats the "
        "environment",
    )
    _add_device(p)
    p.add_argument("-o", "--output-file", default=None, help="append JSON records here")


def _add_serve(sub) -> None:
    """``serve``: the JAX subcommand's flags."""
    sv = sub.add_parser(
        "serve",
        help="online serving load test: a warm engine on the planned strategy, "
        "dynamic micro-batching, open-loop Poisson arrivals, an SLO-gated latency "
        "report (serve/); the record goes to the run store as app=serve-<app>")
    sv.add_argument("--app", default="als", choices=["als", "gat", "attention"])
    sv.add_argument(
        "--mask", default="window:16", metavar="SPEC",
        help="with --app attention: the mask of the warm context, window:<w>, "
        "bigbird:w=..,g=..,r=.. or graph (the R-mat's own pattern)")
    sv.add_argument("--window", type=int, default=None, metavar="W",
                    help="with --app attention: the per-request window half-width "
                    "(default SDDMM_TORCH_ATTN_SERVE_WINDOW, else 16)")
    sv.add_argument("--log-m", type=int, default=8, help="log2 matrix side")
    sv.add_argument("--edge-factor", type=int, default=8)
    sv.add_argument("--R", type=int, default=16)
    sv.add_argument("--duration", type=float, default=10.0, metavar="SECONDS",
                    help="load-generation window")
    sv.add_argument("--rate", type=float, default=30.0, metavar="HZ",
                    help="offered Poisson arrival rate (requests/s)")
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--max-depth", type=int, default=64,
                    help="admission bound; beyond it requests shed")
    sv.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="micro-batch linger after the first arrival")
    sv.add_argument("--k", type=int, default=10, help="ALS top-k size")
    sv.add_argument("--train-steps", type=int, default=2,
                    help="ALS warm-model alternating steps before serving")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--oracle-every", type=int, default=8,
                    help="check every Nth request against the float64 oracle (0: none)")
    sv.add_argument("--slo", default=None, metavar="SPEC",
                    help="SLO spec 'p99_ms=250,err_rate=0.01' (default SDDMM_TORCH_SLO); "
                    "violations exit 2")
    sv.add_argument("--plan-mode", default="model", choices=["model", "auto", "measure"])
    sv.add_argument("--tenants", default=None, metavar="SPEC",
                    help="tenant classes 'name[:weight[:slo]];...': weighted-fair dequeue, "
                    "per-tenant shed counters and burn-rate axes (default "
                    "SDDMM_TORCH_TENANTS)")
    sv.add_argument("--faults", default=None, metavar="SPEC",
                    help="fault plan (see er); the engine must shed or degrade, never "
                    "crash")
    sv.add_argument("--trace", nargs="?", const="1", default=None, metavar="PATH")
    sv.add_argument("--profile", default=None, metavar="LOGDIR")
    sv.add_argument("--watchdog", default=None, choices=["warn", "strict"])
    sv.add_argument("--flightrec", nargs="?", const="1", default=None, metavar="DIR")
    sv.add_argument(
        "--telemetry", nargs="?", const="1", default=None, metavar="DIR",
        help="sample live telemetry (queue depth, latency histogram, shed/degrade, cell "
        "counters, SLO burn rate) to artifacts/telemetry_torch/<run_id>.jsonl every "
        "--telemetry-interval seconds; DIR relocates (SDDMM_TORCH_TELEMETRY); watch it "
        "with `bench top`")
    sv.add_argument("--telemetry-interval", type=float, default=0.5, metavar="SECONDS")
    sv.add_argument(
        "--admin-port", type=int, default=None, metavar="PORT",
        help="serve the admin surface on 127.0.0.1:PORT (0: ephemeral): /metrics, "
        "/healthz, /readyz, /debug/requests, /snapshot (obs/httpexp.py); the record "
        "gains admin_port")
    sv.add_argument(
        "--serve-http", action="store_true",
        help="replica mode: no load generator; accept POST /submit until SIGTERM or "
        "SIGINT, then drain and print the whole record as the last stdout line "
        "(implies --admin-port 0 when unset)")
    sv.add_argument(
        "--tuner", action="store_true",
        help="run the closed-loop tuner against the live engine (tuner/): mine the "
        "walk_idle_frac gauge, re-measure off the request path, shadow-validate and "
        "hot-swap a kernel variant; the record gains tuner and time_to_adapt_s "
        "(SDDMM_TORCH_TUNER; SDDMM_TORCH_TUNER_* pace it)")
    sv.add_argument("--no-runstore", action="store_true")
    _add_device(sv)
    sv.add_argument("-o", "--output-file", default=None, help="append the JSON record here")


def _add_top_tune(sub) -> None:
    """``top`` and ``tune``: the JAX subcommands' flags (``tune`` adds
    ``--device``)."""
    tp = sub.add_parser(
        "top",
        help="live serving telemetry: queue depth, latency percentiles, shed/degrade, cell "
        "counters, SLO burn rate, the tuner's state, over a `bench serve --telemetry` "
        "stream or a `bench serve --admin-port` endpoint")
    tp.add_argument("path", nargs="?", default=None,
                    help="a telemetry .jsonl stream (default: the newest under "
                    "artifacts/telemetry_torch/ or SDDMM_TORCH_TELEMETRY); a missing "
                    "explicit path exits 2")
    tp.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="refresh every N seconds until interrupted (0: once)")
    tp.add_argument("--admin-port", type=int, default=None, metavar="PORT",
                    help="read the live /snapshot of a `bench serve --admin-port` engine; "
                    "falls back to the stream when it does not answer")
    tp.add_argument("--admin-host", default="127.0.0.1", metavar="HOST")
    tp.add_argument("--serve", type=int, default=None, metavar="PORT", dest="serve_port",
                    help="exporter: serve /metrics, /snapshot, /healthz, /readyz rendered "
                    "from the stream on 127.0.0.1:PORT (0: ephemeral) until interrupted")

    tn = sub.add_parser(
        "tune",
        help="offline re-tune of one R-mat problem: mine the run store's history for its "
        "fingerprint, re-rank and re-measure the whole candidate space (algorithm and c "
        "included) and store the winner in the plan cache (tuner/retune.py)")
    tn.add_argument("log_m", type=int, help="log2 of matrix side")
    tn.add_argument("edge_factor", type=int, help="average nnz per row")
    tn.add_argument("R", type=int)
    tn.add_argument("--trial", default="auto", choices=["auto", "counted", "wall"],
                    help="wall: fused pairs timed by CUDA events; counted: the model "
                    "charged the counted walk idle share; auto: wall on cuda, else counted")
    tn.add_argument("--trials", type=int, default=1)
    tn.add_argument("--timeout", type=float, default=60.0, help="seconds a trial")
    tn.add_argument("--budget", type=float, default=120.0, help="seconds the re-tune")
    tn.add_argument("--top-k", type=int, default=3)
    tn.add_argument("--dry-run", action="store_true",
                    help="report the challenger and leave the plan cache as it is")
    tn.add_argument("--json", action="store_true")
    tn.add_argument("--store", default=None, metavar="DIR",
                    help="the run store mined (default artifacts/runstore_torch, or "
                    "SDDMM_TORCH_RUNSTORE)")
    _add_device(tn)


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

    _add_serve(sub)
    _add_top_tune(sub)

    bl = sub.add_parser("baseline", help="external host-CPU SpMM baseline (no card)")
    bl.add_argument("log_m", type=int)
    bl.add_argument("edge_factor", type=int)
    bl.add_argument("R", type=int)
    bl.add_argument("--iters", type=int, default=10)
    bl.add_argument("-o", "--output-file", default=None)

    rt = sub.add_parser(
        "report-trace",
        help="aggregate a JSONL trace into a per-phase table and the comm "
        "volume against the cost model (tools/tracereport.py); exits 2 on "
        "schema violations unless --no-strict",
    )
    rt.add_argument("trace", help="path to a <run_id>.jsonl trace")
    rt.add_argument("--json", action="store_true")
    rt.add_argument("--no-strict", action="store_true")

    tm = sub.add_parser(
        "trace-merge",
        help="merge per-process trace shards into one schema-valid trace, "
        "aligned on each shard's clock origin (the earliest is the merged "
        "zero); exits 2 on unmergeable or invalid shards",
    )
    tm.add_argument("shards", nargs="+",
                    help="shard files, shard directories, or a PATH.jsonl "
                    "(merged with its sibling PATH.shards/ directory)")
    tm.add_argument("-o", "--output-file", default=None,
                    help="default <first shard dir>/<merged id>.jsonl")
    tm.add_argument("--no-strict", action="store_true",
                    help="tolerate (and drop) malformed shard lines")

    te = sub.add_parser(
        "trace-export",
        help="convert a schema-valid trace (merged ones included) to Chrome "
        "trace-event JSON for Perfetto / chrome://tracing: a process lane a "
        "shard, a thread lane a thread, spans as B/E pairs, request flows; "
        "exits 2 on an invalid trace",
    )
    te.add_argument("trace", help="path to a <run_id>.jsonl trace")
    te.add_argument("-o", "--output-file", default=None,
                    help="default <trace stem>.chrome.json")
    te.add_argument("--no-strict", action="store_true",
                    help="tolerate (and drop) malformed trace lines")

    def _store_arg(p):
        p.add_argument("--store", default=None, metavar="DIR",
                       help="run-store root (default artifacts/runstore_torch, "
                       "or SDDMM_TORCH_RUNSTORE)")

    hi = sub.add_parser("history", help="list the persistent run store")
    _store_arg(hi)
    hi.add_argument("--key", default=None, help="filter to one fingerprint key")
    hi.add_argument("--backend", default=None)
    hi.add_argument("--limit", type=int, default=None, metavar="N", help="newest N runs")
    hi.add_argument("--json", action="store_true")

    cp = sub.add_parser("compare", help="per-phase delta table between two stored "
                        "runs (run ids, unique prefixes, or latest / latest~N)")
    _store_arg(cp)
    cp.add_argument("run_a")
    cp.add_argument("run_b")
    cp.add_argument("--threshold", type=float, default=0.15,
                    help="relative noise band (default 0.15)")
    cp.add_argument("--json", action="store_true")

    ga = sub.add_parser(
        "gate",
        help="regression gate: compare a run against a rolling baseline of the "
        "last K matching runs; exit 0 pass, 2 regression, 3 insufficient "
        "baseline data",
    )
    _store_arg(ga)
    ga.add_argument("run", help="run id / prefix / latest[~N] to judge")
    ga.add_argument("--against", default=None, metavar="RUN",
                    help="explicit baseline run instead of the rolling baseline")
    ga.add_argument("--last", type=int, default=5, metavar="K",
                    help="rolling-baseline population (default 5)")
    ga.add_argument("--min-runs", type=int, default=1,
                    help="fewer matching baseline runs than this exits 3")
    ga.add_argument("--threshold", type=float, default=0.15)
    ga.add_argument("--json", action="store_true")

    bf = sub.add_parser(
        "backfill",
        help="ingest the committed headline records (BENCH_r0*.json, "
        "MULTICHIP_r0*.json, artifacts/bench_midround) into the run store; "
        "they keep their own backend and no key, so they never enter a live "
        "run's baseline",
    )
    _store_arg(bf)
    bf.add_argument("--root", default=None, metavar="DIR",
                    help="repo root to scan (default: this checkout)")

    rh = sub.add_parser("report-html", help="self-contained HTML report: run "
                        "history, per-phase trends, latest compare")
    _store_arg(rh)
    rh.add_argument("-o", "--output-file", default=None,
                    help="default <store>/report.html")
    rh.add_argument("--limit", type=int, default=100)
    rh.add_argument("--key", default=None, help="focus fingerprint key for trends "
                    "and compare (default: the newest run's)")
    rh.add_argument("--threshold", type=float, default=0.15)
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
                # ``plan.instantiate`` builds the kernel and the strategy.
                run_alg, run_c, kernel, wire = plan.algorithm, plan.c, None, plan.wire
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
                        plan=plan,
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


@contextlib.contextmanager
def _observed(args):
    """The run store, faults and observability the flags ask for, on around
    the run and off after it, in the JAX CLI's order: the watchdog, the run
    store, the fault plan, the tracer, then the flight recorder (its ring taps the file
    tracer), then the profiler. With the flight recorder armed,
    ``--profile`` means a window an anomaly: one profiler session at a
    time, so a whole-run capture would refuse every window."""
    from distributed_sddmm_tpu_torch.obs import flightrec as obs_flightrec
    from distributed_sddmm_tpu_torch.obs import profiler as obs_profiler
    from distributed_sddmm_tpu_torch.obs import store as obs_store
    from distributed_sddmm_tpu_torch.obs import trace as obs_trace
    from distributed_sddmm_tpu_torch.obs import watchdog as obs_watchdog
    from distributed_sddmm_tpu_torch.resilience import faults

    profile = args.profile or os.environ.get(obs_profiler.PROFILE_ENV)
    with contextlib.ExitStack() as stack:
        if args.watchdog:
            obs_watchdog.enable(args.watchdog)
            stack.callback(obs_watchdog.disable)
            print(f"[watchdog] {args.watchdog} mode", file=sys.stderr)
        if args.no_runstore:
            # The flag beats the environment: ``active()`` would otherwise
            # turn the store on from a non-empty SDDMM_TORCH_RUNSTORE.
            stack.enter_context(obs_store.scoped(False))
        else:
            # On by default; SDDMM_TORCH_RUNSTORE relocates (a path) or
            # vetoes (0/off) it, in ``store.active()``'s grammar.
            enabled, root = obs_store.parse_env_spec(os.environ.get(obs_store.RUNSTORE_ENV))
            stack.enter_context(obs_store.scoped(enabled, root))
        if args.faults:
            faults.install(faults.FaultPlan.from_spec(args.faults))
            stack.callback(faults.clear)
            print("[faults] plan installed from --faults", file=sys.stderr)
        if args.trace:
            tr = obs_trace.enable(None if args.trace == "1" else args.trace)
            stack.callback(obs_trace.disable)
            print(f"[trace] writing {tr.path}", file=sys.stderr)
        if args.flightrec:
            fr = obs_flightrec.enable(None if args.flightrec == "1" else args.flightrec,
                                      profile_window_s=0.25 if profile else 0.0)
            stack.callback(obs_flightrec.disable)
            print(f"[flightrec] armed -> {fr.out_dir}", file=sys.stderr)
        if profile and args.flightrec:
            print("[profile] flight recorder armed: capturing short per-anomaly "
                  "windows instead of the whole run", file=sys.stderr)
        elif profile:
            stack.enter_context(obs_profiler.capture(profile))
        yield


def _dispatch_serve(args) -> int:
    """``serve``: build a warm engine, drive it open-loop (or, with
    ``--serve-http``, over ``POST /submit`` until a signal), print and
    persist the serving record. Exit 0 on a clean run, 1 on any reply that
    fails its float64 oracle, 2 on an SLO violation; faults and shedding
    are operating conditions, not failures. A replica exits 0 after its
    drain: its record carries any violation."""
    from distributed_sddmm_tpu_torch.obs import flightrec as obs_flightrec
    from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics
    from distributed_sddmm_tpu_torch.obs import store as obs_store
    from distributed_sddmm_tpu_torch.obs import telemetry as obs_telemetry
    from distributed_sddmm_tpu_torch.obs import trace as obs_trace
    from distributed_sddmm_tpu_torch.obs import watchdog as obs_watchdog
    from distributed_sddmm_tpu_torch.resilience import faults
    from distributed_sddmm_tpu_torch.serve import (
        SLOSpec, build_als_engine, build_attention_engine, build_gat_engine, parse_tenants,
        run_load, tenants_from_env,
    )
    from distributed_sddmm_tpu_torch.tuner.loop import TUNER_ENV

    device = resolve_device(args.device)
    slo = SLOSpec.parse(args.slo) if args.slo else SLOSpec.from_env()
    tenants = parse_tenants(args.tenants) if args.tenants else tenants_from_env()
    serve_http = bool(args.serve_http)
    if serve_http and args.admin_port is None:
        args.admin_port = 0  # a replica needs its ingestion surface
    engine_kw = dict(max_batch=args.max_batch, max_depth=args.max_depth,
                     max_wait_ms=args.max_wait_ms, tenants=tenants)
    with _world(device) as world:
        S = _maybe_mask(HostCOO.rmat(args.log_m, args.edge_factor, seed=0, device=device),
                        args)
        print(f"[serve] building warm {args.app} engine (2^{args.log_m} matrix, R={args.R})",
              file=sys.stderr)
        counters_before = {k: obs_metrics.GLOBAL.get(k) for k in harness.PROGRAM_STORE_COUNTERS}
        build = {"als": build_als_engine, "gat": build_gat_engine,
                 "attention": build_attention_engine}[args.app]
        extra = ({"train_steps": args.train_steps, "k": args.k} if args.app == "als" else
                 {"window": args.window, "seed": args.seed} if args.app == "attention" else {})
        eng = build(S, R=args.R, plan_mode=args.plan_mode, world=world, device=device,
                    **extra, **engine_kw)
        d_ops = eng.workload.model.d_ops
        plan = getattr(eng.workload.model, "plan", None)
        # The record carries the faults and anomalies of the serving window,
        # not the build's.
        fault_plan = faults.active()
        events_before = len(fault_plan.events) if fault_plan is not None else 0
        watchdog = obs_watchdog.active()
        anomalies_before = len(watchdog.events) if watchdog is not None else 0
        d_ops.reset_performance_timers()

        sampler = None
        tel_enabled, tel_root = obs_telemetry.parse_env_spec(
            args.telemetry or os.environ.get(obs_telemetry.TELEMETRY_ENV))
        if tel_enabled:
            sampler = obs_telemetry.TelemetrySampler(eng, interval_s=args.telemetry_interval,
                                                     out_dir=tel_root, slo=slo)
        # Up before warm-up, so that /readyz reports the warm-up as not ready.
        admin = None
        if args.admin_port is not None:
            from distributed_sddmm_tpu_torch.obs import httpexp

            admin = httpexp.AdminServer(
                engine=eng, op_metrics=d_ops.metrics, slo=slo, port=args.admin_port,
                submit_fn=_http_submit(eng) if serve_http else None,
                chaos_fn=httpexp.arm_faults if serve_http else None)
            admin.start()
            print(f"[admin] serving http://127.0.0.1:{admin.port} (/metrics /healthz /readyz "
                  "/debug/requests /snapshot" + (" POST:/submit" if serve_http else "") + ")",
                  file=sys.stderr, flush=True)
        # An anomaly's flight record carries the engine's state of its moment.
        fr = obs_flightrec.active()
        if fr is not None:
            fr.register_source("engine", lambda: obs_telemetry.engine_snapshot(eng, slo=slo))
        tuner = None
        try:
            eng.start()  # builds and runs the whole bucket ladder first
            if args.tuner or os.environ.get(TUNER_ENV, "").lower() in ("1", "on", "true",
                                                                        "yes"):
                from distributed_sddmm_tpu_torch.tuner import BackgroundTuner

                tuner = BackgroundTuner(eng).start()
                print(f"[tuner] background tuner armed (interval {tuner.config.interval_s}s)",
                      file=sys.stderr)
            if sampler is not None:
                sampler.start()
                print(f"[telemetry] sampling to {sampler.path}", file=sys.stderr)
            if serve_http:
                summary = _serve_until_signal(eng, slo, tenants)
            else:
                summary = run_load(eng, duration_s=args.duration, rate_hz=args.rate,
                                   seed=args.seed, oracle_every=args.oracle_every, slo=slo,
                                   tenants=tenants)
        finally:
            if tuner is not None:
                tuner.stop()
            if sampler is not None:
                sampler.stop()
            eng.stop()
            if admin is not None:
                admin.stop()
        record = {
            "app": f"serve-{args.app}",
            "algorithm": plan.algorithm if plan else d_ops.algorithm_name,
            "mask": args.mask if args.app == "attention" else None,
            "R": args.R,
            "c": plan.c if plan else d_ops.c,
            "fused": True,
            "kernel": getattr(d_ops.kernel, "name", type(d_ops.kernel).__name__),
            # What serves: a tuner promotion restamps the workload's variant.
            "kernel_variant": eng.workload.kernel_variant,
            "wire": d_ops.wire.label,
            "device": device_label(device),
            "num_processes": world.num_processes,
            "process_index": world.process_index,
            "num_trials": summary["completed"],
            "elapsed": summary["duration_s"],
            "overall_throughput": None,
            "alg_info": d_ops.json_algorithm_info(),
            "metrics": d_ops.metrics.to_dict(),
            "engine": eng.stats(),
            "program_store": {k: obs_metrics.GLOBAL.get(k) - counters_before[k]
                              for k in harness.PROGRAM_STORE_COUNTERS},
            "serve_config": {
                "rate_hz": args.rate, "duration_s": args.duration,
                "max_batch": args.max_batch, "max_depth": args.max_depth,
                "max_wait_ms": args.max_wait_ms,
                "batch_buckets": list(eng.batch_buckets),
                "inner_buckets": list(eng.workload.inner_buckets),
                "tenants": args.tenants or os.environ.get("SDDMM_TORCH_TENANTS"),
                "serve_http": serve_http,
            },
            **summary,
        }
        if plan is not None:
            record["plan"] = plan.to_dict()
        if tuner is not None:
            record["tuner"] = tuner.summary()
            record["time_to_adapt_s"] = tuner.time_to_adapt_s
        if sampler is not None:
            record["telemetry_path"] = str(sampler.path)
        if admin is not None:
            record["admin_port"] = admin.port
            record["admin_scrapes"] = admin.scrapes
        if fr is not None:
            record["flightrec_dir"] = str(fr.out_dir)
        if obs_trace.enabled():
            from distributed_sddmm_tpu_torch.obs import manifest as obs_manifest

            record["run_id"] = obs_trace.run_id()
            record["trace_path"] = obs_trace.trace_path()
            obs_manifest.write_for_trace(obs_trace.tracer(), device=device, world=world)
        if fault_plan is not None:
            record["faults_fired"] = [{"site": s, "kind": k, "call": n}
                                      for s, k, n in fault_plan.events[events_before:]]
        if watchdog is not None:
            record["anomalies"] = watchdog.summary(since=anomalies_before)
    if serve_http:
        # The replica's contract: the whole record is the last stdout line.
        print(json.dumps(record, default=str), flush=True)
    else:
        print(json.dumps({k: record.get(k) for k in (
            "app", "algorithm", "requests", "completed", "throughput_rps", "latency_ms",
            "batch_occupancy", "shed_count", "degraded_count", "errors", "oracle_checked",
            "oracle_failures", "slo_violations", "burn_rate", "latency_hist_ms", "tenant")}),
            flush=True)
    if args.output_file:
        with open(args.output_file, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")
    run_store = obs_store.active()
    if run_store is not None:
        try:  # best-effort: never fail the run
            doc = run_store.ingest_record(record, source="serve")
            print(f"[serve] runstore doc {doc['run_id']}", file=sys.stderr)
        except Exception as e:  # noqa: BLE001
            print(f"[serve] runstore ingest failed: {e}", file=sys.stderr)
    if serve_http:
        return 0
    if summary["oracle_failures"]:
        return 1
    if summary["slo_violations"]:
        return 2
    return 0


def _http_submit(eng):
    """The replica's ``POST /submit``: the payload through the engine's own
    ``submit`` (the workload's ``clamp`` turns the JSON lists back into its
    arrays, so the reply is the in-process one's bits), the reply counted
    in the recorder as the load generator counts an in-process one.

    ``serial`` asks for the workload's host float32 rung, which only an
    engine on the CPU has: a replica on the card refuses it (400) rather
    than answer from the host."""

    def submit(payload, tenant="default", serial=False, timeout_s=30.0):
        if serial:
            if eng.device.type != "cpu":
                raise ValueError(f"serial: an engine on {eng.device.type} has no host rung")
            return eng.workload.serial(eng.workload.clamp(payload))
        req = eng.submit(payload, tenant=tenant)
        try:
            reply = req.result(timeout_s=timeout_s)
        except Exception:
            eng.recorder.record_error(tenant)
            raise
        eng.recorder.record_reply(req)
        return reply

    return submit


def _serve_until_signal(eng, slo, tenants) -> dict:
    """Replica mode: park until SIGTERM or SIGINT, then drain and
    summarize from the recorder (requests came over ``POST /submit``)."""
    import signal
    import threading

    from distributed_sddmm_tpu_torch.obs import clock
    from distributed_sddmm_tpu_torch.serve.slo import attach_tenant_slo

    done = threading.Event()

    def on_signal(signum, frame):  # noqa: ARG001 -- the signal API
        done.set()

    # Handlers run on the main thread whichever thread the signal lands on;
    # the wait polls so that it never blocks one out.
    old_term = signal.signal(signal.SIGTERM, on_signal)
    old_int = signal.signal(signal.SIGINT, on_signal)
    print("[serve] replica mode: accepting POST /submit until SIGTERM", file=sys.stderr,
          flush=True)
    t0 = clock.now()
    try:
        while not done.wait(0.2):
            pass
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
    eng.stop(drain=True)  # admission closes; the queued requests finish
    elapsed = clock.now() - t0
    summary = eng.recorder.summary()
    summary.update({
        "duration_s": round(elapsed, 3),
        "offered": eng.queue.submitted_count + summary["shed_count"],
        "submitted": eng.queue.submitted_count,
        "throughput_rps": round(summary["completed"] / elapsed, 3) if elapsed > 0 else 0.0,
        "oracle_checked": 0,
        "oracle_failures": 0,
    })
    summary["slo"] = slo.to_dict()
    summary["slo_violations"] = slo.check(summary)
    summary["burn_rate"] = slo.burn_rate(summary)
    attach_tenant_slo(summary, tenants)
    return summary


def _top_source(args):
    """``bench top``'s source: ``(read_fn, label)``, ``read_fn()`` giving
    the snapshots to draw. An explicit stream that does not exist exits 2;
    no stream at all exits 1 (a line on stderr, no traceback)."""
    from distributed_sddmm_tpu_torch.obs import telemetry

    if args.admin_port is not None:
        from distributed_sddmm_tpu_torch.obs import httpexp

        def read_live():
            snap = httpexp.fetch_json(args.admin_host, args.admin_port, "/snapshot")
            return [snap] if snap else []

        try:
            read_live()  # probe once; no answer: the stream instead
            return read_live, f"admin {args.admin_host}:{args.admin_port}"
        except (OSError, ValueError) as e:
            print(f"[top] admin endpoint {args.admin_host}:{args.admin_port} unreachable "
                  f"({e}); falling back to the telemetry stream", file=sys.stderr)
    path = args.path
    if path is not None:
        if not os.path.exists(path):
            print(f"bench top: no telemetry file at {path}", file=sys.stderr)
            raise SystemExit(2)
    else:
        _, root = telemetry.parse_env_spec(os.environ.get(telemetry.TELEMETRY_ENV))
        path = telemetry.newest_stream(root)
        if path is None:
            print("no telemetry streams found (run `bench serve --telemetry` first)",
                  file=sys.stderr)
            raise SystemExit(1)
    return (lambda: telemetry.read_snapshots(path)), str(path)


def _dispatch_top(args) -> int:
    """``top``: draw the newest snapshot of a stream or a live endpoint;
    ``--watch`` redraws until interrupted; ``--serve`` exports the stream
    as ``/metrics``."""
    import time

    from distributed_sddmm_tpu_torch.obs import telemetry

    try:
        read_fn, label = _top_source(args)
    except SystemExit as e:
        return int(e.code or 0)
    if args.serve_port is not None:
        from distributed_sddmm_tpu_torch.obs import httpexp

        def latest():
            snaps = read_fn()
            return snaps[-1] if snaps else None

        server = httpexp.AdminServer(snapshot_fn=latest, port=args.serve_port).start()
        print(f"[top] exporting {label} on http://127.0.0.1:{server.port}/metrics",
              file=sys.stderr, flush=True)
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            return 0
        finally:
            server.stop()
    while True:
        try:
            snaps = read_fn()
        except (OSError, ValueError) as e:
            # A live source can vanish mid-watch: one line, never a traceback.
            print(f"bench top: snapshot source unavailable ({e})", file=sys.stderr)
            if not args.watch:
                return 1
            snaps = []
        if args.watch:
            print("\x1b[2J\x1b[H", end="")  # clear the screen between frames
        print(telemetry.render_top(snaps), flush=True)
        if not args.watch:
            return 0
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


def _dispatch_tune(args) -> int:
    """``tune``: one offline re-tune of the R-mat problem. The incumbent is
    the plan a warm-up would take (a cache hit, else the model's); the run
    store's history for its fingerprint is mined; the whole candidate
    space is re-ranked and measured; a challenger that wins is stored in
    the plan cache. With ``--dry-run`` the cache stays byte for byte as it
    was. Exit 0 whether or not the incumbent stands."""
    import tempfile

    from distributed_sddmm_tpu_torch.autotune.cache import PlanCache
    from distributed_sddmm_tpu_torch.autotune.fingerprint import (
        machine_signature, make_fingerprint,
    )
    from distributed_sddmm_tpu_torch.autotune.plan import Plan
    from distributed_sddmm_tpu_torch.tuner import TunerConfig
    import distributed_sddmm_tpu_torch.tuner.retune as tuner_retune
    import distributed_sddmm_tpu_torch.tuner.signals as tuner_signals

    device = resolve_device(args.device)
    with _world(device) as world:
        S = HostCOO.rmat(args.log_m, args.edge_factor, seed=0, device=device)
        problem = Problem.from_coo(S, args.R)
        if args.dry_run:
            # get_plan stores its selection on a miss: answer from a real
            # hit, else select against a throwaway cache.
            p, backend, kernels = machine_signature(world, device)
            hit = PlanCache().load(make_fingerprint(problem, p, backend, kernels).key)
            if hit is not None:
                incumbent = Plan.from_dict(hit)
            else:
                with tempfile.TemporaryDirectory() as td:
                    incumbent = get_plan(problem, world, device=device, mode="model",
                                         cache=PlanCache(td))
        else:
            incumbent = get_plan(problem, world, device=device, mode="model")
        signals = tuner_signals.mine_runstore(_run_store(args), incumbent.fingerprint_key,
                                              problem, incumbent.predicted_ms)
        measured: list = []
        challenger = tuner_retune.retune(
            problem, incumbent, S, top_k=args.top_k, trials=args.trials,
            timeout_s=args.timeout, max_elapsed_s=args.budget,
            trial_fn=TunerConfig(trial=args.trial).trial_fn(device, world),
            world=world, device=device, measured_out=measured)
    promoted = challenger is not None and not args.dry_run
    if promoted:
        PlanCache().store(challenger.fingerprint_key, challenger.to_dict())
    report = {"fingerprint_key": incumbent.fingerprint_key,
              "signals": [s.to_dict() for s in signals], "incumbent": incumbent.to_dict(),
              "challenger": challenger.to_dict() if challenger else None,
              "trials": [{"algorithm": c.algorithm, "c": c.c, "kernel": c.kernel,
                          "variant": c.variant, "wire": c.wire,
                          "gflops": rec.get("overall_throughput"),
                          "pairs_ms": rec.get("pairs_ms")} for c, rec in measured],
              "promoted": promoted, "dry_run": bool(args.dry_run)}
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        inc, ch = incumbent, challenger
        print(f"incumbent  {inc.algorithm} c={inc.c} kernel={inc.kernel}"
              + (f" variant={inc.variant}" if inc.variant else "") + f" [{inc.source}]")
        if ch is None:
            print("challenger none: the incumbent stands")
        else:
            print(f"challenger {ch.algorithm} c={ch.c} kernel={ch.kernel}"
                  + (f" variant={ch.variant}" if ch.variant else "")
                  + f" measured={ch.measured_gflops:.3f} GFLOP/s"
                  + (" -> plan cache" if promoted else " (dry run)"))
    return 0


def _run_store(args):
    from distributed_sddmm_tpu_torch.obs import store as obs_store

    if args.store:
        return obs_store.RunStore(args.store)
    return obs_store.active() or obs_store.RunStore()


def _resolve_run(store, spec: str):
    try:
        doc = store.resolve(spec)
    except ValueError as e:  # an ambiguous prefix: say so, with candidates
        raise SystemExit(str(e))
    if doc is None:
        raise SystemExit(f"no stored run matches {spec!r} (try 'history'; specs are "
                         "run ids, unique prefixes, or latest / latest~N)")
    return doc


def _dispatch_store(args) -> int:
    """The run-store subcommands (no benchmark, no device)."""
    from distributed_sddmm_tpu_torch.obs import regress

    store = _run_store(args)
    if args.cmd == "history":
        rows = store.history(key=args.key, backend=args.backend, limit=args.limit)
        print(json.dumps(rows, indent=1) if args.json else regress.render_history(rows))
        return 0
    if args.cmd == "compare":
        a = _resolve_run(store, args.run_a)
        b = _resolve_run(store, args.run_b)
        report = regress.compare(b, doc_a=a, threshold=args.threshold)
        print(json.dumps(report, indent=1) if args.json else regress.render_compare(report))
        return 0
    if args.cmd == "gate":
        doc = _resolve_run(store, args.run)
        baseline = _resolve_run(store, args.against) if args.against else None
        code, report = regress.gate(store, doc, k=args.last, threshold=args.threshold,
                                    min_runs=args.min_runs, baseline_doc=baseline)
        if args.json:
            print(json.dumps(report, indent=1))
        else:
            if report.get("phases"):
                print(regress.render_compare(report))
            print(f"gate: {report['verdict']} (exit {code})")
        return code
    if args.cmd == "backfill":
        from distributed_sddmm_tpu_torch.obs.store import backfill_historical

        docs = backfill_historical(store, root=args.root)
        print(f"backfilled {len(docs)} historical record(s) into {store.root}")
        for d in docs:
            print(f"  {d['run_id']:<32} <- {d.get('source')}")
        return 0
    if args.cmd == "report-html":
        from distributed_sddmm_tpu_torch.obs import report as obs_report

        path = obs_report.build_html(store, out_path=args.output_file, limit=args.limit,
                                     key=args.key, threshold=args.threshold)
        print(f"wrote {path}")
        return 0
    raise AssertionError(args.cmd)


def _dispatch_trace_merge(args) -> int:
    """``trace-merge``: discover the shards, merge them aligned, write one
    trace and read it back strictly. Exit 0 valid, 2 unmergeable."""
    from distributed_sddmm_tpu_torch.obs import tracemerge
    from distributed_sddmm_tpu_torch.tools import tracereport

    paths: list = []
    try:
        for spec in args.shards:
            for p in tracemerge.discover(spec):
                if p not in paths:
                    paths.append(p)
        out, merged = tracemerge.write_merged(paths, args.output_file,
                                              strict=not args.no_strict)
        # The merged file meets the reader contract of any one-process trace.
        tracereport.load_trace(out, strict=True)
    except (FileNotFoundError, ValueError) as e:
        print(f"trace-merge failed: {e}", file=sys.stderr)
        return 2
    print(json.dumps({
        "merged": str(out),
        "run_id": merged["begin"]["run_id"],
        "shards": len(merged["begin"]["shards"]),
        "spans": len(merged["spans"]),
        "events": len(merged["events"]),
        "skipped_lines": len(merged["errors"]),
    }))
    return 0


def _dispatch_trace_export(args) -> int:
    """``trace-export``: a schema-valid trace to Chrome trace-event JSON.
    Exit 0 written, 2 invalid or unreadable."""
    from distributed_sddmm_tpu_torch.obs import traceexport

    try:
        out, chrome = traceexport.write_chrome(args.trace, args.output_file,
                                               strict=not args.no_strict)
    except (OSError, ValueError) as e:
        print(f"trace-export failed: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"exported": str(out), **chrome["metadata"]}))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "report-trace":
        from distributed_sddmm_tpu_torch.tools import tracereport

        return tracereport.main([args.trace] + (["--json"] if args.json else [])
                                + (["--no-strict"] if args.no_strict else []))
    if args.cmd == "trace-merge":
        return _dispatch_trace_merge(args)
    if args.cmd == "trace-export":
        return _dispatch_trace_export(args)
    if args.cmd in ("history", "compare", "gate", "backfill", "report-html"):
        return _dispatch_store(args)
    if args.cmd in ("er", "file", "heatmap"):
        with _observed(args):
            return _benchmark(args)
    if args.cmd == "serve":
        with _observed(args):
            return _dispatch_serve(args)
    if args.cmd == "top":
        return _dispatch_top(args)
    if args.cmd == "tune":
        return _dispatch_tune(args)
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
