"""The pod runner: one process a pod slot, the bench CLI's semantics
unchanged (counterpart of ``dist/run.py``).

    python -m distributed_sddmm_tpu_torch.dist.run [--coordinator H:P]
        [--num-processes N] [--process-id K] [--dry-run] <bench args>

* The default group comes from ``dist/init.py`` (explicit flags, then the
  ``SDDMM_TORCH_DIST_*`` labels, then ``env://``): NCCL when the
  forwarded command runs on ``cuda`` (its ``--device``, the card by
  default), gloo on ``cpu``. Every worker runs ``cross_process_probe``
  (an ``all_reduce`` against its host sum) and stops if it fails. The
  bench CLI then runs on a ``DistWorld`` over the group
  (``parallel/comm.py::world_from_env``), and the runner closes the group
  after the run.
* A worker's own admin server: with ``SDDMM_TORCH_POD_ADMIN_BASE=P`` a
  forwarded ``serve`` without ``--admin-port`` gets ``--admin-port P+K``.
* A worker's own trace shard: a file-valued ``SDDMM_TORCH_TRACE`` becomes
  its ``.shards/`` directory before anything traces, and after the run
  worker 0 merges this run's shards into one timeline
  (``obs/tracemerge.py``), waiting at most 30 s for a missing one before
  it leaves them to ``bench trace-merge``.
  ``SDDMM_TORCH_POD_TRACE_MERGE=0`` leaves the merge out.

Run it once a slot, e.g. two processes on one host over gloo:

    python -m distributed_sddmm_tpu_torch.dist.run --coordinator 127.0.0.1:29511 \\
        --num-processes 2 --process-id K er 10 8 15d_fusion2 16 1 --device cpu
"""

from __future__ import annotations

import argparse
import os
import pathlib
import time
from typing import Optional

ADMIN_BASE_ENV = "SDDMM_TORCH_POD_ADMIN_BASE"
TRACE_MERGE_ENV = "SDDMM_TORCH_POD_TRACE_MERGE"
#: Seconds worker 0 waits for the other workers' trace shards.
MERGE_WAIT_S = 30.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_sddmm_tpu_torch.dist.run",
        description="Run one pod slot of the bench CLI over torch.distributed.")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the TCP rendezvous (SDDMM_TORCH_DIST_COORDINATOR; "
                    "none: env://)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dry-run", action="store_true",
                    help="print the resolved rendezvous and bench command, open no group")
    ap.add_argument("bench_args", nargs=argparse.REMAINDER,
                    help="arguments of python -m distributed_sddmm_tpu_torch.bench")
    return ap


def _trace_shard_candidate() -> Optional[pathlib.Path]:
    """The shard directory ``SDDMM_TORCH_TRACE`` implies (the environment
    unchanged): a ``.jsonl`` file's ``.shards/`` sibling, a directory
    itself, a flag or nothing none."""
    from distributed_sddmm_tpu_torch.obs.trace import FLAG_VALUES, TRACE_ENV, shard_dir_for

    spec = os.environ.get(TRACE_ENV)
    if not spec or spec in FLAG_VALUES:
        return None
    p = pathlib.Path(spec)
    return shard_dir_for(p) if p.suffix == ".jsonl" else p


def _shardify_trace_env() -> Optional[pathlib.Path]:
    """Point a file-valued ``SDDMM_TORCH_TRACE`` at its ``.shards/``
    directory (every worker makes the same change) and return the
    directory the merge reads; a directory spec shards as it is."""
    from distributed_sddmm_tpu_torch.obs.trace import TRACE_ENV

    shards = _trace_shard_candidate()
    if shards is not None and pathlib.Path(os.environ[TRACE_ENV]).suffix == ".jsonl":
        os.environ[TRACE_ENV] = str(shards)
    return shards


def _inject_admin_port(bench_args: list, process_index: int) -> list:
    base = os.environ.get(ADMIN_BASE_ENV)
    if (not base or int(base) <= 0 or bench_args[:1] != ["serve"]
            or any(a == "--admin-port" or a.startswith("--admin-port=") for a in bench_args)):
        return bench_args
    return [*bench_args, "--admin-port", str(int(base) + process_index)]


def _merge_shards(shard_dir: pathlib.Path, pre_existing: set, n: int) -> None:
    """Worker 0's merge of this run's ``n`` shards; a shard still missing
    after :data:`MERGE_WAIT_S` defers the merge (the shards stay for
    ``bench trace-merge``)."""
    from distributed_sddmm_tpu_torch.obs import log as obs_log
    from distributed_sddmm_tpu_torch.obs import trace as obs_trace
    from distributed_sddmm_tpu_torch.obs import tracemerge

    try:
        obs_trace.disable()  # flush this worker's own shard first

        def this_runs_shards():
            return [f for f in tracemerge.discover(shard_dir) if str(f) not in pre_existing]

        deadline = time.monotonic() + MERGE_WAIT_S
        shards = this_runs_shards()
        while len(shards) < n and time.monotonic() < deadline:
            time.sleep(0.25)
            shards = this_runs_shards()
        if len(shards) < n:
            raise RuntimeError(f"only {len(shards)} of {n} worker shards present; merge "
                               "deferred to `bench trace-merge`")
        out, merged = tracemerge.write_merged(shards)
        print(f"pod trace merged: {out} ({len(merged['begin']['shards'])} shards)",
              flush=True)
    except Exception as e:  # noqa: BLE001 -- a merge never fails the run
        obs_log.warn("dist", "pod trace merge skipped", error=f"{type(e).__name__}: {e}")


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    from distributed_sddmm_tpu_torch.bench.cli import build_parser as bench_parser
    from distributed_sddmm_tpu_torch.dist.init import (
        cross_process_probe, initialize, resolve_init_kwargs,
    )

    try:
        init_kwargs = resolve_init_kwargs(args.coordinator, args.num_processes,
                                          args.process_id)
    except ValueError as e:
        ap.error(str(e))
    bench = bench_parser().parse_args(args.bench_args)
    if args.dry_run:
        print(f"dry-run ok: init_process_group({init_kwargs}) -> bench {args.bench_args}")
        return 0

    import torch.distributed as dist

    # Shards already in the directory before the rendezvous are earlier
    # runs': no worker traces before every worker has joined.
    pre_dir = _trace_shard_candidate()
    pre_existing = ({str(f) for f in pre_dir.glob("*.jsonl")}
                    if pre_dir is not None and pre_dir.is_dir() else set())
    owns_group = not dist.is_initialized()
    ctx = initialize(args.coordinator, args.num_processes, args.process_id,
                     device=getattr(bench, "device", None))
    try:
        ok, err = cross_process_probe()
        if not ok:
            raise RuntimeError(f"cross-process probe failed: {err}")
        if ctx.process_index == 0:
            print(f"pod up: {ctx.num_processes} processes over {dist.get_backend()}, "
                  "probe ok", flush=True)
        shard_dir = _shardify_trace_env() if ctx.is_multi_host else None
        bench_args = _inject_admin_port(list(args.bench_args), ctx.process_index)

        from distributed_sddmm_tpu_torch.bench.cli import main as bench_main

        rc = bench_main(bench_args)
        if (shard_dir is not None and ctx.process_index == 0
                and os.environ.get(TRACE_MERGE_ENV, "1") not in ("0", "off")):
            _merge_shards(shard_dir, pre_existing, ctx.num_processes)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
