"""Serve the attention app from several source trees on one card, in turns,
and split each tree's execute time into the device's and the host's.

    python3 -m distributed_sddmm_tpu_torch.bench.serve_ab LABEL=TREE ... [-o FILE]
        [--duration S] [--rate HZ]

A TREE is a directory that holds a whole ``distributed_sddmm_tpu_torch/``:
this checkout (``new=.``), or an older commit's package unpacked under a
gitignored directory::

    mkdir -p .chip_archive/parent
    git archive <commit> distributed_sddmm_tpu_torch | tar -x -C .chip_archive/parent

Each run is ``python3 -m distributed_sddmm_tpu_torch.bench serve --app
attention --log-m 16 --mask window:16 --R 128`` (``SERVE_ARGV``: Poisson
arrivals at ``--rate`` for ``--duration`` seconds, micro-batches of up to
8, every 16th reply against the float64 oracle) in the tree's directory,
so that it imports the tree's package. The trees run unprofiled in turns,
A B B A: each run's execute p50. Then each runs once more with
``--profile``, a ``torch.profiler`` trace (CPU and CUDA) of the whole
run: the card's busy time (``obs.profiler.device_time``: every kernel,
copy and set, the build's and the warm-up's too) over the load's batches,
an upper bound of the device's ms a batch, and the ``window_score``
kernel's ms a launch. A line a run, after a first line that names the
card and its power limit; with ``-o`` the lines are also appended to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

from distributed_sddmm_tpu_torch.obs.profiler import device_time

SERVE_ARGV = ["serve", "--app", "attention", "--log-m", "16", "--mask", "window:16",
              "--R", "128", "--max-batch", "8", "--oracle-every", "16", "--no-runstore"]
#: Keys of the serving record each line carries.
RECORD_KEYS = ("requests", "completed", "errors", "shed_count", "degraded_count",
               "latency_ms", "queue_ms", "execute_ms", "batch_occupancy", "throughput_rps",
               "oracle_checked", "oracle_failures")


def serve_once(root: pathlib.Path, duration: str, rate: str, profile: bool) -> dict:
    """One ``bench serve`` run of the tree at ``root``: its record's
    RECORD_KEYS and, with ``profile``, the device's share."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        env = dict(os.environ, SDDMM_TORCH_PLAN_CACHE=str(tmp / "plans"),
                   SDDMM_TORCH_PROGRAMS="0", SDDMM_TORCH_RUNSTORE="0")
        record = tmp / "record.jsonl"
        argv = [*SERVE_ARGV, "--duration", duration, "--rate", rate, "-o", str(record)]
        if profile:
            argv += ["--profile", str(tmp / "trace")]
        proc = subprocess.run([sys.executable, "-m", "distributed_sddmm_tpu_torch.bench",
                               *argv], cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0 or not record.is_file():
            return {"rc": proc.returncode, "stderr": proc.stderr[-4000:]}
        rec = json.loads(record.read_text().splitlines()[-1])
        row = {"rc": 0, "profiled": profile, **{k: rec.get(k) for k in RECORD_KEYS},
               "error_batches": rec["engine"].get("error_batches")}
        if profile:
            trace = next((tmp / "trace").glob("*.json"))
            busy_ms, events = device_time(str(trace))
            kernel_ms, launches = device_time(str(trace), "window_score")
            batches = (rec.get("batch_occupancy") or {}).get("batches") or 1
            row.update(device_ms=busy_ms, device_events=events, window_launches=launches,
                       window_ms_per_launch=kernel_ms / max(launches, 1),
                       device_ms_per_batch_at_most=busy_ms / batches)
        return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="LABEL=DIR, e.g. parent=.chip_archive/parent new=.")
    ap.add_argument("-o", "--output", help="append the JSON lines to this file")
    ap.add_argument("--duration", default="10", help="seconds of load a run")
    ap.add_argument("--rate", default="100", help="offered requests a second")
    args = ap.parse_args(argv)
    out_file = open(args.output, "a") if args.output else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out_file:
            out_file.write(line + "\n")
            out_file.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    emit({"nvidia_smi": smi})
    trees = dict(spec.partition("=")[::2] for spec in args.trees)
    runs = [(label, False) for label in [*trees, *reversed(trees)]]
    runs += [(label, True) for label in trees]
    failed = 0
    for label, profile in runs:
        row = serve_once(pathlib.Path(trees[label]).resolve(), args.duration, args.rate,
                         profile)
        failed += row["rc"] != 0
        emit({"tree": label, **row})
    if out_file:
        out_file.close()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
