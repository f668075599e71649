"""Elastic pod membership on the resilience layer (counterpart of
``dist/elastic.py``).

A lost worker becomes checkpoint scan-back recovery at a smaller ``p``,
not a dead run. :class:`ElasticSupervisor` launches one OS process a pod
slot, watches for deaths (a ``kill`` fault exits with
``resilience.faults.KILL_EXIT_CODE``; a crash exits nonzero or on a
signal) and on a loss relaunches the survivors' work as a new
*generation* with fewer processes. The recovery workers resume from the
shared :class:`~distributed_sddmm_tpu_torch.resilience.checkpoint.
CheckpointStore` by its scan-back ladder: the supervisor passes them no
state, only identity (the generation, the new ``p``, which fixed data
shards each owns).

The data partition is fixed at the first pod size (``nshards``): worker
``w`` of a ``live_p``-worker generation owns shards
``{s : s % live_p == w}``. A 2-worker run that loses worker 1 recovers as
one worker owning both shards, shard 1 from the last step its dead owner
checkpointed and shard 0 from its own checkpoints; the final state equals
an uninterrupted run's bit for bit, since the store keeps the bits and each
shard's steps are deterministic.

A fault plan fires by ``(seed, spec, site, call)`` in each process, so a
relaunched worker would meet the very kill that felled its predecessor:
recovery generations drop ``SDDMM_TORCH_FAULTS``
(``drop_faults_on_recovery``): the faulty host left the pod.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

from distributed_sddmm_tpu_torch.obs import log as obs_log
from distributed_sddmm_tpu_torch.obs import trace as obs_trace
from distributed_sddmm_tpu_torch.resilience.faults import FAULTS_ENV, KILL_EXIT_CODE


def free_port() -> int:
    """A TCP port on ``127.0.0.1`` that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_process(argv: list, env: Optional[dict] = None,
                  cwd: Optional[str] = None) -> subprocess.Popen:
    """Start one supervised child, its stdout and stderr in temporary
    files: a supervisor reads them only after the exit, and a chatty child
    would fill a pipe, block in ``write`` and read as hung. Pair with
    :func:`collect_output`."""
    out_f = tempfile.TemporaryFile(mode="w+")
    err_f = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(argv, stdout=out_f, stderr=err_f, text=True, env=env,
                            cwd=cwd)
    proc._elastic_out, proc._elastic_err = out_f, err_f
    return proc


def collect_output(proc: subprocess.Popen) -> tuple[str, str]:
    """A :func:`spawn_process` child's stdout and stderr (the files are
    closed). Call once, after the exit."""
    texts = []
    for fh in (proc._elastic_out, proc._elastic_err):
        try:
            fh.seek(0)
            texts.append(fh.read())
        finally:
            fh.close()
    return texts[0], texts[1]


def last_json_line(text: str) -> Optional[dict]:
    """A child's result: the last line of its stdout that parses as a JSON
    object (None when none does)."""
    for line in reversed((text or "").strip().splitlines()):
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict):
            return doc
    return None


@dataclasses.dataclass
class GenerationResult:
    """One generation's outcome. ``lost``: workers that died on their own
    (a fault's kill, a crash); ``reaped``: survivors the supervisor killed
    after the grace window (blocked on a peer that will never come, or a
    generation timeout). Only ``lost`` shrinks the next generation: a
    reaped worker's host is healthy."""

    generation: int
    live_p: int
    returncodes: list
    records: list  # the last JSON line of each worker (None when none parses)
    lost: list
    reaped: list = dataclasses.field(default_factory=list)
    stderr: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (not self.lost and not self.reaped
                and all(rc == 0 for rc in self.returncodes))


@dataclasses.dataclass
class ElasticResult:
    generations: list
    #: True only when a lost worker drove a smaller recovery generation (a
    #: retry after a stall at the same p is no recovery).
    recovered: bool

    @property
    def ok(self) -> bool:
        return bool(self.generations) and self.generations[-1].ok

    @property
    def records(self) -> list:
        return self.generations[-1].records if self.generations else []


class ElasticSupervisor:
    """Launch, watch and elastically relaunch a pod's worker processes.

    ``worker_argv(generation, live_p, worker, port)`` is one worker's
    command line after the interpreter (``port`` a free TCP port shared by
    the generation, for its rendezvous); ``worker_env(generation, live_p,
    worker)`` overlays that worker's environment (how a drill aims a
    ``kill`` fault at one worker). ``on_loss(result)`` runs after a failed
    generation, before the next one starts.
    """

    def __init__(
        self,
        worker_argv: Callable[[int, int, int, int], list],
        nprocs: int,
        *,
        worker_env: Optional[Callable[[int, int, int], dict]] = None,
        max_recoveries: int = 1,
        generation_timeout_s: float = 300.0,
        grace_s: float = 10.0,
        drop_faults_on_recovery: bool = True,
        on_loss: Optional[Callable[[GenerationResult], None]] = None,
        cwd: Optional[str] = None,
    ):
        if nprocs < 1:
            raise ValueError("nprocs must be >= 1")
        self.worker_argv = worker_argv
        self.nprocs = nprocs
        self.worker_env = worker_env
        self.max_recoveries = max_recoveries
        self.generation_timeout_s = generation_timeout_s
        self.grace_s = grace_s
        self.drop_faults_on_recovery = drop_faults_on_recovery
        self.on_loss = on_loss
        self.cwd = cwd

    def _spawn(self, generation: int, live_p: int) -> list:
        port = free_port()
        procs = []
        for w in range(live_p):
            env = dict(os.environ)
            if generation > 0 and self.drop_faults_on_recovery:
                env.pop(FAULTS_ENV, None)
            if self.worker_env is not None:
                env.update(self.worker_env(generation, live_p, w))
            procs.append(spawn_process(
                [sys.executable, *self.worker_argv(generation, live_p, w, port)],
                env=env, cwd=self.cwd))
        return procs

    def _watch(self, procs: list, generation: int, live_p: int) -> GenerationResult:
        """Wait for the generation. Once a worker exits nonzero the others
        get ``grace_s`` to finish their own work and are then killed, so a
        worker blocked on its dead peer does not hold recovery for the
        whole generation timeout."""
        deadline = time.monotonic() + self.generation_timeout_s
        death_seen_at = None
        reaped: set = set()
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                break
            now = time.monotonic()
            if death_seen_at is None and any(rc not in (None, 0) for rc in rcs):
                death_seen_at = now
            if now > deadline or (death_seen_at is not None
                                  and now > death_seen_at + self.grace_s):
                for w, p in enumerate(procs):
                    if p.poll() is None:
                        reaped.add(w)
                        p.kill()
            time.sleep(0.05)
        records, rcs, lost, errs = [], [], [], []
        for w, p in enumerate(procs):
            p.wait()
            out, err = collect_output(p)
            rcs.append(p.returncode)
            records.append(last_json_line(out))
            errs.append(err)
            if p.returncode != 0 and w not in reaped:
                lost.append(w)
                obs_log.warn("elastic", "worker lost", generation=generation, worker=w,
                             rc=p.returncode, killed=p.returncode == KILL_EXIT_CODE,
                             stderr_tail=(err or "")[-300:])
            elif w in reaped:
                obs_log.warn("elastic", "survivor reaped (blocked past grace)",
                             generation=generation, worker=w, rc=p.returncode)
        return GenerationResult(generation=generation, live_p=live_p, returncodes=rcs,
                                records=records, lost=lost, reaped=sorted(reaped),
                                stderr=errs)

    def run(self) -> ElasticResult:
        """Generation 0 at ``nprocs``; each loss starts the next at
        ``live_p - len(lost)`` (at least 1), until a generation completes
        or ``max_recoveries`` are spent."""
        generations = []
        live_p = self.nprocs
        for generation in range(self.max_recoveries + 1):
            obs_trace.event("elastic:generation", generation=generation, live_p=live_p)
            result = self._watch(self._spawn(generation, live_p), generation, live_p)
            generations.append(result)
            if result.ok:
                break
            if self.on_loss is not None:
                self.on_loss(result)
            if generation >= self.max_recoveries:
                break
            # Only workers that died on their own shrink p: a reaped
            # survivor's host rejoins (a timeout alone retries at the same p).
            live_p = max(live_p - len(result.lost), 1)
            obs_log.warn("elastic",
                         "recovering at reduced p" if result.lost
                         else "retrying at unchanged p after stall",
                         generation=generation + 1, live_p=live_p, lost=result.lost,
                         reaped=result.reaped)
        return ElasticResult(generations=generations,
                             recovered=any(g.lost for g in generations[:-1]))


def run_elastic(worker_argv, nprocs: int, **kw) -> ElasticResult:
    """:class:`ElasticSupervisor` in one call."""
    return ElasticSupervisor(worker_argv, nprocs, **kw).run()
