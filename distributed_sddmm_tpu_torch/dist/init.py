"""``torch.distributed`` initialisation and pod identity (counterpart of
``dist/init.py``).

Three layers of identity resolution, strongest first:

1. **A live process group** of more than one rank: its world size and
   rank are authoritative.
2. **Pod launcher labels**: ``SDDMM_TORCH_DIST_COORDINATOR`` /
   ``SDDMM_TORCH_DIST_NPROCS`` / ``SDDMM_TORCH_DIST_PROC_ID``, the knobs a
   pod launcher exports to every worker. They feed :func:`initialize` and
   tell offline tooling (store keys, manifests, a worker that runs without
   a group) which pod slot this process is.
3. **One process**: no group of more than one rank, no labels: ``(1, 0)``.

Nothing here opens a process group implicitly: :func:`pod_info` reads an
initialised default group, and only :func:`initialize`, an explicit call,
calls ``init_process_group``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

COORDINATOR_ENV = "SDDMM_TORCH_DIST_COORDINATOR"
NPROCS_ENV = "SDDMM_TORCH_DIST_NPROCS"
PROC_ID_ENV = "SDDMM_TORCH_DIST_PROC_ID"


@dataclasses.dataclass(frozen=True)
class PodContext:
    """Resolved pod identity of this process."""

    num_processes: int
    process_index: int
    coordinator: Optional[str] = None

    @property
    def is_multi_host(self) -> bool:
        return self.num_processes > 1

    def as_dict(self) -> dict:
        return {
            "num_processes": self.num_processes,
            "process_index": self.process_index,
            "coordinator": self.coordinator,
        }

    def record_fields(self) -> dict:
        """The pod identity records and manifests carry:
        ``num_processes`` and ``process_index`` always, ``coordinator`` only
        when there is one (a single-process record keeps its fields)."""
        return {k: v for k, v in self.as_dict().items() if v is not None}


def resolve_init_kwargs(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
) -> dict:
    """``init_process_group``'s kwargs for one worker.

    Explicit arguments win over the ``SDDMM_TORCH_DIST_*`` labels. No
    coordinator anywhere resolves to ``{}`` (the caller's own rendezvous,
    e.g. ``torchrun``'s ``env://``); ``num_processes`` or ``process_id``
    without a coordinator raises. Otherwise ``init_method`` is
    ``tcp://<coordinator>``, with ``world_size`` and ``rank`` (None where
    nothing gives them: a TCP rendezvous then refuses to start) and
    ``timeout`` a ``timedelta`` when a timeout is given.
    """
    if coordinator is None:
        coordinator = os.environ.get(COORDINATOR_ENV) or None
    if num_processes is None:
        env = os.environ.get(NPROCS_ENV)
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get(PROC_ID_ENV)
        process_id = int(env) if env else None
    if coordinator is None and (num_processes is not None or process_id is not None):
        raise ValueError(
            "num_processes/process_id require a coordinator address; set "
            f"--coordinator or {COORDINATOR_ENV}"
        )
    if coordinator is None:
        return {}
    kwargs = dict(
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )
    if initialization_timeout is not None:
        import datetime

        kwargs["timeout"] = datetime.timedelta(seconds=int(initialization_timeout))
    return kwargs


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
    device=None,
) -> PodContext:
    """Join this process to the pod (idempotent) and return its identity.

    Resolves the kwargs through :func:`resolve_init_kwargs` and opens the
    default group: NCCL on ``cuda`` (the default device), with this process
    on card ``LOCAL_RANK`` (0 when unset), gloo on ``cpu``. With no
    coordinator anywhere the environment's rendezvous is used
    (``env://``). A group that is already up is left as it is. The
    resolved identity is exported to the environment, so every later
    :func:`pod_info` of this process and of its children agrees with it.
    """
    import torch
    import torch.distributed as dist

    from distributed_sddmm_tpu_torch.device import resolve_device
    from distributed_sddmm_tpu_torch.parallel.comm import backend_for

    kwargs = resolve_init_kwargs(coordinator, num_processes, process_id,
                                 initialization_timeout)
    if not dist.is_initialized():
        dev = resolve_device(device)
        backend = backend_for(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        given = {k: v for k, v in kwargs.items() if v is not None}
        dist.init_process_group(backend, **(given or {"init_method": "env://"}))
    coord = kwargs["init_method"].removeprefix("tcp://") if kwargs else None
    ctx = PodContext(dist.get_world_size(), dist.get_rank(), coord)
    if ctx.coordinator:
        os.environ[COORDINATOR_ENV] = ctx.coordinator
    if ctx.num_processes > 1:
        os.environ[NPROCS_ENV] = str(ctx.num_processes)
        os.environ[PROC_ID_ENV] = str(ctx.process_index)
    return ctx


def _live_process_info() -> Optional[tuple[int, int]]:
    """``(world size, rank)`` of an initialised default group, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return None


def pod_info() -> PodContext:
    """This process's pod identity; never opens a group.

    A live group of more than one rank wins; otherwise the
    ``SDDMM_TORCH_DIST_NPROCS`` / ``_PROC_ID`` labels apply (a label of
    more than one process without a slot, or a slot outside the pod,
    raises: every worker would claim one slot's keys and records);
    otherwise ``(1, 0)``. The coordinator is the label's.
    """
    coordinator = os.environ.get(COORDINATOR_ENV) or None
    live = _live_process_info()
    if live is not None and live[0] > 1:
        return PodContext(live[0], live[1], coordinator)
    nprocs = os.environ.get(NPROCS_ENV)
    if nprocs:
        proc_id = os.environ.get(PROC_ID_ENV) or None
        if int(nprocs) > 1 and proc_id is None:
            raise ValueError(
                f"{NPROCS_ENV} is set without {PROC_ID_ENV}; a pod launcher must "
                "export the per-worker slot or every worker would claim process 0"
            )
        n, k = int(nprocs), int(proc_id or 0)
        if not (0 <= k < n):
            raise ValueError(f"{PROC_ID_ENV}={k} out of range [0, {n}) ({NPROCS_ENV}={n})")
        return PodContext(n, k, coordinator)
    return PodContext(1, 0, coordinator)


def cross_process_probe() -> tuple[bool, Optional[str]]:
    """Does a collective over every process of the default group give the
    host's answer? An ``all_reduce`` sum of ``arange(4) + rank`` (on this
    process's card under NCCL) checked against its sum computed here.
    ``(True, None)`` when it does, trivially in one process without a
    group; ``(False, "<error>")`` otherwise."""
    import torch
    import torch.distributed as dist

    live = _live_process_info()
    if live is None:
        return True, None
    try:
        n, rank = live
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        x = torch.arange(4, dtype=torch.float32, device=dev) + rank
        dist.all_reduce(x)
        want = torch.arange(4, dtype=torch.float32) * n + n * (n - 1) / 2
        got = x.cpu()
        if not torch.equal(got, want):
            return False, f"all_reduce gave {got.tolist()}, the host sum {want.tolist()}"
        return True, None
    except Exception as e:  # noqa: BLE001 -- the probe reports, never raises
        return False, f"{type(e).__name__}: {e}"
