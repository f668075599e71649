"""Per-run manifest: the environment a trace was taken in (counterpart of
``obs/manifest.py``).

Written atomically beside the trace as ``<run_id>.manifest.json``: the
Python, torch and CUDA versions, the device (on a card its name, compute
capability and count, and the name and power limit ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` reports; on the CPU
every device field says ``cpu``), the ``backend`` the run store keys on
(:func:`backend_name`), the pod identity (``dist/init.py``), the git
revision, the port's ``SDDMM_TORCH_*`` knobs and the caller's extras.
Collection never starts CUDA: device facts are read once CUDA is up (or
the caller names the device), and :func:`write_for_trace` refreshes the
file then. Where
``nvidia-smi`` cannot be run the power limit is null beside the reason;
nothing is made up. Git provenance never raises: ``git_rev`` is
``"unknown"`` and ``git_dirty`` None where no revision resolves.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import torch

from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_json

SCHEMA_VERSION = 1

_REPO = pathlib.Path(__file__).resolve().parents[2]

#: Environment prefixes worth recording: the port's knobs and torchrun's
#: world.
_ENV_PREFIXES = ("SDDMM_TORCH_",)
_ENV_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "CUDA_VISIBLE_DEVICES")

_git_info_cache: dict = {}
_smi_cache: dict = {}


def _git_info(cwd=None) -> dict:
    """``{"git_rev", "git_dirty"}``, memoised a directory; never raises."""
    cwd = pathlib.Path(cwd) if cwd is not None else _REPO
    key = str(cwd)
    if key not in _git_info_cache:
        rev, dirty = "unknown", None
        try:
            out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd,
                                 capture_output=True, text=True, timeout=5)
            if out.returncode == 0 and out.stdout.strip():
                rev = out.stdout.strip()
                st = subprocess.run(["git", "status", "--porcelain"], cwd=cwd,
                                    capture_output=True, text=True, timeout=5)
                if st.returncode == 0:
                    dirty = bool(st.stdout.strip())
        except (OSError, subprocess.SubprocessError):
            pass
        _git_info_cache[key] = {"git_rev": rev, "git_dirty": dirty}
    return _git_info_cache[key]


def nvidia_smi(index: int = 0) -> dict:
    """``{"smi_name", "power_limit"}`` of card ``index`` from ``nvidia-smi``
    (memoised); ``power_limit`` None and ``power_limit_error`` the reason
    where the query cannot be run or read."""
    if index not in _smi_cache:
        info: dict = {"smi_name": None, "power_limit": None}
        try:
            out = subprocess.run(
                ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
            line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
            if out.returncode != 0 or "," not in line:
                info["power_limit_error"] = (f"nvidia-smi exited {out.returncode}: "
                                             f"{(out.stderr or line).strip()[:200]}")
            else:
                name, limit = (s.strip() for s in line.rsplit(",", 1))
                info.update(smi_name=name, power_limit=limit)
        except (OSError, subprocess.SubprocessError) as e:
            info["power_limit_error"] = f"{type(e).__name__}: {e}"
        _smi_cache[index] = info
    return dict(_smi_cache[index])


def _device_info(device=None) -> dict:
    """Torch and CUDA versions, and the device facts of ``device`` (None:
    the current card once CUDA is up, else nothing about a device)."""
    info: dict = {"torch_version": torch.__version__, "cuda_version": torch.version.cuda}
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_initialized() else None)
    if dev is None:
        return info
    if dev.type != "cuda":
        info.update(device="cpu", device_name="cpu", device_capability="cpu",
                    device_count="cpu", smi_name="cpu", power_limit="cpu")
        return info
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    info.update(device="cuda", device_name=torch.cuda.get_device_name(index),
                device_capability=f"sm_{major}{minor}",
                device_count=torch.cuda.device_count(), **nvidia_smi(index))
    return info


def backend_name(device=None, world=None) -> str:
    """The device kind and world kind a run ran on, e.g. ``cuda:NVIDIA H100
    80GB HBM3:local`` (logical ranks on one card), ``...:nccl`` or
    ``cpu:gloo``: the ``backend`` of the autotuner's machine signature and of
    the run store's key. ``device`` None is the current card once CUDA is
    up, else the CPU (CUDA is never started here); ``world`` None is read
    from the process: ``local`` unless a process group is up."""
    import torch.distributed as dist

    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_initialized() else torch.device("cpu"))
    dev = torch.device(device)
    name = f"cuda:{torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else "cpu"
    if world is None:
        kind = str(dist.get_backend()) if dist.is_available() and dist.is_initialized() \
            else "local"
    else:
        from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld

        kind = "local" if isinstance(world, LocalWorld) else str(dist.get_backend())
    return f"{name}:{kind}"


def _dist_info() -> dict:
    """Pod identity (``num_processes``, ``process_index``, ``coordinator``
    when there is one) through ``dist.init.pod_info``, which opens no
    group: a pod's manifests never pool with a single process's."""
    from distributed_sddmm_tpu_torch.dist.init import pod_info

    try:
        return pod_info().record_fields()
    except ValueError:  # mislabelled pod: the manifest is best-effort
        return {}


def build(run_id: str, extra: dict | None = None, device=None, world=None) -> dict:
    m = {
        "schema": SCHEMA_VERSION,
        "run_id": run_id,
        "created_epoch": clock.epoch(),
        "python": sys.version.split()[0],
        "platform": sys.platform,
        "argv": sys.argv,
        **_git_info(),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(_ENV_PREFIXES) or k in _ENV_KEYS},
        **_device_info(device),
    }
    if "device" in m:
        m["backend"] = backend_name(device, world)
    m.update(_dist_info())
    if extra:
        m["extra"] = extra
    return m


def manifest_path_for(trace_path) -> pathlib.Path:
    p = pathlib.Path(trace_path)
    return p.with_name(p.stem + ".manifest.json")


def write_for_trace(tracer, extra: dict | None = None, device=None,
                    world=None) -> pathlib.Path | None:
    """Write (or refresh) the manifest beside ``tracer``'s file; ``world``
    names the world kind of its ``backend``. Once a manifest holds card
    facts, refreshes without extras are skipped; a memory-only tracer has
    nowhere to write (None)."""
    if tracer is None or tracer.path is None:
        return None
    path = manifest_path_for(tracer.path)
    if extra is None and tracer._manifest_final:
        return path
    m = build(tracer.run_id, extra, device, world)
    atomic_write_json(path, m)
    if m.get("device") == "cuda":
        tracer._manifest_final = True
    return path
