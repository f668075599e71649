"""Versioned, atomically written JSON plan cache and warm-start seeding
(counterpart of ``autotune/cache.py``).

One file per fingerprint key under ``artifacts/plan_cache_torch/``
(``SDDMM_TORCH_PLAN_CACHE`` overrides): writes go through
``utils/atomic.py`` (a temporary file and ``os.replace``), so a reader
never sees half a plan, and tuners of different problems never contend.
Every file carries ``schema_version``; another version, a corrupt or
truncated file, or a file whose key is not its name reads as a miss and
is overwritten by the next store. The cache only saves time; it never
raises for what a file holds.

Warm start reads only the port's own records, from paths given as
arguments: ``bench kernels`` records (which kernel family wins a grid
point on this device) and harness records (which algorithm and c win a
problem shape at this p). Without such a file nothing is seeded.
"""

from __future__ import annotations

import json
import math
import os
import pathlib

from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_json

_REPO = pathlib.Path(__file__).resolve().parents[2]

#: Plan-record schema generation. Bump on an incompatible change to the
#: stored plan dict; older entries then read as misses.
SCHEMA_VERSION = 1

#: Environment variable: the cache directory.
PLAN_CACHE_ENV = "SDDMM_TORCH_PLAN_CACHE"

DEFAULT_CACHE_DIR = _REPO / "artifacts" / "plan_cache_torch"


def default_cache_dir() -> pathlib.Path:
    """``SDDMM_TORCH_PLAN_CACHE``, else the repo's artifact directory; read
    a call, so a caller can redirect it."""
    env = os.environ.get(PLAN_CACHE_ENV)
    return pathlib.Path(env) if env else DEFAULT_CACHE_DIR


class PlanCache:
    """File-per-key JSON plan store that reads damage as a miss."""

    def __init__(self, root: str | os.PathLike | None = None):
        self.root = pathlib.Path(root) if root is not None else default_cache_dir()

    def _path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    def load(self, key: str) -> dict | None:
        """The stored plan dict, or None on a miss, a corrupt file or
        another schema version."""
        try:
            raw = self._path(key).read_text()
        except OSError:
            return None
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError:
            return None
        if not isinstance(rec, dict) or rec.get("schema_version") != SCHEMA_VERSION:
            return None
        if rec.get("fingerprint_key") not in (None, key):
            return None  # a renamed or copied file: not this problem's plan
        return rec

    def store(self, key: str, plan_dict: dict) -> None:
        """Atomic write: a concurrent reader sees the old entry or the
        new one."""
        rec = dict(plan_dict)
        rec["schema_version"] = SCHEMA_VERSION
        rec["fingerprint_key"] = key
        atomic_write_json(self._path(key), rec)

    def invalidate(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass


def _read_jsonl(path) -> list[dict]:
    if path is None:
        return []
    try:
        lines = pathlib.Path(path).read_text().splitlines()
    except OSError:
        return []
    out = []
    for line in lines:
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def _log2_bucket(x: float) -> int:
    return max(int(round(math.log2(max(x, 1)))), 0)


def seed_kernel_family(problem: Problem, backend: str, kernels: tuple,
                       path=None) -> str | None:
    """The family among ``kernels`` with the best fused-pair rate at this
    problem's grid point (log2 M, nnz/row and R buckets) in a ``bench
    kernels`` records file measured on this backend's device. None without
    a path or a match."""
    device = backend.split(":")[1] if backend.startswith("cuda:") else "cpu"
    want = (_log2_bucket(problem.M), _log2_bucket(problem.nnz_per_row),
            _log2_bucket(problem.R))
    best: tuple[float, str] | None = None
    for rec in _read_jsonl(path):
        M, nnz = rec.get("M") or 0, rec.get("nnz") or 0
        if rec.get("device") != device or rec.get("kernel") not in kernels or M < 1:
            continue
        if (_log2_bucket(M), _log2_bucket(nnz / M), _log2_bucket(rec.get("R") or 0)) != want:
            continue
        g = rec.get("fused_pair_gflops")
        if g and (best is None or g > best[0]):
            best = (g, rec["kernel"])
    return best[1] if best else None


def seed_winner_plan(problem: Problem, p: int, path=None) -> dict | None:
    """The winning ``(algorithm, c)`` among harness records (vanilla,
    fused) of this exact M, N and p whose nnz/row and R fall in this
    problem's power-of-two buckets: a partial plan dict, or None."""
    best: tuple[float, dict] | None = None
    for rec in _read_jsonl(path):
        info = rec.get("alg_info") or {}
        if rec.get("app", "vanilla") != "vanilla" or not rec.get("fused", False):
            continue
        if (info.get("m"), info.get("n"), info.get("p")) != (problem.M, problem.N, p):
            continue
        nnz = info.get("nnz") or 0
        if _log2_bucket(nnz / max(problem.M, 1)) != _log2_bucket(problem.nnz_per_row):
            continue
        if _log2_bucket(rec.get("R", 0)) != _log2_bucket(problem.R):
            continue
        g = rec.get("overall_throughput", 0.0)
        if g and (best is None or g > best[0]):
            best = (g, {"algorithm": rec.get("algorithm"), "c": rec.get("c"),
                        "source": "seed",
                        "seed_evidence": {"file": str(path), "overall_throughput": g}})
    return best[1] if best else None
