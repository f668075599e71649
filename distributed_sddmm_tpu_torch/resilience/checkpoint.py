"""Atomic, versioned, corruption-tolerant step checkpoints (counterpart of
``resilience/checkpoint.py``, with the same on-disk format: each package
reads the other's store).

Layout under the store root (default ``artifacts/checkpoints/<name>/``)::

    step_00000002.npz   # the arrays (atomic: temp + os.replace)
    step_00000003.npz
    latest.json         # {"schema_version", "step", "file", "digest", "meta"}

``latest.json`` is a pointer, not the source of truth: resume first tries
the step it names (checking the recorded SHA-256 digest, so a torn npz
write cannot come back as garbage factors), then scans ``step_*.npz``
newest first and takes the first file numpy can load. A crash mid-write
costs at most the interrupted step.

Arrays round-trip bit for bit (``np.savez`` keeps float bits), so a
killed-and-resumed run re-executes the remaining steps from identical
state.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import pathlib
import re
import zipfile

import numpy as np

from distributed_sddmm_tpu_torch.obs import metrics, trace
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_bytes, atomic_write_json

_REPO = pathlib.Path(__file__).resolve().parents[2]
_log = logging.getLogger("checkpoint")

#: Bump on any incompatible change to the stored layout; entries of
#: another version then read as misses.
SCHEMA_VERSION = 1

DEFAULT_ROOT = _REPO / "artifacts" / "checkpoints"

#: Environment variable: the base directory of :func:`default_checkpoint_dir`.
CHECKPOINT_DIR_ENV = "SDDMM_TORCH_CHECKPOINT_DIR"

_STEP_RE = re.compile(r"^step_(\d{8})\.npz$")


def default_checkpoint_dir(name: str = "default") -> pathlib.Path:
    """``$SDDMM_TORCH_CHECKPOINT_DIR/<name>``, else under the repo's
    ``artifacts/checkpoints``."""
    env = os.environ.get(CHECKPOINT_DIR_ENV)
    return (pathlib.Path(env) if env else DEFAULT_ROOT) / name


class CheckpointStore:
    """File-per-step npz store with atomic writes and scan-back recovery."""

    def __init__(self, root: str | os.PathLike, keep_last: int = 3):
        self.root = pathlib.Path(root)
        self.keep_last = keep_last

    def _step_path(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step:08d}.npz"

    # ------------------------------ write path ----------------------------- #

    def save(self, step: int, arrays: dict, meta: dict | None = None) -> None:
        """Atomically persist ``arrays`` (name -> ndarray) as ``step``."""
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        payload = buf.getvalue()
        path = self._step_path(step)
        atomic_write_bytes(path, payload)
        metrics.GLOBAL.add("checkpoints_saved")
        trace.event("checkpoint_save", step=int(step), file=path.name, bytes=len(payload))
        _log.debug("saved step %d to %s (%d bytes)", step, path.name, len(payload))
        # The digest of what was meant to be written: a write fault that
        # garbled the file on disk fails it at resume.
        atomic_write_json(self.root / "latest.json", {
            "schema_version": SCHEMA_VERSION,
            "step": int(step),
            "file": path.name,
            "digest": hashlib.sha256(payload).hexdigest(),
            "meta": meta or {},
        })
        self._prune()

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep_last, 0)]:
            try:
                os.unlink(self._step_path(s))
            except OSError:
                pass

    # ------------------------------ read path ------------------------------ #
    # Every failure reads as "try the next older step".

    def steps(self) -> list[int]:
        """Available step numbers, oldest first."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match, names) if m)

    def _read_npz(self, path: pathlib.Path) -> dict | None:
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None

    def load(self, step: int) -> dict | None:
        """The arrays of ``step``, or None if missing or corrupt."""
        return self._read_npz(self._step_path(step))

    def _latest_pointer(self) -> dict | None:
        try:
            rec = json.loads((self.root / "latest.json").read_text())
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(rec, dict) or rec.get("schema_version") != SCHEMA_VERSION:
            return None
        return rec

    def load_latest(self) -> tuple[int, dict, dict] | None:
        """``(step, arrays, meta)`` of the newest loadable checkpoint: the
        ``latest.json`` pointer with a matching digest, then any
        ``step_*.npz`` that loads, newest first (meta ``{}``). None when
        nothing survives."""
        rec = self._latest_pointer()
        if rec is not None:
            path = self.root / str(rec.get("file", ""))
            try:
                payload = path.read_bytes()
            except OSError:
                payload = None
            if payload is not None and hashlib.sha256(payload).hexdigest() == rec.get("digest"):
                arrays = self._read_npz(path)
                if arrays is not None:
                    metrics.GLOBAL.add("checkpoints_loaded")
                    trace.event("checkpoint_load", step=int(rec["step"]), file=path.name,
                                source="pointer")
                    _log.debug("loaded step %s from the pointer", rec["step"])
                    return int(rec["step"]), arrays, rec.get("meta", {})
        for step in reversed(self.steps()):
            arrays = self._read_npz(self._step_path(step))
            if arrays is not None:
                metrics.GLOBAL.add("checkpoints_loaded")
                trace.event("checkpoint_load", step=step, file=self._step_path(step).name,
                            source="scan_back")
                _log.debug("loaded step %d by scan-back", step)
                return step, arrays, {}
        return None
