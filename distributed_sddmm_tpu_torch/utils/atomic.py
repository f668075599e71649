"""Atomic file writes for the checkpoint store, the run store and the trace
tools (counterpart of ``utils/atomic.py``).

One implementation of the temp-file + ``os.replace`` dance: a reader sees
the old content or the new content, never a prefix. The write-fault hook
runs here: an active fault plan can garble or truncate the payload at
site ``write:<file name>`` (``resilience/faults.py::garble_text``), which
lands a corrupt final file, the state a process killed mid-write leaves;
readers treat it as a miss.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile


def _replace_atomically(path: pathlib.Path, data: bytes) -> None:
    """Temp file in the destination directory, ``os.replace``, and the temp
    file unlinked on any failure (nothing left behind by a full disk or a
    kill)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str | os.PathLike, text: str) -> None:
    """Write ``text`` to ``path`` atomically (parents created)."""
    # Imported per call: resilience/ builds on this module.
    from distributed_sddmm_tpu_torch.resilience import faults

    path = pathlib.Path(path)
    _replace_atomically(path, faults.garble_text(f"write:{path.name}", text).encode())


def atomic_write_json(path: str | os.PathLike, obj, **json_kw) -> None:
    json_kw.setdefault("indent", 1)
    json_kw.setdefault("sort_keys", True)
    atomic_write_text(path, json.dumps(obj, **json_kw))


def atomic_write_lines(path: str | os.PathLike, lines) -> None:
    """Streaming variant for large line-oriented files (merged traces): each
    line goes to the temp file as it is produced, so the payload is never
    one string in memory, and ``os.replace`` keeps the all-or-nothing
    contract. Under an active fault plan the lines are joined first, so the
    ``write:`` hook can garble or cut the payload as in the other writers."""
    from distributed_sddmm_tpu_torch.resilience import faults

    path = pathlib.Path(path)
    if faults.active() is not None:
        text = "".join(line + "\n" for line in lines)
        _replace_atomically(path, faults.garble_text(f"write:{path.name}", text).encode())
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            for line in lines:
                f.write(line + "\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path: str | os.PathLike, data: bytes) -> None:
    """Bytes variant (checkpoint ``.npz`` payloads, program-store entries;
    any bytes-like ``data``): the write-fault hook works on a latin-1 round
    trip, so it garbles or cuts bytewise."""
    from distributed_sddmm_tpu_torch.resilience import faults

    path = pathlib.Path(path)
    if faults.active() is not None:
        data = faults.garble_text(f"write:{path.name}",
                                  bytes(data).decode("latin-1")).encode("latin-1")
    _replace_atomically(path, data)
