"""Atomic file writes for the checkpoint store (counterpart of
``utils/atomic.py``).

One implementation of the temp-file + ``os.replace`` dance: a reader sees
the old content or the new content, never a prefix. The JAX package
threads a write-fault hook through here; the fault plans are not ported
(ROADMAP.md, queue A item 14), so the payload is written as given.
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
    _replace_atomically(pathlib.Path(path), text.encode())


def atomic_write_json(path: str | os.PathLike, obj, **json_kw) -> None:
    json_kw.setdefault("indent", 1)
    json_kw.setdefault("sort_keys", True)
    atomic_write_text(path, json.dumps(obj, **json_kw))


def atomic_write_bytes(path: str | os.PathLike, data: bytes) -> None:
    """Bytes variant (checkpoint ``.npz`` payloads)."""
    _replace_atomically(pathlib.Path(path), data)
