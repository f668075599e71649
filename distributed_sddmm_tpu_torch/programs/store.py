"""The persistent, fingerprint-keyed store of strategy set-ups
(counterpart of ``programs/store.py``).

The JAX package's store keeps compiled XLA executables, so a fresh
process makes no live compile. The port compiles no program (its nvcc
library is cached by a hash of its sources, ``ops/_build.py``): what a
process rebuilds is a strategy's host set-up, the tile sets its
constructor builds (CSR, band tables, host maps). This store keeps that
set-up, one entry a strategy and matrix, under the JAX store's contract:

* the key is ``programs/keys.py``'s ``plan_program_key`` over the plan's
  fingerprint, :func:`strategy_config_tag`, the set-up's segments
  (:func:`matrix_content_key`, the capacity request of a dynamic-structure
  build), the backend (``obs/manifest.py::backend_name``) and the
  process segment (``dist_segment``);
* every write goes through ``utils/atomic.py`` (temp file and
  ``os.replace``; the ``write:`` fault hook applies);
* ``index.json`` is derived state behind the run store's ``flock``
  (``obs/store.py::root_flock``): corrupt or missing, it is rebuilt from
  the entry files;
* a corrupt, truncated, schema-mismatched, foreign-key or wrong-backend
  entry, or one the strategy's build refuses, reads as a **miss, is
  evicted** and is rebuilt in-process: the store can cost a rebuild,
  never an error.

An entry is ``torch.save`` of ``{"schema", "key", "backend",
"created_epoch", "meta", "payload"}``, the payload the strategy's
``export_setup()`` (tensors and plain values), read back with
``torch.load(weights_only=True)``.

Counters in ``obs.metrics.GLOBAL``: ``program_store_hits``,
``program_store_misses`` and ``live_compiles`` (a set-up built in-process
through a bound store: what a warm start drives to 0). Trace events:
``program_store_hit`` (key, ``load_s``) and ``program_store_compile``
(key, ``compile_s``: the build's seconds).

``SDDMM_TORCH_PROGRAMS``: ``0``/``off`` disables, a path relocates, unset
selects ``artifacts/programs_torch/``. The store is on by default, as in
the JAX package; the port's test files veto it.

Left out by design: the XLA cost log (``xla_cost_summary``,
``cost_log_len``) and ``deserialize_and_load``, since the port has no
executable, and ``StoredProgram``/``stored``, its per-call wrapper.
:func:`chained_program` returns the function it is given: the port keeps
no chained program.
"""

from __future__ import annotations

import hashlib
import io
import os
import pathlib
import threading

import numpy as np

from distributed_sddmm_tpu_torch.programs import keys as keys_mod
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_bytes, atomic_write_json

#: Entry schema generation; readers evict entries they cannot read.
SCHEMA_VERSION = 1

PROGRAMS_ENV = "SDDMM_TORCH_PROGRAMS"
_REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_ROOT = _REPO / "artifacts" / "programs_torch"


def _global_counters():
    from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics

    return obs_metrics.GLOBAL


class ProgramStore:
    """One directory of set-up entries and a derived index::

        <root>/entries/<safe_stem(key)>.pt   an entry (torch.save)
        <root>/index.json                    summary rows (derived)
    """

    def __init__(self, root: str | os.PathLike | None = None):
        self.root = pathlib.Path(root) if root else DEFAULT_ROOT
        self.entries_dir = self.root / "entries"
        self.index_path = self.root / "index.json"
        self._lock = threading.Lock()
        # Per store; GLOBAL sums every store of the process.
        self.hits = 0
        self.misses = 0
        self.live_compiles = 0

    def path(self, key: str) -> pathlib.Path:
        """The entry file of ``key``."""
        return self.entries_dir / f"{keys_mod.safe_stem(key)}.pt"

    # --------------------------------------------------------------- index

    def _flock(self):
        from distributed_sddmm_tpu_torch.obs.store import root_flock

        return root_flock(self.root)

    def _read_index(self) -> list | None:
        import json

        try:
            rows = json.loads(self.index_path.read_text())
        except FileNotFoundError:
            return None if self.entries_dir.exists() and any(
                self.entries_dir.glob("*.pt")) else []
        except (OSError, ValueError):
            return None  # corrupt: rebuild
        if not isinstance(rows, list):
            return None
        return [r for r in rows if isinstance(r, dict) and r.get("key")]

    def _rebuild_index_locked(self) -> list:
        rows = []
        for f in sorted(self.entries_dir.glob("*.pt")):
            entry = self._read_entry_file(f)
            if entry is not None:
                rows.append(self._index_row(entry, f))
        rows.sort(key=lambda r: (r.get("created_epoch") or 0, r["key"]))
        atomic_write_json(self.index_path, rows)
        return rows

    def _index_row(self, entry: dict, path: pathlib.Path | None = None) -> dict:
        path = self.path(entry["key"]) if path is None else path
        try:
            nbytes = path.stat().st_size
        except OSError:
            nbytes = None
        return {"key": entry.get("key"), "backend": entry.get("backend"),
                "created_epoch": entry.get("created_epoch"),
                "meta": entry.get("meta") or {}, "bytes": nbytes}

    def _update_index(self, entry: dict | None, drop_key: str | None = None) -> None:
        with self._flock():
            rows = self._read_index()
            if rows is None:
                rows = self._rebuild_index_locked()
            if drop_key is not None:
                rows = [r for r in rows if r.get("key") != drop_key]
            if entry is not None:
                rows = [r for r in rows if r.get("key") != entry.get("key")]
                rows.append(self._index_row(entry))
            rows.sort(key=lambda r: (r.get("created_epoch") or 0, r["key"]))
            atomic_write_json(self.index_path, rows)

    def index(self) -> list[dict]:
        """The summary rows, rebuilt from the entries when the index is
        corrupt, or missing beside entries."""
        with self._lock:
            rows = self._read_index()
            if rows is None:
                with self._flock():
                    rows = self._rebuild_index_locked()
            return rows

    # ---------------------------------------------------------- entry I/O

    @staticmethod
    def _read_entry_file(path: pathlib.Path) -> dict | None:
        import torch

        try:
            entry = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:  # noqa: BLE001 -- absent, truncated or garbled
            return None
        if not isinstance(entry, dict) or entry.get("schema") != SCHEMA_VERSION:
            return None
        return entry

    def evict(self, key: str) -> None:
        """Drop one entry; never raises."""
        try:
            os.unlink(self.path(key))
        except OSError:
            pass
        try:
            self._update_index(None, drop_key=key)
        except OSError:
            pass

    def load(self, key: str, *, backend: str | None = None, restore=None):
        """The entry's payload for ``key`` (``restore(payload)`` when given),
        or None.

        A miss: no file, an unreadable or truncated file, another schema, an
        embedded key other than ``key`` (a renamed or copied entry), another
        backend than ``backend``, or a ``restore`` that raises. Every miss
        but the absent file also evicts the entry, so the next save heals
        the slot. Never raises for an entry's content."""
        from distributed_sddmm_tpu_torch.obs import clock
        from distributed_sddmm_tpu_torch.obs import log as obs_log
        from distributed_sddmm_tpu_torch.obs import trace as obs_trace

        t0 = clock.now()
        path = self.path(key)
        entry = self._read_entry_file(path)
        reason = None
        if entry is None:
            reason = "unreadable" if path.exists() else None
        elif entry.get("key") != key:
            reason = "foreign key"
        elif backend is not None and entry.get("backend") != backend:
            reason = "wrong backend"
        if entry is None or reason is not None:
            if reason is not None:
                obs_log.warn("programs", "bad entry; evicting", key=key, reason=reason)
                self.evict(key)
            self._miss()
            return None
        payload = entry["payload"]
        if restore is not None:
            try:
                payload = restore(payload)
            except Exception as e:  # noqa: BLE001 -- any failure: rebuild
                obs_log.warn("programs", "stored set-up refused; evicting", key=key,
                             error=f"{type(e).__name__}: {e}")
                self.evict(key)
                self._miss()
                return None
        with self._lock:
            self.hits += 1
        _global_counters().add("program_store_hits")
        if obs_trace.enabled():
            obs_trace.event("program_store_hit", key=key,
                            load_s=round(clock.now() - t0, 6))
        return payload

    def save(self, key: str, payload, meta: dict | None = None,
             backend: str | None = None) -> bool:
        """Persist one payload atomically. Returns False (never raises)
        when it cannot: the store is an accelerator, and the caller holds a
        working strategy."""
        import torch

        from distributed_sddmm_tpu_torch.obs import clock
        from distributed_sddmm_tpu_torch.obs import log as obs_log

        try:
            entry = {"schema": SCHEMA_VERSION, "key": key, "backend": backend,
                     "created_epoch": clock.epoch(), "meta": dict(meta or {}),
                     "payload": payload}
            buf = io.BytesIO()
            torch.save(entry, buf)
            atomic_write_bytes(self.path(key), buf.getbuffer())
            self._update_index(entry)
            return True
        except Exception as e:  # noqa: BLE001 -- persistence is best-effort
            obs_log.warn("programs", "store failed; entry not persisted", key=key,
                         error=f"{type(e).__name__}: {e}")
            return False

    def get_or_build(self, key: str, build, restore, export, meta: dict | None = None,
                     backend: str | None = None):
        """``(obj, source)``: ``restore`` of the stored payload
        (``"disk"``), or ``build()`` (``"live"``, counted a
        ``live_compiles``, its ``export(obj)`` saved for the next process;
        a ``program_store_compile`` event carries the build's seconds)."""
        from distributed_sddmm_tpu_torch.obs import clock
        from distributed_sddmm_tpu_torch.obs import trace as obs_trace

        obj = self.load(key, backend=backend, restore=restore)
        if obj is not None:
            return obj, "disk"
        t0 = clock.now()
        obj = build()
        build_s = clock.now() - t0
        self._live()
        self.save(key, export(obj), meta=meta, backend=backend)
        if obs_trace.enabled():
            obs_trace.event("program_store_compile", key=key, compile_s=round(build_s, 6))
        return obj, "live"

    def _miss(self) -> None:
        with self._lock:
            self.misses += 1
        _global_counters().add("program_store_misses")

    def _live(self) -> None:
        with self._lock:
            self.live_compiles += 1
        _global_counters().add("live_compiles")

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "live_compiles": self.live_compiles}


# --------------------------------------------------------------------- #
# Keys of a strategy's set-up
# --------------------------------------------------------------------- #


def strategy_config_tag(alg) -> str:
    """The strategy-configuration half of a key: one fingerprint runs under
    several (algorithm, c, kernel) configurations, whose set-ups differ.
    The strategy class, ``c``, the kernel's family and precision, the
    double-buffered ring, the realized codegen variant and the wire's
    ``key_segment()``. ``alg`` is a strategy, or a :class:`SetupConfig`
    that describes one before it is built."""
    kern = alg.kernel
    family = getattr(kern, "name", type(kern).__name__).split(":")[0]
    bits = [getattr(alg, "class_name", type(alg).__name__), f"c{alg.c}", family]
    if getattr(alg, "overlap", False):
        bits.append("ov")
    vid = alg.kernel_variant_realized
    if vid:
        bits.append(vid)
    wseg = alg.wire.key_segment()
    if wseg:
        bits.append(wseg)
    return "-".join(bits)


class SetupConfig:
    """What :func:`strategy_config_tag` reads of a strategy, known before
    it is built: its class, ``c``, kernel, wire policy and ring build."""

    def __init__(self, cls, c: int, kernel, wire, overlap: bool = False):
        from distributed_sddmm_tpu_torch.parallel.wire import wire_policy

        self.cls, self.class_name = cls, cls.__name__
        self.c, self.kernel, self.overlap = int(c), kernel, bool(overlap)
        self.wire = wire_policy(wire)
        # What the tile sets will record (``build_tiles``: the variant's
        # id, banked or not; replicated tiles: none).
        vid = getattr(getattr(kernel, "variant", None), "variant_id", None)
        self.kernel_variant_realized = vid if cls.bankable else None


def matrix_content_key(S) -> str:
    """Content digest of one sparse matrix (indices, values, shape): the
    JAX package's digest of the same matrix. A set-up is the matrix's
    tiles, so two matrices with one coarse fingerprint (M, N, nnz, R, p)
    must not share an entry."""
    h = hashlib.sha256()
    for arr in (S.rows, S.cols, S.vals):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(f"{S.M}x{S.N}".encode())
    return h.hexdigest()[:12]


def setup_key(fingerprint_key: str, config, S, backend: str, content_key: str,
              world=None, capacity: str | None = None) -> str:
    """The key of one strategy's set-up: ``plan_program_key`` over the
    fingerprint, ``<config tag>-setup`` with the capacity segment of a
    dynamic-structure build (``cap=<request>``, absent for an exact build)
    and the content digest (``x<digest>``), the matrix's signature, the
    backend and the process segment."""
    op = f"{strategy_config_tag(config)}-setup"
    if capacity:
        op += f"-cap={capacity}"
    op += f"-x{content_key}"
    return keys_mod.plan_program_key(
        fingerprint_key, op, keys_mod.sig_for_args((S.rows, S.cols, S.vals)), backend,
        dist=keys_mod.dist_segment(world=world))


# --------------------------------------------------------------------- #
# Strategy binding (autotune Plan.instantiate's hook)
# --------------------------------------------------------------------- #


def build_bound(build, config, S, fingerprint_key: str, *, world=None, device=None,
                store: "ProgramStore | None" = None, capacity: str | None = None):
    """Build a strategy through the store: its set-up loaded from the
    entry (``cls.from_setup``) or built by ``build()`` and saved, then the
    strategy bound (:func:`bind_strategy`). ``config`` is the strategy's
    :class:`SetupConfig` (class included). With no active store, or no
    fingerprint, ``build()`` unbound."""
    store = store if store is not None else active()
    if store is None or not fingerprint_key:
        return build()
    from distributed_sddmm_tpu_torch.device import resolve_device
    from distributed_sddmm_tpu_torch.obs.manifest import backend_name

    device = resolve_device(device)
    backend = backend_name(device, world)
    content = matrix_content_key(S)
    key = setup_key(fingerprint_key, config, S, backend, content, world=world,
                    capacity=capacity)
    alg, _ = store.get_or_build(
        key, build, restore=lambda payload: config.cls.from_setup(build, payload, device),
        export=lambda a: a.export_setup(),
        meta={"fingerprint_key": fingerprint_key, "config": strategy_config_tag(config),
              "content": content, **({"capacity": capacity} if capacity else {})},
        backend=backend)
    bind_strategy(alg, fingerprint_key, store=store, content_key=content)
    return alg


def bind_strategy(alg, fingerprint_key: str, store: "ProgramStore | None" = None,
                  content_key: str | None = None) -> bool:
    """Bind a built strategy to the store under ``fingerprint_key``: its
    binder (``DistributedSparse.bind_program_store``) builds a spilled
    rebind's replacement through the store (``dynstruct/rebind.py``), and
    ``alg._program_store_meta`` records the binding. Returns False (a
    no-op) with no active store or no fingerprint."""
    store = store if store is not None else active()
    if store is None or not fingerprint_key:
        return False
    from distributed_sddmm_tpu_torch.obs.manifest import backend_name

    world = alg.world
    cfg = strategy_config_tag(alg)
    meta = {"store": store, "fingerprint_key": fingerprint_key, "config": cfg,
            "backend": backend_name(alg.device, world),
            "dist": keys_mod.dist_segment(world=world), "content": content_key or ""}

    def binder(build, config, S, capacity=None):
        return build_bound(build, config, S, fingerprint_key, world=world,
                           device=alg.device, store=store, capacity=capacity)

    alg.bind_program_store(binder)
    alg._program_store_meta = meta
    return True


def chained_program(alg, op: str, fn):
    """``fn`` unchanged. The JAX package stores an app's chained program
    (``cgStep``, ``gatLayer``) over a bound strategy; the port runs an app
    step as eager operations over the strategy's kernels and keeps no
    program for it."""
    return fn


# --------------------------------------------------------------------- #
# Activation (the run store's environment grammar)
# --------------------------------------------------------------------- #

_active: ProgramStore | None = None
_env_checked = False
_registry_lock = threading.Lock()


def default_root() -> pathlib.Path:
    from distributed_sddmm_tpu_torch.obs.store import parse_env_spec

    _enabled, root = parse_env_spec(os.environ.get(PROGRAMS_ENV))
    return pathlib.Path(root) if root else DEFAULT_ROOT


def enable(root: str | os.PathLike | None = None) -> ProgramStore:
    """Turn the process-wide store on (idempotent: an active store wins)."""
    global _active, _env_checked
    with _registry_lock:
        _env_checked = True
        if _active is None:
            _active = ProgramStore(root)
        return _active


def disable() -> None:
    global _active, _env_checked
    with _registry_lock:
        _active = None
        _env_checked = True


def active() -> ProgramStore | None:
    """The active store, read from ``SDDMM_TORCH_PROGRAMS`` at the first
    query: on at the default root when unset, as in the JAX package."""
    global _active, _env_checked
    if _env_checked:
        return _active
    with _registry_lock:
        if not _env_checked:
            _env_checked = True
            from distributed_sddmm_tpu_torch.obs.store import parse_env_spec

            enabled, root = parse_env_spec(os.environ.get(PROGRAMS_ENV))
            if enabled:
                _active = ProgramStore(root)
    return _active
