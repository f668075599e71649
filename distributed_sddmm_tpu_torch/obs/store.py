"""Persistent run store: every benchmark run becomes a queryable document
(counterpart of ``obs/store.py``, with its document schema, so either
package's store tools read the other's directory).

Each run is kept as one JSON document under
``artifacts/runstore_torch/runs/<run_id>.json``, joined from what the
harness already produces:

* the benchmark **record** (``bench/harness.py``: ``alg_info``, elapsed,
  throughput, per-op ``metrics``, ``anomalies``);
* the **trace aggregate** (``tools/tracereport.aggregate``'s per-phase
  table with the comm-against-model column) when the run was traced;
* the run **manifest** (torch and CUDA versions, the card, its power
  limit, the git revision);
* the problem **fingerprint** (``autotune/fingerprint.py``), the code hash
  over the port's sources (the ``.cu``/``.cuh`` kernels included) and the
  ``backend``, which together make the index key regression comparisons
  match on.

The port's ``backend`` names the card and the world kind
(``cuda:NVIDIA H100 80GB HBM3:local``, ``cpu:local``; ``obs/manifest.py::
backend_name``), and its key hashes the port's kernel families. Neither can
equal a JAX document's (``tpu``, ``cpu``; ``pallas``/``xla``), so a port
run and a JAX run of the same problem never share a baseline, even in one
directory.

``index.json`` (one row a run) makes ``bench history`` read one file. It
is derived state: :meth:`RunStore.rebuild_index` regenerates it from the
documents, and a corrupt index is rebuilt on read. Every write goes
through ``utils/atomic.py`` (a reader sees old or new content, and the
``write:`` fault hook applies).

Activation follows the tracer: the benchmark CLI turns the store on for
``er``, ``file`` and ``heatmap`` (``--no-runstore`` opts out), and
``SDDMM_TORCH_RUNSTORE`` turns it on for library callers (``1`` -> the
default root, a path -> that root, ``0``/``off`` -> off). A caller of
``benchmark_algorithm`` sees no store unless it asks, so tests leave
``artifacts/`` alone.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import threading

from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_json

#: Run-document schema generation; readers skip documents they cannot read.
SCHEMA_VERSION = 1

_REPO = pathlib.Path(__file__).resolve().parents[2]
#: Apart from the JAX package's ``artifacts/runstore/``.
DEFAULT_ROOT = _REPO / "artifacts" / "runstore_torch"

RUNSTORE_ENV = "SDDMM_TORCH_RUNSTORE"

#: The kernel families a port document's key hashes, on any backend.
KERNEL_FAMILIES = ("cuda-f32", "cuda-bf16", "torch")

#: Manifest fields a document carries.
_MANIFEST_FIELDS = ("torch_version", "cuda_version", "backend", "device_name",
                    "device_capability", "device_count", "power_limit", "git_rev",
                    "git_dirty", "env")

#: Index-row fields lifted out of each document (``bench history`` shows
#: them without opening the documents). A field a record does not carry
#: (the serving fields of a benchmark record, say) is None: "not
#: measured", never a verdict.
_INDEX_FIELDS = (
    "run_id", "created_epoch", "key", "backend", "code_hash",
    "algorithm", "app", "R", "c", "fused", "kernel", "kernel_variant",
    # Attention records only: a sliding-window run never pools into a
    # BigBird (or SDDMM) baseline.
    "mask",
    "elapsed", "overall_throughput", "source", "anomaly_count",
    # Serving records only.
    "latency_p99_ms", "shed_count",
    # In-process compiles the run paid (program store).
    "live_compiles",
    # Serving telemetry: histogram percentiles and the SLO burn rate.
    "hist_p50_ms", "hist_p95_ms", "hist_p99_ms", "burn_rate",
    # Process count and this record's process slot; absence reads as one
    # process.
    "num_processes", "process_index",
    # The realized wire policy and the run's counted comm bytes (summed
    # over the per-op metrics; None where no op counted them).
    "wire", "comm_bytes",
    # Zero-retrace structure rebinds (dynamic structure).
    "dynstruct_rebinds",
)

#: Configuration axes (beyond the key) two runs must share to be
#: comparable: one problem runs under many configurations (a heatmap sweep
#: runs every algorithm at every R), and pooling a 2.5D run into a 1.5D
#: baseline would gate on an unlike delta. ``num_processes`` None reads as
#: 1 and ``wire`` None as ``f32`` (documents written before those fields).
_CONFIG_AXES = (
    "algorithm", "app", "c", "fused", "kernel", "kernel_variant", "mask",
    "num_processes", "wire",
)


def _axis_value(row: dict, axis: str):
    """A configuration axis with absence normalised (``num_processes`` None
    is one process, ``wire`` None the f32 identity wire)."""
    v = row.get(axis)
    if axis == "num_processes" and v is None:
        return 1
    if axis == "wire" and v is None:
        return "f32"
    return v


class RunStore:
    """One directory of run documents and the summary index derived from
    them."""

    def __init__(self, root: str | os.PathLike | None = None):
        self.root = pathlib.Path(root) if root else DEFAULT_ROOT
        self.runs_dir = self.root / "runs"
        self.index_path = self.root / "index.json"
        self._lock = threading.Lock()

    # ------------------------------------------------------------ documents

    def put(self, doc: dict) -> pathlib.Path:
        """Persist one document and update the index atomically. ``doc``
        needs a ``run_id``; ``schema`` and ``created_epoch`` are filled in
        when absent. Putting a run id again overwrites it."""
        run_id = doc.get("run_id")
        if not run_id:
            raise ValueError("run doc needs a run_id")
        doc.setdefault("schema", SCHEMA_VERSION)
        doc.setdefault("created_epoch", clock.epoch())
        path = self.runs_dir / f"{_safe_id(run_id)}.json"
        with self._lock, self._flock():
            atomic_write_json(path, doc)
            index = self._read_index()
            if index is _CORRUPT:
                # Recover the other rows from the documents before adding
                # ours: a torn index must not cost the history.
                index = self._rebuild_index_locked()
            index = [r for r in index if r.get("run_id") != run_id]
            index.append(_index_row(doc))
            index.sort(key=lambda r: (r.get("created_epoch") or 0, r["run_id"]))
            atomic_write_json(self.index_path, index)
        return path

    def _flock(self):
        """Advisory lock across processes around the index's
        read-modify-write (:func:`root_flock`)."""
        return root_flock(self.root)

    def get(self, run_id: str) -> dict | None:
        """One document (None when absent or unreadable)."""
        path = self.runs_dir / f"{_safe_id(run_id)}.json"
        try:
            doc = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        return doc if isinstance(doc, dict) else None

    def index(self) -> list[dict]:
        """Summary rows, oldest first; rebuilt from the documents when the
        index file is corrupt."""
        with self._lock:
            rows = self._read_index()
            if rows is _CORRUPT:
                return self._rebuild_index_locked()
            return rows

    def rebuild_index(self) -> list[dict]:
        """Regenerate ``index.json`` from the documents on disk."""
        with self._lock:
            return self._rebuild_index_locked()

    def _read_index(self):
        try:
            rows = json.loads(self.index_path.read_text())
        except FileNotFoundError:
            return []
        except (OSError, json.JSONDecodeError):
            return _CORRUPT
        if not isinstance(rows, list):
            return _CORRUPT
        return [r for r in rows if isinstance(r, dict) and r.get("run_id")]

    def _rebuild_index_locked(self) -> list[dict]:
        rows = []
        for f in sorted(self.runs_dir.glob("*.json")):
            try:
                doc = json.loads(f.read_text())
            except (OSError, json.JSONDecodeError):
                continue  # a torn document: that run, not the store, is lost
            if isinstance(doc, dict) and doc.get("run_id"):
                rows.append(_index_row(doc))
        rows.sort(key=lambda r: (r.get("created_epoch") or 0, r["run_id"]))
        atomic_write_json(self.index_path, rows)
        return rows

    # -------------------------------------------------------------- queries

    def history(self, key: str | None = None, backend: str | None = None,
                limit: int | None = None) -> list[dict]:
        """Index rows, newest last, optionally of one key and/or backend;
        ``limit`` keeps the newest N."""
        rows = self.index()
        if key:
            rows = [r for r in rows if r.get("key") == key]
        if backend:
            rows = [r for r in rows if r.get("backend") == backend]
        if limit is not None and limit >= 0:
            rows = rows[-limit:] if limit else []
        return rows

    def matching(self, doc: dict, limit: int = 5) -> list[dict]:
        """The newest ``limit`` documents comparable to ``doc`` (the same key
        and backend, the same configuration axes), ``doc`` itself left out:
        the rolling baseline of ``bench gate``."""
        key = doc.get("key")
        if not key:
            return []
        cfg = _index_row(doc)
        rows = [
            r for r in self.history(key=key, backend=doc.get("backend"))
            if r.get("run_id") != doc.get("run_id")
            and all(_axis_value(r, a) == _axis_value(cfg, a) for a in _CONFIG_AXES)
        ]
        docs = [self.get(r["run_id"]) for r in rows[-limit:]]
        return [d for d in docs if d]

    def resolve(self, spec: str) -> dict | None:
        """A CLI run spec to a document: a run id, a unique prefix,
        ``latest`` or ``latest~N`` (N runs back). None when nothing matches;
        ``ValueError`` when a prefix is ambiguous."""
        if spec.startswith("latest"):
            back = 0
            if spec != "latest":
                try:
                    back = int(spec.split("~", 1)[1])
                except (IndexError, ValueError):
                    return None
            rows = self.index()
            if back >= len(rows):
                return None
            return self.get(rows[-1 - back]["run_id"])
        doc = self.get(spec)
        if doc is not None:
            return doc
        hits = [r for r in self.index() if r["run_id"].startswith(spec)]
        if len(hits) == 1:
            return self.get(hits[0]["run_id"])
        if len(hits) > 1:
            sample = ", ".join(r["run_id"] for r in hits[:4])
            raise ValueError(
                f"run spec {spec!r} is ambiguous ({len(hits)} matches: "
                f"{sample}{', ...' if len(hits) > 4 else ''}); use a "
                "longer prefix"
            )
        return None

    # ----------------------------------------------------------------- join

    def ingest_record(self, record: dict, source: str = "bench") -> dict:
        """Build and persist the document of one benchmark record. A traced
        sweep stamps one tracer run id into every record, so an id already
        stored gets a ``-N`` suffix. Returns the stored document."""
        doc = build_run_doc(record, source=source)
        base = doc["run_id"]
        n = 1
        while self.get(doc["run_id"]) is not None:
            n += 1
            doc["run_id"] = f"{base}-{n}"
        self.put(doc)
        return doc

    def ingest_prebuilt(self, doc: dict) -> dict:
        """Persist a document already joined (backfill)."""
        doc.setdefault("created_epoch", clock.epoch())
        self.put(doc)
        return doc


#: Tells "no index yet" from "index unreadable".
_CORRUPT = object()


@contextlib.contextmanager
def root_flock(root: pathlib.Path):
    """The advisory lock of a store directory (``<root>/.lock``) across
    processes, around an index's read-modify-write: two processes writing
    one store would otherwise each drop the other's row. Without ``fcntl``
    nothing is locked. The run store and the program store
    (``programs/store.py``) take it alike."""
    try:
        import fcntl
    except ImportError:
        yield
        return
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    # The lock file's content is never read.
    with open(root / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _safe_id(run_id: str) -> str:
    """A run id as a file name: no separators, no leading dots."""
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in run_id)
    return safe.lstrip(".") or "run"


def _total_comm_bytes(rec: dict):
    """The counted comm bytes over the record's per-op metrics; None (not
    0) when no op counted them."""
    vals = [
        m.get("comm_bytes")
        for m in (rec.get("metrics") or {}).values()
        if isinstance(m, dict) and m.get("comm_bytes") is not None
    ]
    return sum(vals) if vals else None


def _index_row(doc: dict) -> dict:
    rec = doc.get("record") or {}
    anomalies = (doc.get("anomalies") or {}).get("anomalies", [])
    row = {
        "run_id": doc.get("run_id"),
        "created_epoch": doc.get("created_epoch"),
        "key": doc.get("key"),
        "backend": doc.get("backend"),
        "code_hash": doc.get("code_hash"),
        "algorithm": rec.get("algorithm"),
        "app": rec.get("app"),
        "R": rec.get("R"),
        "c": rec.get("c"),
        "fused": rec.get("fused"),
        "kernel": rec.get("kernel"),
        "kernel_variant": rec.get("kernel_variant"),
        "mask": rec.get("mask"),
        "elapsed": rec.get("elapsed"),
        "overall_throughput": rec.get("overall_throughput"),
        "source": doc.get("source"),
        "anomaly_count": sum(a.get("count", 1) for a in anomalies),
        "latency_p99_ms": (rec.get("latency_ms") or {}).get("p99"),
        "shed_count": rec.get("shed_count"),
        "hist_p50_ms": (rec.get("latency_hist_ms") or {}).get("p50"),
        "hist_p95_ms": (rec.get("latency_hist_ms") or {}).get("p95"),
        "hist_p99_ms": (rec.get("latency_hist_ms") or {}).get("p99"),
        "burn_rate": rec.get("burn_rate"),
        "num_processes": rec.get("num_processes"),
        "process_index": rec.get("process_index"),
        "wire": rec.get("wire"),
        "comm_bytes": _total_comm_bytes(rec),
        # Offline records carry the global counter delta, serving records
        # the engine's own.
        "live_compiles": (
            (rec.get("program_store") or {}).get("live_compiles")
            if rec.get("program_store") is not None
            else (rec.get("engine") or {}).get("live_compiles")
        ),
        "dynstruct_rebinds": (
            (rec.get("dynstruct") or {}).get("dynstruct_rebinds")
            if rec.get("dynstruct") is not None
            else None
        ),
    }
    return {k: row[k] for k in _INDEX_FIELDS}


def _live_backend() -> str:
    """The backend of this process (``obs/manifest.py::backend_name``):
    the current card if CUDA is up, else the CPU; CUDA is never started."""
    from distributed_sddmm_tpu_torch.obs.manifest import backend_name

    return backend_name()


def _fingerprint_for(record: dict, backend: str | None) -> dict:
    """Fingerprint fields and key of a benchmark record, through the
    autotuner's fingerprint, so the plan cache and the run store agree on
    what "the same problem on the same machine under the same code" is."""
    from distributed_sddmm_tpu_torch.autotune import fingerprint as fp

    info = record.get("alg_info") or {}
    problem = fp.Problem(
        M=int(info.get("m") or 0), N=int(info.get("n") or 0),
        nnz=int(info.get("nnz") or 0), R=int(record.get("R") or 0),
    )
    backend = backend or "unknown"
    made = fp.make_fingerprint(problem, p=int(info.get("p") or 0), backend=backend,
                               kernels=KERNEL_FAMILIES)
    return {"fingerprint": made.as_dict(), "key": made.key,
            "code_hash": fp.code_hash(), "backend": backend}


def build_run_doc(record: dict, source: str = "bench") -> dict:
    """The join, without persisting it."""
    doc = {
        "schema": SCHEMA_VERSION,
        "run_id": record.get("run_id") or _fallback_run_id(),
        "created_epoch": clock.epoch(),
        "source": source,
        "record": record,
        "anomalies": record.get("anomalies"),
    }
    backend = None
    trace_path = record.get("trace_path")
    if trace_path:
        from distributed_sddmm_tpu_torch.tools import tracereport

        try:
            # The per-phase aggregate only when the trace holds one bench
            # span: a sweep shares one trace across its records, and the
            # whole file would charge earlier cells' phases to this one.
            # The record's own metrics stay the per-record source.
            if _count_bench_spans(trace_path, stop_after=2) <= 1:
                tr = tracereport.load_trace(trace_path, strict=False)
                agg = tracereport.aggregate(tr)
                doc["phases"] = agg.get("phases")
                doc["trace_events"] = agg.get("events")
                doc["strategy"] = agg.get("strategy")
        except (OSError, ValueError):
            pass  # a torn trace must not lose the record itself
        manifest = tracereport.load_manifest(trace_path)
        if manifest:
            doc["manifest"] = {k: manifest.get(k) for k in _MANIFEST_FIELDS}
            # The manifest saw the run's device and world.
            backend = manifest.get("backend")
    doc.update(_fingerprint_for(record, backend or _live_backend()))
    return doc


def _count_bench_spans(trace_path, stop_after: int = 2) -> int:
    """Closed ``bench`` spans in a trace file, counted on the raw lines
    (``json.dumps`` writes ``"name": "bench"``) and stopping at
    ``stop_after``. A false positive only skips the phase enrichment."""
    n = 0
    with open(trace_path) as fh:
        for line in fh:
            if '"name": "bench"' in line:
                n += 1
                if n >= stop_after:
                    break
    return n


def _fallback_run_id() -> str:
    """An untraced run's id, in the tracer's grammar."""
    from distributed_sddmm_tpu_torch.obs.trace import _make_run_id

    return _make_run_id()


# ----------------------------------------------------------------- backfill

#: The ``parsed.metric`` of the committed headline records, e.g. "fused
#: SDDMM+SpMM GFLOP/s/chip (R-mat 2^16, nnz/row=32, R=128, pallas-bf16
#: kernel, 1 tpu chip(s))".
_METRIC_RE = (
    r"R-mat 2\^(?P<logm>\d+), nnz/row=(?P<npr>\d+), R=(?P<R>\d+), "
    r"(?P<kernel>[\w.-]+) kernel, (?P<p>\d+) (?P<backend>\w+) chip"
)


def _doc_from_headline(run_id: str, parsed: dict, source: str, rc=None,
                       epoch: float = 0.0) -> dict:
    """One document from a ``BENCH_r0x`` ``parsed`` headline (or the
    mid-round record of the same schema). ``epoch`` is a small ordinal (the
    round), not the ingest time, so backfilled rounds sort before every live
    run and ``latest`` never names one. The document keeps the record's own
    backend and the key None: it lists in ``history`` and enters no live
    run's baseline."""
    import re

    record = {
        "app": "vanilla",
        "overall_throughput": parsed.get("value"),
        "unit": parsed.get("unit"),
        "metric": parsed.get("metric"),
        "vs_baseline": parsed.get("vs_baseline"),
        "note": parsed.get("note"),
        "rc": rc,
    }
    doc = {
        "schema": SCHEMA_VERSION,
        "run_id": run_id,
        "created_epoch": epoch,
        "source": source,
        "record": record,
        "key": None,
        "backend": parsed.get("backend"),
        "code_hash": parsed.get("code_hash", "historical"),
    }
    m = re.search(_METRIC_RE, str(parsed.get("metric", "")))
    if m:
        M = 1 << int(m.group("logm"))
        doc["backend"] = parsed.get("backend") or m.group("backend")
        record["R"] = int(m.group("R"))
        record["alg_info"] = {"m": M, "n": M, "nnz": M * int(m.group("npr")),
                              "p": int(m.group("p"))}
        record["kernel"] = m.group("kernel")
    return doc


def backfill_historical(store: RunStore, root=None) -> list[dict]:
    """Ingest the committed headline records (``BENCH_r0*.json``,
    ``MULTICHIP_r0*.json``, ``artifacts/bench_midround/record.json``), so
    ``bench history`` opens with the repository's trajectory. Idempotent:
    the ids come from the file names. Returns the ingested documents."""
    root = pathlib.Path(root) if root else _REPO

    def _round(stem: str) -> float:
        digits = "".join(c for c in stem if c.isdigit())
        return float(digits) if digits else 0.0

    docs = []
    for f in sorted(root.glob("BENCH_r0*.json")):
        try:
            rec = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        doc = _doc_from_headline(f"backfill-{f.stem.lower()}", rec.get("parsed") or {},
                                 source=f.name, rc=rec.get("rc"), epoch=_round(f.stem))
        docs.append(store.ingest_prebuilt(doc))
    mid = root / "artifacts" / "bench_midround" / "record.json"
    try:
        parsed = json.loads(mid.read_text())
        docs.append(store.ingest_prebuilt(_doc_from_headline(
            "backfill-bench-midround-r05", parsed,
            source="artifacts/bench_midround/record.json",
            epoch=5.5,  # mid-round 5: after r05, before any live run
        )))
    except (OSError, json.JSONDecodeError):
        pass
    for f in sorted(root.glob("MULTICHIP_r0*.json")):
        try:
            rec = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        docs.append(store.ingest_prebuilt({
            "schema": SCHEMA_VERSION,
            "run_id": f"backfill-{f.stem.lower()}",
            "created_epoch": _round(f.stem) + 0.25,
            "source": f.name,
            "key": None,
            "backend": None,
            "code_hash": "historical",
            "record": {
                "app": "multichip",
                "n_devices": rec.get("n_devices"),
                "ok": rec.get("ok"),
                "skipped": rec.get("skipped"),
                "rc": rec.get("rc"),
            },
        }))
    return docs


# --------------------------------------------------------------- activation

_active: RunStore | None = None
_env_checked = False
_registry_lock = threading.Lock()
_suppress_count = 0


@contextlib.contextmanager
def suppressed():
    """Hide the active store for the block, process-wide (an autotune trial
    runs on a worker thread under its timeout). The autotuner's candidate
    trials go through ``benchmark_algorithm`` but are probes, not runs:
    kept, they would share the real run's key and axes and skew the gate's
    baseline with two-trial records."""
    global _suppress_count
    with _registry_lock:
        _suppress_count += 1
    try:
        yield
    finally:
        with _registry_lock:
            _suppress_count -= 1


def parse_env_spec(spec: str | None) -> tuple[bool, str | None]:
    """The grammar of ``SDDMM_TORCH_RUNSTORE``: ``(enabled, root)``, where
    ``0``/``off``/``false``/``no`` disables, ``1``/``on``/``true``/``yes``
    and the empty string select the default root, and any other value is a
    root. The caller decides whether unset means on (a CLI benchmark) or off
    (:func:`active`, which enables only on a non-empty spec)."""
    spec = spec or ""
    low = spec.lower()
    if low in ("0", "off", "false", "no"):
        return False, None
    if not spec or low in ("1", "on", "true", "yes"):
        return True, None
    return True, spec


def enable(root: str | os.PathLike | None = None) -> RunStore:
    """Turn the process-wide store on (idempotent: an active store wins)."""
    global _active, _env_checked
    with _registry_lock:
        _env_checked = True
        if _active is None:
            _active = RunStore(root)
        return _active


def disable() -> None:
    global _active, _env_checked
    with _registry_lock:
        _active = None
        _env_checked = True


@contextlib.contextmanager
def scoped(enabled: bool, root: str | os.PathLike | None = None):
    """The store on (:func:`enable`: an active store wins) or off for the
    block, and the state before it restored after: what a command turns on
    it turns off again."""
    global _active, _env_checked
    with _registry_lock:
        saved = (_active, _env_checked)
    if enabled:
        enable(root)
    else:
        disable()
    try:
        yield _active
    finally:
        with _registry_lock:
            _active, _env_checked = saved


def active() -> RunStore | None:
    """The active store, turned on from ``SDDMM_TORCH_RUNSTORE`` at the
    first query (unset or ``0``/``off``: None); None while
    :func:`suppressed`."""
    global _active, _env_checked
    if _suppress_count:
        return None
    if _env_checked:
        return _active
    with _registry_lock:
        if not _env_checked:
            _env_checked = True
            spec = os.environ.get(RUNSTORE_ENV, "")
            enabled, root = parse_env_spec(spec)
            if spec and enabled:
                _active = RunStore(root)
    return _active
