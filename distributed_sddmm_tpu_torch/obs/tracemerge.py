"""Merge of per-process trace shards into one trace, aligned on each
shard's clock origin (counterpart of ``obs/tracemerge.py``).

A run of several processes (``torchrun`` workers, or processes sharing one
``--trace PATH.jsonl``, the later ones rerouted into ``PATH.shards/`` by
``obs/trace.py``) leaves one JSONL shard a process, each with its own
monotonic origin. Every shard's ``begin`` record carries ``t0_epoch`` (the
wall-clock reading of that origin), and the merge aligns on it:

* the earliest shard's ``t0_epoch`` becomes the merged origin, and every
  other shard's records shift by ``its t0_epoch - base``: durations within
  a shard stay exact, and order across shards is as good as the wall
  clocks' agreement (one host: sub-millisecond);
* span and event ids are renumbered into disjoint ranges (each process
  counts from 1) with ``parent`` links rewritten, and every record is
  tagged with its ``shard`` (source run id) and ``pid``;
* cross-process links (``fleet_span`` attrs) become ``fleet_parent``;
* the output is one schema-valid trace (``tools/tracereport`` validates
  every record on load and again after the merge), sorted by time, with a
  ``begin`` whose ``shards`` lists each source's run id, pid, epoch and
  applied offset.

CLI: ``python -m distributed_sddmm_tpu_torch.bench trace-merge SPEC... [-o
OUT]``, where a SPEC is a shard file, a shard directory, or an explicit
``PATH.jsonl`` (merged with its sibling ``PATH.shards/`` directory).
"""

from __future__ import annotations

import hashlib
import json
import pathlib

from distributed_sddmm_tpu_torch.tools import tracereport
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_lines


def _is_merged_output(path: pathlib.Path) -> bool:
    """True when the file's begin record is itself a merge product
    (carries a ``shards`` list). Globbed spec expansion skips these so
    re-running ``trace-merge`` over a directory that already holds a
    prior merged output doesn't double-count every span."""
    try:
        with open(path) as fh:
            rec = json.loads(fh.readline())
    except (OSError, ValueError):
        return False
    return (isinstance(rec, dict) and rec.get("type") == "begin"
            and "shards" in rec)


def discover(spec) -> list[pathlib.Path]:
    """Shard files for one CLI spec: a directory (every ``*.jsonl``
    inside), a ``PATH.jsonl`` stem (itself + ``PATH.shards/*.jsonl``),
    or a single file. Prior merged outputs found by globbing are
    excluded; a merged trace named explicitly is kept as given."""
    p = pathlib.Path(spec)
    if p.is_dir():
        out = [f for f in sorted(p.glob("*.jsonl"))
               if not _is_merged_output(f)]
        if not out:
            raise FileNotFoundError(f"no *.jsonl shards in {p}")
        return out
    out = [p] if p.exists() else []
    shards = p.with_suffix(".shards")
    if p.suffix == ".jsonl" and shards.is_dir():
        out += [f for f in sorted(shards.glob("*.jsonl"))
                if not _is_merged_output(f)]
    if not out:
        raise FileNotFoundError(f"no trace shards at {spec}")
    return out


def merge(paths, strict: bool = True) -> dict:
    """Merge shard files into ``{"begin", "spans", "events", "errors"}``
    (the ``tracereport.load_trace`` shape, plus ``begin["shards"]``).

    Raises ``ValueError`` when ``strict`` and any shard fails schema
    validation, or when no shard contributes a ``begin`` record.
    """
    loaded, errors = [], []
    for path in paths:
        tr = tracereport.load_trace(path, strict=strict)
        errors.extend(f"{path}: {e}" for e in tr["errors"])
        if tr["begin"] is None:
            errors.append(f"{path}: no begin record; shard skipped")
            continue
        loaded.append((pathlib.Path(path), tr))
    if not loaded:
        raise ValueError(
            "no mergeable shards: " + "; ".join(errors[:5]) if errors
            else "no mergeable shards"
        )

    base_epoch = min(
        float(tr["begin"].get("t0_epoch") or 0.0) for _, tr in loaded
    )
    spans, events, shards_meta = [], [], []
    #: (source run_id, original span id) -> merged span id: the lookup
    #: the cross-process parent rewrite below resolves fleet links with.
    spanmap: dict = {}
    id_base = 0
    for path, tr in loaded:
        b = tr["begin"]
        off = float(b.get("t0_epoch") or base_epoch) - base_epoch
        rid, pid = b.get("run_id"), b.get("pid")
        max_id = 0
        for sp in tr["spans"]:
            sp = dict(sp)
            max_id = max(max_id, int(sp["id"]))
            spanmap[(rid, int(sp["id"]))] = int(sp["id"]) + id_base
            sp["id"] = int(sp["id"]) + id_base
            if sp.get("parent") is not None:
                sp["parent"] = int(sp["parent"]) + id_base
            sp["t0"] = round(sp["t0"] + off, 9)
            sp["t1"] = round(sp["t1"] + off, 9)
            sp["shard"] = rid
            if pid is not None:
                sp["pid"] = pid
            spans.append(sp)
        for ev in tr["events"]:
            ev = dict(ev)
            max_id = max(max_id, int(ev["id"]))
            ev["id"] = int(ev["id"]) + id_base
            if ev.get("parent") is not None:
                ev["parent"] = int(ev["parent"]) + id_base
            ev["t"] = round(ev["t"] + off, 9)
            # serve:reply embeds precise trace-relative stamps alongside
            # the emission-time `t`; they live in the same timebase and
            # must shift with it or merged chains land in the source
            # shard's timeline.
            attrs = ev.get("attrs")
            if isinstance(attrs, dict):
                shifted = {
                    k: round(attrs[k] + off, 9)
                    for k in ("t_enqueue", "t_reply")
                    if isinstance(attrs.get(k), (int, float))
                }
                if shifted:
                    ev["attrs"] = {**attrs, **shifted}
            ev["shard"] = rid
            if pid is not None:
                ev["pid"] = pid
            events.append(ev)
        shards_meta.append({
            "run_id": rid, "pid": pid,
            "t0_epoch": b.get("t0_epoch"), "offset_s": round(off, 9),
            "path": str(path),
            "spans": len(tr["spans"]), "events": len(tr["events"]),
        })
        id_base += max_id

    # Second pass — cross-process causality. A record carrying a
    # ``fleet_span`` attr names its causal parent span in another shard
    # (``fleet_shard``, the router's run_id; absent = its own shard —
    # the router's side-thread attempt spans). The merged id is
    # published as ``attrs.fleet_parent`` on every linked record, and a
    # record with no in-process parent (the replica's enqueue event,
    # hedge/audit attempts on parentless side threads) is re-parented
    # onto it — one causally-connected tree per fleet request, without
    # disturbing in-process nesting where it exists (``serve:reply``
    # stays under its ``serve:batch`` span).
    fleet_links = 0
    for rec in spans + events:
        attrs = rec.get("attrs")
        if not isinstance(attrs, dict):
            continue
        fspan = attrs.get("fleet_span")
        if fspan is None:
            continue
        try:
            key = ((attrs.get("fleet_shard") or rec.get("shard")),
                   int(fspan))
        except (TypeError, ValueError):
            continue
        target = spanmap.get(key)
        if target is None:
            continue
        rec["attrs"] = {**attrs, "fleet_parent": target}
        if rec.get("parent") is None:
            rec["parent"] = target
        fleet_links += 1

    spans.sort(key=lambda r: r["t0"])
    events.sort(key=lambda r: r["t"])
    digest = hashlib.sha256(
        "|".join(str(s["run_id"]) for s in shards_meta).encode()
    ).hexdigest()[:10]
    begin = {
        "type": "begin",
        "schema": tracereport.SUPPORTED_SCHEMA,
        "run_id": f"merged-{digest}",
        "t0_epoch": base_epoch,
        "shards": shards_meta,
        "fleet_links": fleet_links,
    }
    return {"begin": begin, "spans": spans, "events": events,
            "errors": errors}


def write_merged(paths, out_path=None, strict: bool = True):
    """Merge ``paths`` and write one time-sorted JSONL trace.

    Returns ``(out_path, merged)``. Default output:
    ``<first shard's directory>/<merged run_id>.jsonl``. Every written
    record is re-validated — a merge that produced an invalid record is
    a bug and raises rather than persisting garbage.
    """
    merged = merge(paths, strict=strict)
    records = sorted(
        merged["spans"] + merged["events"],
        key=lambda r: r["t0"] if r["type"] == "span" else r["t"],
    )
    for rec in [merged["begin"]] + records:
        errs = tracereport.validate_record(rec)
        if errs:
            raise ValueError(f"merge produced an invalid record: {errs}")
    if out_path is None:
        out_path = (
            pathlib.Path(paths[0]).parent / f"{merged['begin']['run_id']}.jsonl"
        )
    out_path = pathlib.Path(out_path)
    # Atomic + streaming: a merged trace is a one-shot artifact — a
    # reader (or a re-run globbing for shards) must never see a
    # half-written file — and multi-shard serving traces are large, so
    # records serialize one at a time instead of joining into one
    # in-memory payload.
    atomic_write_lines(
        out_path,
        (json.dumps(rec, default=str)
         for rec in [merged["begin"], *records]),
    )
    return out_path, merged
