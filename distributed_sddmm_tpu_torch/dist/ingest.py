"""Partitioned host ingest: each process parses only its own block rows
(counterpart of ``dist/ingest.py``).

* :func:`row_range` is the canonical block-row partition (the first
  ``M % p`` processes take one extra row, so ``p`` need not divide ``M``);
* :func:`load_mtx_partitioned` streams a ``.mtx`` file in byte-range
  chunks on a thread pool and keeps only the entries whose row falls in
  this process's range: peak host bytes are ``O(nnz/p)`` for the kept
  triplets plus the chunks in flight, never ``O(nnz)`` (the report's
  ``peak_bytes``);
* :func:`erdos_renyi_partitioned` / :func:`rmat_partitioned` draw edges in
  fixed-size chunks with a seed a chunk, so the assembled matrix depends on
  ``(seed, chunk_edges)`` and not on ``p``; each process keeps its rows.
  The R-mat chunks come from ``utils/coo.rmat_edges`` (the JAX package's
  native splitmix64 draw) on the device given, filtered there: only the
  kept rows reach the host;
* :func:`assemble` concatenates shards into one ``HostCOO`` (the check
  against the whole-matrix loader).

Sanitisation agrees with the whole loader: duplicates share a row, hence a
shard, so keep-first dedup within a shard (file order kept) is the whole
dedup restricted to it. Every process scans every line, so out-of-range
and non-finite entries are tallied over the whole file and
``mode="strict"`` raises on every process; in repair mode each shard's
:func:`~distributed_sddmm_tpu_torch.utils.coo.sanitize_coo` drops its own
bad entries, with rows out of range (owned by no shard) routed to shard 0,
so each is dropped once. A file shorter than its header's count fails in
every mode.

The chunk parser is the JAX package's numpy path, rule for rule: blank
and ``%``-comment lines are skipped; index fields are whole integers as C
``strtol`` reads them; value fields are what C ``strtod`` reads (decimal,
hexadecimal, ``inf``/``nan``); extra numeric fields are legal; any other
line raises. The JAX package pins its native parser to that path. The
per-line parse holds the GIL, so the thread pool overlaps only the file
reads.

The chunked generators draw a stream a chunk, so they agree with
themselves across ``p`` but not with the one-shot ``HostCOO.erdos_renyi``
/ ``HostCOO.rmat`` streams; the ``.mtx`` path equals the whole loader.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import re
import threading
from typing import Optional

import numpy as np

from distributed_sddmm_tpu_torch.utils.coo import HostCOO, rmat_edges, sanitize_coo

#: Triplet bytes an entry in the accumulation buffers (int64 row + int64
#: col + float64 value): the unit the peak-bytes bound is stated in.
ENTRY_BYTES = 24

INGEST_THREADS_ENV = "SDDMM_TORCH_DIST_INGEST_THREADS"
INGEST_CHUNK_ENV = "SDDMM_TORCH_DIST_INGEST_CHUNK"

_DEF_CHUNK = 4 << 20


def _ingest_threads() -> int:
    env = os.environ.get(INGEST_THREADS_ENV)
    if env:
        return max(int(env), 1)
    return min(os.cpu_count() or 1, 8)


def _ingest_chunk_bytes() -> int:
    env = os.environ.get(INGEST_CHUNK_ENV)
    return max(int(env), 4096) if env else _DEF_CHUNK


def row_range(M: int, nproc: int, proc_id: int) -> tuple[int, int]:
    """Block-row range ``[r0, r1)`` of process ``proc_id``: the first
    ``M % nproc`` processes take ``M // nproc + 1`` rows; processes beyond
    ``M`` get empty ranges (an empty shard is a shard)."""
    if nproc <= 0:
        raise ValueError(f"nproc must be positive, got {nproc}")
    if not (0 <= proc_id < nproc):
        raise ValueError(f"proc_id {proc_id} out of range [0, {nproc})")
    base, rem = divmod(M, nproc)
    r0 = proc_id * base + min(proc_id, rem)
    r1 = r0 + base + (1 if proc_id < rem else 0)
    return r0, r1


class _PeakAccounting:
    """Live peak bytes of the loader's buffers: ``charge``/``release``
    bracket transient buffers (a chunk's bytes, its parsed arrays),
    ``grow`` the kept triplets, which are never released while loading."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.current = 0
        self.peak = 0

    def charge(self, n: int) -> None:
        with self._lock:
            self.current += int(n)
            if self.current > self.peak:
                self.peak = self.current

    def release(self, n: int) -> None:
        with self._lock:
            self.current -= int(n)

    def grow(self, n: int) -> None:
        self.charge(n)


@dataclasses.dataclass
class COOShard:
    """One process's block-row partition of a global sparse matrix: ``coo``
    in global coordinates (the ``M x N`` frame) holding only rows in
    ``[row0, row1)``, the form a strategy ingests directly."""

    coo: HostCOO
    row0: int
    row1: int
    nproc: int
    proc_id: int
    report: dict = dataclasses.field(default_factory=dict)

    @property
    def nnz(self) -> int:
        return self.coo.nnz

    @property
    def M(self) -> int:
        return self.coo.M

    @property
    def N(self) -> int:
        return self.coo.N

    def append_rows(self, cols_per_row, vals_per_row, *,
                    mode: str = "strict") -> tuple[int, dict]:
        """``HostCOO.append_rows`` on the shard. New rows land at the
        global growth edge (row ``M``), which the block-row partition gives
        the last shard; any other shard refuses. Extends the shard's range
        and the global ``M`` in place."""
        if self.proc_id != self.nproc - 1:
            raise ValueError(
                f"fold-in rows land on the last row shard ({self.nproc - 1}); "
                f"this is shard {self.proc_id}"
            )
        first, report = self.coo.append_rows(cols_per_row, vals_per_row, mode=mode)
        self.row1 = self.coo.M
        return first, report


def assemble(shards) -> HostCOO:
    """The shards (in process order) concatenated into one global
    ``HostCOO``."""
    shards = sorted(shards, key=lambda s: s.proc_id)
    if not shards:
        raise ValueError("no shards to assemble")
    return HostCOO(
        np.concatenate([s.coo.rows for s in shards]),
        np.concatenate([s.coo.cols for s in shards]),
        np.concatenate([s.coo.vals for s in shards]),
        max(s.M for s in shards), shards[0].N,
    )


# --------------------------------------------------------------------- #
# Streaming .mtx partition reader
# --------------------------------------------------------------------- #


def _mtx_header(path) -> tuple[int, int, int, str, str, int]:
    """Banner and size line: ``(M, N, nnz_declared, field, symmetry,
    data_offset)``. Only coordinate real, integer and pattern files
    stream."""
    with open(path, "rb") as fh:
        parts = fh.readline().decode("ascii", "replace").strip().split()
        if len(parts) < 5 or not parts[0].startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        fmt, field, symmetry = parts[2].lower(), parts[3].lower(), parts[4].lower()
        if fmt != "coordinate" or field == "complex":
            raise ValueError(f"{path}: {fmt}/{field} files do not stream; use "
                             "HostCOO.load_mtx")
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: missing size line")
            s = line.strip()
            if not s or s.startswith(b"%"):
                continue
            dims = s.split()
            if len(dims) != 3:
                raise ValueError(f"{path}: bad size line {s!r}")
            M, N, nnz = (int(x) for x in dims)
            return M, N, nnz, field, symmetry, fh.tell()


def _chunk_ranges(path, start: int, chunk_bytes: int) -> list[tuple[int, int]]:
    size = os.path.getsize(path)
    if start >= size:
        return []
    edges = list(range(start, size, chunk_bytes)) + [size]
    return list(zip(edges[:-1], edges[1:]))


def _read_chunk_lines(fh, lo: int, hi: int, data_start: int) -> bytes:
    """The bytes of every line that starts in ``[lo, hi)``: a chunk that
    does not begin a line drops its leading partial line (the chunk it
    started in reads through the boundary)."""
    if lo > data_start:
        fh.seek(lo - 1)
        fresh = fh.read(1) == b"\n"
    else:
        fresh = True
    fh.seek(lo)
    buf = fh.read(hi - lo)
    if not fresh:
        cut = buf.find(b"\n")
        buf = buf[cut + 1:] if cut >= 0 else b""
    # Finish the line crossing the upper boundary; an empty buf means no
    # line starts here.
    if buf and hi < os.fstat(fh.fileno()).st_size and buf[-1:] != b"\n":
        buf += fh.readline()
    return buf


#: One whole index field as C strtol reads it (fields are split first, so
#: no leading blanks): an optional sign and decimal digits.
_INT_RE = re.compile(r"^[+-]?[0-9]+$")
#: What C strtod reads: decimal and exponent forms, hexadecimal floats,
#: inf / infinity / nan.
_FLT_RE = re.compile(
    r"^[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?$"
    r"|^[+-]?0[xX][0-9a-fA-F]*\.?[0-9a-fA-F]*([pP][+-]?[0-9]+)?$"
    r"|^[+-]?(inf(inity)?|nan)$",
    re.IGNORECASE,
)


def _strtod(token: str) -> float:
    """``float()`` held to strtod's forms. Without an underscore, what
    ``float()`` takes of a split ASCII field (decimal, exponent, inf,
    infinity, nan) is exactly ``_FLT_RE``'s decimal and inf/nan forms, with
    the same correctly rounded value, so ``float()`` answers first."""
    if "_" not in token:
        try:
            return float(token)
        except ValueError:
            pass
    if not _FLT_RE.match(token):
        raise ValueError(f"bad float field {token!r}")
    if "x" in token.lower():
        return float.fromhex(token)
    return float(token)


def _is_int(field: str) -> bool:
    """``_INT_RE`` (``str.isdigit`` answers first: on ASCII it is
    ``[0-9]+``)."""
    return field.isdigit() or _INT_RE.match(field) is not None


def _parse_chunk(buf: bytes, pattern: bool):
    """One chunk of data lines -> 0-based ``(rows, cols, vals)`` (int64,
    int64, float64), by the rules of the module doc."""
    width = 2 if pattern else 3
    rows_l, cols_l, vals_l = [], [], []
    for ln, line in enumerate(buf.decode("ascii", "replace").splitlines()):
        t = line.split()
        if not t or t[0].startswith("%"):
            continue
        try:
            if len(t) < width:
                raise ValueError("missing fields")
            if not (_is_int(t[0]) and _is_int(t[1])):
                raise ValueError("bad index field")
            r, c = int(t[0]), int(t[1])
            v = 1.0 if pattern else _strtod(t[2])
            for extra in t[width:]:
                _strtod(extra)
        except ValueError:
            raise ValueError(
                f"malformed matrix-market data line {ln + 1} of chunk: {line[:60]!r}"
            ) from None
        rows_l.append(r - 1)
        cols_l.append(c - 1)
        vals_l.append(v)
    return (np.asarray(rows_l, dtype=np.int64),
            np.asarray(cols_l, dtype=np.int64),
            np.asarray(vals_l, dtype=np.float64))


def load_mtx_partitioned(
    path,
    nproc: int,
    proc_id: int,
    *,
    mode: str = "strict",
    threads: Optional[int] = None,
    chunk_bytes: Optional[int] = None,
) -> COOShard:
    """Stream one ``.mtx`` file, keeping this process's block rows.

    Assembled over every process, equal to ``HostCOO.load_mtx`` +
    :func:`sanitize_coo` bit for bit (module doc), with peak host bytes
    ``O(nnz/p) + O(threads x chunk_bytes)`` (``report["peak_bytes"]``).
    Symmetric files expand on the fly: the mirror ``(j, i)`` of an entry
    is kept by the shard owning row ``j``. ``threads`` and
    ``chunk_bytes`` default to ``SDDMM_TORCH_DIST_INGEST_THREADS`` (else
    up to 8) and ``SDDMM_TORCH_DIST_INGEST_CHUNK`` (else 4 MiB).
    """
    threads = threads if threads is not None else _ingest_threads()
    chunk_bytes = chunk_bytes if chunk_bytes is not None else _ingest_chunk_bytes()
    M, N, nnz_declared, field, symmetry, data_start = _mtx_header(path)
    r0, r1 = row_range(M, nproc, proc_id)
    pattern = field == "pattern"
    mirror_sign = -1.0 if symmetry == "skew-symmetric" else 1.0
    symmetric = symmetry in ("symmetric", "skew-symmetric", "hermitian")

    acct = _PeakAccounting()
    ranges = _chunk_ranges(path, data_start, chunk_bytes)
    n_chunks = len(ranges)
    base_parts: list = [None] * n_chunks
    mirror_parts: list = [None] * n_chunks
    parsed_counts = [0] * n_chunks
    # Whole-file tallies, kept by every process: strict mode fails on
    # every worker of a pod, not only on the one owning the bad entry.
    seen = {"row_out_of_range": 0, "col_out_of_range": 0, "non_finite": 0}
    seen_lock = threading.Lock()

    def one_chunk(idx: int) -> None:
        lo, hi = ranges[idx]
        with open(path, "rb") as fh:  # a handle a task: seeks must not race
            buf = _read_chunk_lines(fh, lo, hi, data_start)
        acct.charge(len(buf))
        rows, cols, vals = _parse_chunk(buf, pattern)
        parsed_counts[idx] = int(rows.size)
        parsed_bytes = rows.nbytes + cols.nbytes + vals.nbytes
        acct.charge(parsed_bytes)
        acct.release(len(buf))
        del buf
        row_oob = (rows < 0) | (rows >= M)
        counts = {
            "row_out_of_range": int(row_oob.sum()),
            "col_out_of_range": int(((cols < 0) | (cols >= N)).sum()),
            "non_finite": int((~np.isfinite(vals)).sum()),
        }
        if any(counts.values()):
            with seen_lock:
                for k, v in counts.items():
                    seen[k] += v
        keep = ((rows >= r0) & (rows < r1)) | (row_oob if proc_id == 0
                                               else np.zeros_like(row_oob))
        local = (rows[keep], cols[keep], vals[keep])
        acct.grow(sum(a.nbytes for a in local))
        base_parts[idx] = local
        if symmetric:
            off = rows != cols
            mrows, mcols = cols[off], rows[off]
            mkeep = (mrows >= r0) & (mrows < r1)
            mirror = (mrows[mkeep], mcols[mkeep], mirror_sign * vals[off][mkeep])
            acct.grow(sum(a.nbytes for a in mirror))
            mirror_parts[idx] = mirror
        acct.release(parsed_bytes)

    if n_chunks:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(min(threads, n_chunks), 1)) as pool:
            list(pool.map(one_chunk, range(n_chunks)))
    total_parsed = sum(parsed_counts)
    if total_parsed != nnz_declared:
        raise IOError(f"{path}: header declares {nnz_declared} entries, parsed "
                      f"{total_parsed} (truncated or corrupt file)")
    if mode == "strict" and any(seen.values()):
        issues = {k: v for k, v in seen.items() if v}
        raise ValueError(
            f"corrupt COO ingest ({M}x{N}, file {path}): "
            + ", ".join(f"{v} {k}" for k, v in issues.items())
            + "; re-ingest with mode='repair' to drop"
        )

    def _cat(parts, f):
        live = [p for p in parts if p is not None and p[f].size]
        if not live:
            return np.empty(0, dtype=np.int64 if f < 2 else np.float64)
        return np.concatenate([p[f] for p in live])

    # Base entries in file order, then mirrors in file order: the whole
    # loader's order restricted to this shard, so keep-first dedup agrees.
    def _field(f):
        if not symmetric:
            return _cat(base_parts, f)
        return np.concatenate([_cat(base_parts, f), _cat(mirror_parts, f)])

    rows_l, cols_l, vals_l = _field(0), _field(1), _field(2)
    del base_parts, mirror_parts
    # The concatenation briefly doubles the kept triplets.
    acct.charge(rows_l.nbytes + cols_l.nbytes + vals_l.nbytes)

    coo, report = sanitize_coo(rows_l, cols_l, vals_l, M, N, mode=mode)
    report.update(
        row_out_of_range_seen=int(seen["row_out_of_range"]),
        nnz_local=coo.nnz,
        peak_bytes=acct.peak,
        chunks=n_chunks,
        threads=threads,
        chunk_bytes=chunk_bytes,
        row_range=[r0, r1],
    )
    return COOShard(coo=coo, row0=r0, row1=r1, nproc=nproc, proc_id=proc_id,
                    report=report)


# --------------------------------------------------------------------- #
# Chunked partitioned generators
# --------------------------------------------------------------------- #


def _chunk_seed(seed: int, chunk: int) -> list:
    """A chunk's seed-sequence key: a function of ``(seed, chunk)`` only,
    so the edges do not depend on ``p``."""
    return [int(seed) & 0x7FFFFFFF, int(chunk)]


def erdos_renyi_partitioned(
    M: int,
    N: int,
    nnz_per_row: int,
    nproc: int,
    proc_id: int,
    *,
    seed: int = 0,
    values: str = "ones",
    chunk_edges: int = 1 << 18,
) -> COOShard:
    """Chunked Erdos-Renyi draw, block-row partitioned: ``chunk_edges``
    edges a chunk from the chunk's numpy stream, rows outside this range
    dropped, then keep-first dedup. Peak host bytes: ``O(M·npr/p)`` kept
    plus one chunk."""
    if values not in ("ones", "normal"):
        raise ValueError(f"values must be 'ones' or 'normal', got {values!r}")
    r0, r1 = row_range(M, nproc, proc_id)
    n_edges = M * nnz_per_row
    acct = _PeakAccounting()
    parts = []
    for ci, lo in enumerate(range(0, n_edges, chunk_edges)):
        n = min(chunk_edges, n_edges - lo)
        rng = np.random.default_rng(_chunk_seed(seed, ci))
        rows = rng.integers(0, M, size=n, dtype=np.int64)
        cols = rng.integers(0, N, size=n, dtype=np.int64)
        vals = rng.standard_normal(n) if values == "normal" else np.ones(n)
        acct.charge(rows.nbytes + cols.nbytes + vals.nbytes)
        keep = (rows >= r0) & (rows < r1)
        block = (rows[keep], cols[keep], vals[keep])
        acct.grow(sum(a.nbytes for a in block))
        parts.append(block)
        acct.release(rows.nbytes + cols.nbytes + vals.nbytes)
    return _finish_generated(parts, M, N, nproc, proc_id, r0, r1, acct)


def rmat_partitioned(
    log_m: int,
    edge_factor: int,
    nproc: int,
    proc_id: int,
    *,
    a: float = 0.25,
    b: float = 0.25,
    c: float = 0.25,
    d: float = 0.25,
    seed: int = 0,
    chunk_edges: int = 1 << 18,
    device="cpu",
) -> COOShard:
    """Chunked R-mat draw, block-row partitioned over the final (renamed)
    rows: the JAX package's ``rmat_partitioned`` bit for bit.

    Each chunk's edges are ``utils/coo.rmat_edges`` with the chunk's seed
    (the first draw of ``default_rng`` over :func:`_chunk_seed`), drawn on
    ``device`` and renamed there by the Graph500 permutations
    (``default_rng(seed + 1)``, rows then columns, as ``HostCOO.rmat``
    draws them). The kept edges stay on ``device`` through the keep-first
    dedup (``utils/coo.py::_first_occurrences``: ``np.unique``'s first
    copies, in order); only the shard's rows reach the host. The two
    ``O(M)`` permutations are the constant of the memory bound; the
    buffers are counted wherever they live, as the JAX package counts its
    host arrays.
    """
    if not np.isclose(a + b + c + d, 1.0):
        raise ValueError("initiator probabilities must sum to 1")
    import torch

    from distributed_sddmm_tpu_torch.device import resolve_device
    from distributed_sddmm_tpu_torch.utils.coo import _first_occurrences

    dev = resolve_device(device)
    M = 1 << log_m
    n_edges = M * edge_factor
    perm_rng = np.random.default_rng(seed + 1)
    row_perm = perm_rng.permutation(M)
    col_perm = perm_rng.permutation(M)
    row_perm_t = torch.from_numpy(row_perm).to(dev)
    col_perm_t = torch.from_numpy(col_perm).to(dev)
    r0, r1 = row_range(M, nproc, proc_id)
    acct = _PeakAccounting()
    acct.grow(row_perm.nbytes + col_perm.nbytes)
    kept_r, kept_c = [], []
    for ci, lo in enumerate(range(0, n_edges, chunk_edges)):
        n = min(chunk_edges, n_edges - lo)
        cseed = int(np.random.default_rng(_chunk_seed(seed, ci)).integers(1 << 62))
        rows, cols = rmat_edges(log_m, n, a, b, c, d, cseed, device=dev)
        acct.charge(2 * 8 * n)  # rows, cols
        prows, pcols = row_perm_t[rows], col_perm_t[cols]
        acct.charge(2 * 8 * n)  # their renamed copies
        keep = (prows >= r0) & (prows < r1)
        kept_r.append(prows[keep])
        kept_c.append(pcols[keep])
        acct.grow(ENTRY_BYTES * kept_r[-1].numel())  # rows, cols and their ones
        acct.release(4 * 8 * n)
    rows, cols = torch.cat(kept_r), torch.cat(kept_c)
    del kept_r, kept_c
    acct.charge(ENTRY_BYTES * rows.numel())  # the concatenation
    # Keep-first dedup where the edges are, as HostCOO.deduplicated does.
    first = _first_occurrences(rows * M + cols)
    rows, cols = rows[first].cpu().numpy(), cols[first].cpu().numpy()
    coo = HostCOO(rows, cols, np.ones(rows.size), M, M)
    return COOShard(coo=coo, row0=r0, row1=r1, nproc=nproc, proc_id=proc_id,
                    report={"nnz_local": coo.nnz, "peak_bytes": acct.peak,
                            "chunks": -(-n_edges // chunk_edges), "row_range": [r0, r1]})


def _finish_generated(parts, M, N, nproc, proc_id, r0, r1,
                      acct: _PeakAccounting) -> COOShard:
    live = [p for p in parts if p[0].size]
    if live:
        rows = np.concatenate([p[0] for p in live])
        cols = np.concatenate([p[1] for p in live])
        vals = np.concatenate([p[2] for p in live])
    else:
        rows = np.empty(0, dtype=np.int64)
        cols = np.empty(0, dtype=np.int64)
        vals = np.empty(0, dtype=np.float64)
    acct.charge(rows.nbytes + cols.nbytes + vals.nbytes)
    coo = HostCOO(rows, cols, vals, M, N).deduplicated()
    report = {
        "nnz_local": coo.nnz,
        "peak_bytes": acct.peak,
        "chunks": len(parts),
        "row_range": [r0, r1],
    }
    return COOShard(coo=coo, row0=r0, row1=r1, nproc=nproc, proc_id=proc_id,
                    report=report)
