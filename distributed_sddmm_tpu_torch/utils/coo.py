"""Host-side sparse matrix container, synthetic generators and
matrix-market IO (counterpart of ``utils/coo.py``).

The matrix lives on the host in numpy: one-time set-up cost. The R-mat
generator is the JAX package's native one (``native/hnh_native.cpp``
``hnh_rmat``: counter-based splitmix64 streams, one per edge) written as
torch ``int64`` operations, so a draw runs on the card or on the host and
gives the same edges, bit for bit, as the JAX package's ``HostCOO.rmat``
for the same arguments. Matrix-market files go through ``scipy.io``;
symmetric files expand their mirror entries (negated for skew-symmetric)
as the JAX package's native reader does, and pattern files get ones.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from distributed_sddmm_tpu_torch.device import resolve_device

_log = logging.getLogger("coo")

_MASK64 = (1 << 64) - 1
#: Edges a chunk of the R-mat draw: its int64 temporaries stay at 8 MB.
RMAT_CHUNK = 1 << 20


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the signed value with its bits."""
    c &= _MASK64
    return c - (1 << 64) if c >> 63 else c


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)
_SIGN = _i64(1 << 63)


def _splitmix64_(x: torch.Tensor, tmp: torch.Tensor) -> None:
    """``hnh_native.cpp``'s splitmix64 on int64 bits, in place (``tmp`` a
    scratch tensor of the same shape). Multiplication wraps modulo 2**64,
    as uint64 arithmetic does; a right shift is torch's arithmetic one
    masked to a logical one."""
    x.add_(_GOLDEN)
    for k, mul in ((30, _MIX1), (27, _MIX2), (31, None)):
        torch.bitwise_right_shift(x, k, out=tmp)
        x.bitwise_xor_(tmp.bitwise_and_((1 << (64 - k)) - 1))
        if mul is not None:
            x.mul_(mul)


def _below(flipped: torch.Tensor, p: float) -> torch.Tensor:
    """``u < p`` for the draws ``u = (bits >> 11) * 2**-53`` (the C++
    ``u01``), given ``bits ^ 2**63``. ``k * 2**-53 < p`` exactly when the
    integer ``k`` is below ``ceil(p * 2**53)`` (``p * 2**53`` is exact), so
    when ``bits``, read unsigned, is below that bound times 2**11; with the
    sign bit flipped a signed compare orders as the unsigned one."""
    if p <= 0:
        return torch.zeros_like(flipped, dtype=torch.bool)
    bound = math.ceil(p * 2.0 ** 53) << 11
    if bound >> 64:
        return torch.ones_like(flipped, dtype=torch.bool)
    return flipped < _i64(bound ^ (1 << 63))


def rmat_edges(log_m: int, n_edges: int, a: float, b: float, c: float, d: float,
               seed: int, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """R-mat edge endpoints ``(rows, cols)`` as int64 tensors on ``device``:
    ``hnh_rmat`` of the JAX package's native layer. Edge ``e`` draws from
    its own stream, ``splitmix64(seed ^ e * 0x9e3779b97f4a7c15)``; at each
    of the ``log_m`` levels two further draws ``u``, ``v`` pick the row
    bit ``u >= a + b`` and the column bit ``v < d / (c + d)`` below the
    split or ``v < b / (a + b)`` above it (probabilities in float64, as the
    C++ doubles)."""
    device = resolve_device(device)
    ab, cd = a + b, c + d
    top = b / ab if ab > 0 else 0.0
    bot = d / cd if cd > 0 else 0.0
    seed64 = _i64(seed)
    rows = torch.empty(n_edges, dtype=torch.int64, device=device)
    cols = torch.empty(n_edges, dtype=torch.int64, device=device)
    for lo in range(0, n_edges, RMAT_CHUNK):
        hi = min(lo + RMAT_CHUNK, n_edges)
        st = torch.arange(lo, hi, dtype=torch.int64, device=device).mul_(_GOLDEN)
        st.bitwise_xor_(seed64)
        tmp = torch.empty_like(st)
        _splitmix64_(st, tmp)
        r, cc = rows[lo:hi].zero_(), cols[lo:hi].zero_()
        for _ in range(log_m):
            _splitmix64_(st, tmp)
            rbit = ~_below(torch.bitwise_xor(st, _SIGN, out=tmp), ab)
            _splitmix64_(st, tmp)
            torch.bitwise_xor(st, _SIGN, out=tmp)
            cbit = torch.where(rbit, _below(tmp, bot), _below(tmp, top))
            r.bitwise_left_shift_(1).bitwise_or_(rbit)
            cc.bitwise_left_shift_(1).bitwise_or_(cbit)
    return rows, cols


def _first_occurrences(keys: torch.Tensor) -> torch.Tensor:
    """Indices of the first copy of each key, ascending: what
    ``np.unique(keys, return_index=True)`` then a sort gives."""
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    return order[first].sort().values


def sanitize_coo(rows, cols, vals, M: int, N: int, *,
                 mode: str = "strict") -> tuple["HostCOO", dict]:
    """Validate raw COO triplets: indices out of ``[0, M) x [0, N)``,
    duplicate coordinates and non-finite values. ``mode="strict"`` raises
    ``ValueError`` naming every issue with its count; ``mode="repair"``
    drops out-of-range and non-finite entries, keeps the first copy of a
    duplicate, logs a warning under the ``"coo"`` logger and returns the
    cleaned matrix. Returns ``(coo, report)``, the report's counts all 0
    for clean input."""
    if mode not in ("strict", "repair"):
        raise ValueError(f"mode must be 'strict' or 'repair', got {mode!r}")
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError("rows/cols/vals must have identical shapes")

    oor = (rows < 0) | (rows >= M) | (cols < 0) | (cols >= N)
    nonfinite = ~np.isfinite(vals)
    keep = ~(oor | nonfinite)
    # Duplicates over the raw coordinates, pair-wise (a row * N + col key
    # is not injective once indices may be out of range).
    if rows.size:
        order = np.lexsort((cols, rows))
        r_s, c_s = rows[order], cols[order]
        dup_count = int(((r_s[1:] == r_s[:-1]) & (c_s[1:] == c_s[:-1])).sum())
    else:
        dup_count = 0
    keys = rows[keep] * max(N, 1) + cols[keep]
    _, first_idx = np.unique(keys, return_index=True)

    report = {"out_of_range": int(oor.sum()), "non_finite": int(nonfinite.sum()),
              "duplicates": dup_count, "dropped": 0}
    issues = {k: v for k, v in report.items() if k != "dropped" and v}
    if issues and mode == "strict":
        raise ValueError(
            f"corrupt COO ingest ({M}x{N}, nnz={rows.size}): "
            + ", ".join(f"{v} {k}" for k, v in issues.items())
            + "; re-ingest with mode='repair' to drop/deduplicate")
    if issues:
        sub = np.flatnonzero(keep)[np.sort(first_idx)]
        report["dropped"] = int(rows.size - sub.size)
        _log.warning("repaired ingest: dropped %d of %d entries (%s)",
                     report["dropped"], rows.size, issues)
        rows, cols, vals = rows[sub], cols[sub], vals[sub]
    return HostCOO(rows, cols, vals, M, N), report


@dataclasses.dataclass
class HostCOO:
    """COO sparse matrix in host memory (struct-of-arrays)."""

    rows: np.ndarray  # int64 [nnz]
    cols: np.ndarray  # int64 [nnz]
    vals: np.ndarray  # float64 [nnz]
    M: int
    N: int

    def __post_init__(self) -> None:
        self.rows = np.asarray(self.rows, dtype=np.int64)
        self.cols = np.asarray(self.cols, dtype=np.int64)
        self.vals = np.asarray(self.vals, dtype=np.float64)
        if not (self.rows.shape == self.cols.shape == self.vals.shape):
            raise ValueError("rows/cols/vals must have identical shapes")
        if self.rows.size:
            if self.rows.min() < 0 or self.rows.max() >= self.M:
                raise ValueError("row index out of range")
            if self.cols.min() < 0 or self.cols.max() >= self.N:
                raise ValueError("col index out of range")

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @classmethod
    def ingest(cls, rows, cols, vals, M: int, N: int, *,
               mode: str = "strict") -> "HostCOO":
        """Sanitizing constructor for untrusted triplets
        (:func:`sanitize_coo`)."""
        return sanitize_coo(rows, cols, vals, M, N, mode=mode)[0]

    # ------------------------------------------------------------ conversions

    @classmethod
    def from_scipy(cls, mat) -> "HostCOO":
        coo = mat.tocoo()
        return cls(coo.row.astype(np.int64), coo.col.astype(np.int64),
                   coo.data.astype(np.float64), int(coo.shape[0]), int(coo.shape[1]))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.vals, (self.rows, self.cols)), shape=(self.M, self.N)
        ).tocsr()

    def transpose(self) -> "HostCOO":
        return HostCOO(self.cols.copy(), self.rows.copy(), self.vals.copy(),
                       self.N, self.M)

    def with_values(self, vals: np.ndarray) -> "HostCOO":
        return HostCOO(self.rows.copy(), self.cols.copy(), np.array(vals),
                       self.M, self.N)

    def sorted_by_row(self) -> "HostCOO":
        order = np.lexsort((self.cols, self.rows))
        return HostCOO(self.rows[order], self.cols[order], self.vals[order],
                       self.M, self.N)

    def deduplicated(self) -> "HostCOO":
        """Drop duplicate (row, col) entries, keeping the first occurrence."""
        keys = self.rows * self.N + self.cols
        _, idx = np.unique(keys, return_index=True)
        idx.sort()
        return HostCOO(self.rows[idx], self.cols[idx], self.vals[idx],
                       self.M, self.N)

    def random_permuted(self, seed: int = 0) -> "HostCOO":
        """Apply a random row and column permutation from
        ``np.random.default_rng(seed)`` (load balance for power-law graphs;
        the reference's ``random_permute`` tool)."""
        rng = np.random.default_rng(seed)
        row_perm = rng.permutation(self.M)
        col_perm = rng.permutation(self.N)
        return HostCOO(row_perm[self.rows], col_perm[self.cols],
                       self.vals.copy(), self.M, self.N)

    # ------------------------------------------------------------ generators

    @classmethod
    def erdos_renyi(cls, M: int, N: int, nnz_per_row: int, seed: int = 0,
                    values: str = "ones") -> "HostCOO":
        """Uniform random sparse matrix with ~``nnz_per_row`` entries per row."""
        rng = np.random.default_rng(seed)
        n_edges = M * nnz_per_row
        rows = rng.integers(0, M, size=n_edges, dtype=np.int64)
        cols = rng.integers(0, N, size=n_edges, dtype=np.int64)
        if values == "ones":
            vals = np.ones(n_edges)
        elif values == "normal":
            vals = rng.standard_normal(n_edges)
        else:
            raise ValueError(f"values must be 'ones' or 'normal', got {values!r}")
        return cls(rows, cols, vals, M, N).deduplicated()

    @classmethod
    def rmat(cls, log_m: int, edge_factor: int, a: float = 0.25, b: float = 0.25,
             c: float = 0.25, d: float = 0.25, seed: int = 0,
             device="cpu") -> "HostCOO":
        """Graph500-style R-mat matrix of ``2**log_m`` rows and
        ``edge_factor`` edges a row before deduplication: the edges of
        :func:`rmat_edges`, drawn on ``device``, the first copy of each
        kept in edge order, then :meth:`random_permuted` with ``seed + 1``
        (Graph500's vertex renaming). Equal, bit for bit, to the JAX
        package's ``HostCOO.rmat`` with the same arguments."""
        if not np.isclose(a + b + c + d, 1.0):
            raise ValueError("initiator probabilities must sum to 1")
        M = 1 << log_m
        n_edges = M * edge_factor
        rows, cols = rmat_edges(log_m, n_edges, a, b, c, d, seed, device)
        keep = _first_occurrences(rows * M + cols)
        rows, cols = rows[keep].cpu().numpy(), cols[keep].cpu().numpy()
        return cls(rows, cols, np.ones(rows.size), M, M).random_permuted(seed=seed + 1)

    # ------------------------------------------------------- matrix-market IO

    @classmethod
    def load_mtx(cls, path) -> "HostCOO":
        """Read a matrix-market file (coordinate or array; symmetric files
        expand their mirrors, negated for skew-symmetric; pattern files get
        ones) in the file's entry order, mirrors after."""
        import scipy.io
        import scipy.sparse as sp

        mat = scipy.io.mmread(str(path))
        return cls.from_scipy(mat if sp.issparse(mat) else sp.coo_matrix(mat))

    def save_mtx(self, path) -> None:
        """Write a ``coordinate real general`` file in this matrix's entry
        order; the values round-trip exactly."""
        import scipy.io
        import scipy.sparse as sp

        scipy.io.mmwrite(str(path), sp.coo_matrix((self.vals, (self.rows, self.cols)),
                                                  shape=(self.M, self.N)),
                         field="real", symmetry="general")
