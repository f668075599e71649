"""Host-side sparse matrix container and synthetic generators (counterpart
of ``utils/coo.py``).

Plain numpy on the host: one-time set-up cost. ``rmat`` is a vectorized
recursive-quadrant sampler with the same defaults as the JAX package's
generator (uniform 0.25 initiator, deduplication, a random row and column
permutation); it does not reproduce that generator's exact edges, so tests
that compare the two packages carry the JAX package's arrays across.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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

    def random_permuted(self, rng: np.random.Generator) -> "HostCOO":
        """Apply a random row and column permutation (load balance for
        power-law graphs)."""
        row_perm = rng.permutation(self.M)
        col_perm = rng.permutation(self.N)
        return HostCOO(row_perm[self.rows], col_perm[self.cols],
                       self.vals.copy(), self.M, self.N)

    @classmethod
    def erdos_renyi(
        cls,
        M: int,
        N: int,
        nnz_per_row: int,
        rng: np.random.Generator,
        values: str = "ones",
    ) -> "HostCOO":
        """Uniform random sparse matrix with ~``nnz_per_row`` entries per row."""
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
    def rmat(
        cls,
        log_m: int,
        edge_factor: int,
        rng: np.random.Generator,
        a: float = 0.25,
        b: float = 0.25,
        c: float = 0.25,
        d: float = 0.25,
    ) -> "HostCOO":
        """Graph500-style R-mat matrix of ``2**log_m`` rows with
        ``edge_factor`` edges per row before deduplication.

        Each of the ``log_m`` levels draws one uniform number per edge and
        picks a quadrant: ``[0, a)`` top-left, ``[a, a+b)`` top-right,
        ``[a+b, a+b+c)`` bottom-left, the rest bottom-right."""
        if not np.isclose(a + b + c + d, 1.0):
            raise ValueError("initiator probabilities must sum to 1")
        M = 1 << log_m
        n_edges = M * edge_factor
        rows = np.zeros(n_edges, dtype=np.int64)
        cols = np.zeros(n_edges, dtype=np.int64)
        for _ in range(log_m):
            u = rng.random(n_edges, dtype=np.float32)
            row_bit = u >= a + b
            col_bit = ((u >= a) & ~row_bit) | (u >= a + b + c)
            rows = (rows << 1) | row_bit
            cols = (cols << 1) | col_bit
        mat = cls(rows, cols, np.ones(n_edges), M, M).deduplicated()
        return mat.random_permuted(rng)
