"""The port's host data layer (``utils/coo.py``) against the JAX package's:
the R-mat draw bit for bit (the native splitmix64 streams written as
torch int64 operations), the seeded generators and permutation, the
matrix-market files each package writes read back by the other, and the
ingest sanitiser's reports on the cases of ``tests/test_coo.py``."""

import logging

import numpy as np
import pytest
import torch

from distributed_sddmm_tpu import native
from distributed_sddmm_tpu.utils import coo as jax_coo
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.utils import coo
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

UNIFORM = dict(a=0.25, b=0.25, c=0.25, d=0.25)
GRAPH500 = dict(a=0.57, b=0.19, c=0.19, d=0.05)
MASK = (1 << 64) - 1


def _equal(got: HostCOO, want: JaxCOO, what: str = "") -> None:
    assert (got.M, got.N) == (want.M, want.N), what
    for key in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=f"{what} {key}")


def _needs_native() -> None:
    if not native.available():
        pytest.skip("the JAX package's native R-mat library did not build here; its "
                    "numpy fallback draws from another generator")


@pytest.mark.parametrize("log_m,edge_factor,init,seed", [
    (5, 4, "uniform", 0), (6, 8, "graph500", 1), (7, 6, "uniform", 3),
    (8, 8, "graph500", 2), (9, 16, "uniform", 5), (10, 8, "graph500", 0),
    (11, 4, "uniform", 7), (12, 8, "graph500", 11), (12, 32, "uniform", 0),
])
def test_rmat_equals_jax(log_m, edge_factor, init, seed):
    _needs_native()
    kw = UNIFORM if init == "uniform" else GRAPH500
    _equal(HostCOO.rmat(log_m, edge_factor, **kw, seed=seed),
           JaxCOO.rmat(log_m=log_m, edge_factor=edge_factor, **kw, seed=seed),
           f"rmat {log_m} {edge_factor} {init} {seed}")


@pytest.mark.parametrize("seed", [0, 3, (1 << 63) + 5])
def test_rmat_edges_equal_native(seed, monkeypatch):
    """The edge streams before deduplication, across chunk boundaries (a
    chunk cut to 1000 edges) and with a seed above 2**63."""
    _needs_native()
    monkeypatch.setattr(coo, "RMAT_CHUNK", 1000)
    for log_m, kw in ((9, GRAPH500), (10, UNIFORM)):
        n = (1 << log_m) * 5
        want = native.rmat_edges(log_m, n, *kw.values(), seed)
        got = coo.rmat_edges(log_m, n, *kw.values(), seed)
        assert all(g.dtype == torch.int64 for g in got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK
    return x ^ (x >> 31)


def _scalar_edge(e: int, log_m: int, a, b, c, d, seed: int) -> tuple:
    """``hnh_native.cpp::hnh_rmat`` for one edge, in Python integers."""
    st = _splitmix64((seed ^ (e * 0x9E3779B97F4A7C15)) & MASK)
    top = b / (a + b) if a + b > 0 else 0.0
    bot = d / (c + d) if c + d > 0 else 0.0
    r = cc = 0
    for _ in range(log_m):
        st = _splitmix64(st)
        u = (st >> 11) * (1.0 / 9007199254740992.0)
        st = _splitmix64(st)
        v = (st >> 11) * (1.0 / 9007199254740992.0)
        rbit = int(u >= a + b)
        cbit = int(v < (bot if rbit else top))
        r, cc = (r << 1) | rbit, (cc << 1) | cbit
    return r, cc


#: Initiators whose split probabilities reach 0 and 1 (a column bit
#: always set above the split; no row ever below it).
EDGE_INITIATORS = [dict(a=0.0, b=0.5, c=0.25, d=0.25), dict(a=0.5, b=0.5, c=0.0, d=0.0)]


@pytest.mark.parametrize("kw,seed", [(UNIFORM, 0), (GRAPH500, 9), (EDGE_INITIATORS[0], 1),
                                     (EDGE_INITIATORS[1], 2)])
def test_rmat_edges_equal_scalar_splitmix64(kw, seed):
    """The first 1000 edges against a scalar Python splitmix64 (which needs
    no native library), the degenerate initiators included."""
    rows, cols = coo.rmat_edges(12, 1000, *kw.values(), seed)
    want = [_scalar_edge(e, 12, *kw.values(), seed) for e in range(1000)]
    assert list(zip(rows.tolist(), cols.tolist())) == want
    if kw in EDGE_INITIATORS and native.available():
        for g, w in zip((rows, cols), native.rmat_edges(12, 1000, *kw.values(), seed)):
            np.testing.assert_array_equal(g.numpy(), w)


def test_rmat_refuses_a_bad_initiator():
    with pytest.raises(ValueError, match="sum to 1"):
        HostCOO.rmat(4, 2, a=0.9, b=0.9, c=0.1, d=0.1)


@pytest.mark.parametrize("M,N,k,seed,values", [(64, 32, 4, 0, "ones"),
                                               (40, 30, 5, 2, "normal"),
                                               (120, 100, 4, 0, "normal")])
def test_erdos_renyi_and_random_permuted_equal_jax(M, N, k, seed, values):
    S = HostCOO.erdos_renyi(M, N, k, seed=seed, values=values)
    J = JaxCOO.erdos_renyi(M, N, k, seed=seed, values=values)
    _equal(S, J, "erdos_renyi")
    _equal(S.random_permuted(seed=seed + 7), J.random_permuted(seed=seed + 7), "permuted")
    _equal(S.random_permuted(), J.random_permuted(), "permuted, default seed")


def test_from_scipy_equals_jax():
    J = JaxCOO.erdos_renyi(32, 16, 4, seed=4, values="normal")
    mat = J.to_scipy()
    _equal(HostCOO.from_scipy(mat), JaxCOO.from_scipy(mat), "from_scipy")


# ------------------------------------------------------------ matrix market

MTX = {
    "general": "%%MatrixMarket matrix coordinate real general\n% a comment\n"
               "4 3 5\n3 2 1.5\n1 1 -2.25\n4 3 1e-300\n2 1 0.1\n1 3 7\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                 "4 4 5\n1 1 1.5\n2 1 2.5\n3 1 3.5\n4 2 -4.5\n4 4 6\n",
    "skew-symmetric": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
                      "3 3 2\n2 1 2.5\n3 2 -4.5\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n3 4 3\n2 1\n3 4\n1 2\n",
    "integer": "%%MatrixMarket matrix coordinate integer general\n2 2 2\n1 2 -3\n2 1 4\n",
}


@pytest.mark.parametrize("kind", list(MTX))
def test_load_mtx_equals_jax(tmp_path, kind):
    """A file of each kind (mirrors appended after the file's entries,
    negated for skew-symmetric; pattern entries are ones) reads the same in
    both packages, in the same entry order."""
    path = tmp_path / f"{kind}.mtx"
    path.write_text(MTX[kind])
    got, want = HostCOO.load_mtx(path), JaxCOO.load_mtx(str(path))
    _equal(got, want, kind)
    if kind == "skew-symmetric":
        assert got.vals.tolist() == [2.5, -4.5, -2.5, 4.5]


def _values(n: int, rng) -> np.ndarray:
    """Values that a writer must keep to the last bit."""
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
    v[:3] = [1 / 3, -0.0, 5e-324][: min(3, n)]
    return v


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mtx_round_trips_between_the_packages(tmp_path, writer):
    """A file one package writes reads back bit for bit in both, entry
    order included."""
    rng = np.random.default_rng(3)
    J = JaxCOO.erdos_renyi(50, 37, 4, seed=1)
    J = J.with_values(_values(J.nnz, rng))
    path = tmp_path / "m.mtx"
    if writer == "port":
        HostCOO(J.rows, J.cols, J.vals, J.M, J.N).save_mtx(path)
    else:
        J.save_mtx(str(path))
    _equal(HostCOO.load_mtx(path), J, f"{writer} file, port read")
    _equal(HostCOO.load_mtx(path), JaxCOO.load_mtx(str(path)), f"{writer} file, jax read")


def test_rmat_round_trips_through_a_file(tmp_path):
    S = HostCOO.rmat(9, 8, **GRAPH500, seed=2)
    S.save_mtx(tmp_path / "g.mtx")
    _equal(HostCOO.load_mtx(tmp_path / "g.mtx"), S, "rmat file")


# ------------------------------------------------------------ ingest sanitiser

SANITIZE = {
    "every_issue": ([0, 1, 9, 1], [0, 1, 0, 1], [1.0, np.nan, 2.0, 3.0], 4, 4),
    "drop_and_dedup": ([0, 1, 9, 1, 2], [0, 1, 0, 1, -3], [1.0, np.nan, 2.0, 3.0, 4.0],
                       4, 4),
    "dedup_counts": ([2, 2, 2], [3, 3, 3], [7.0, 8.0, 9.0], 4, 4),
    "clean": ([0, 1], [1, 0], [1.0, 2.0], 2, 2),
    "empty": ([], [], [], 8, 8),
    "out_of_range_only": ([9], [0], [1.0], 4, 4),
    "inf": ([0, 1], [0, 1], [np.inf, -1.0], 2, 2),
}


@pytest.mark.parametrize("case", list(SANITIZE))
def test_sanitize_equals_jax(case, caplog):
    """``tests/test_coo.py``'s ingest cases: strict mode raises the same
    message or returns the same matrix; repair mode returns the same
    report and matrix, and warns (through ``logging`` here)."""
    rows, cols, vals, M, N = SANITIZE[case]
    try:
        want = jax_coo.sanitize_coo(rows, cols, vals, M, N, mode="strict")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            coo.sanitize_coo(rows, cols, vals, M, N, mode="strict")
        assert str(got.value) == str(e)
        with pytest.raises(ValueError):
            HostCOO.ingest(rows, cols, vals, M, N)
    else:
        got = coo.sanitize_coo(rows, cols, vals, M, N, mode="strict")
        assert got[1] == want[1]
        _equal(got[0], want[0], case)
        _equal(HostCOO.ingest(rows, cols, vals, M, N), want[0], case)
    want = jax_coo.sanitize_coo(rows, cols, vals, M, N, mode="repair")
    with caplog.at_level(logging.WARNING, logger="coo"):
        got = coo.sanitize_coo(rows, cols, vals, M, N, mode="repair")
    assert got[1] == want[1]
    _equal(got[0], want[0], case)
    _equal(HostCOO.ingest(rows, cols, vals, M, N, mode="repair"), want[0], case)
    assert bool(caplog.records) == (got[1]["dropped"] > 0)
    with pytest.raises(ValueError, match="mode must be"):
        coo.sanitize_coo(rows, cols, vals, M, N, mode="lenient")
