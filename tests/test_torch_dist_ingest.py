"""The port's partitioned ingest (``distributed_sddmm_tpu_torch/dist/
ingest.py``) against the JAX package's on the same files and seeds.

Every case of ``tests/test_dist_ingest.py``: general, symmetric,
skew-symmetric and pattern files; strict and repair modes; duplicates;
rows out of range; truncation; interior comments; fractional and
malformed lines; ``append_rows``; an empty shard; p = 1 to 8. Each case
holds the port's shards to JAX's field by field (rows, cols, value bits,
``row0``, ``row1``, M, N and the report's counts). ``peak_bytes`` is
equal where the load runs on one thread (the same buffers charged in the
same order); on several threads the order of the charges varies from run
to run in either package, so the two may differ by the buffers in flight
(``threads x 8 x chunk_bytes``). The partitioned generators equal JAX's
bit for bit, against JAX's native R-mat layer (asserted available: its
numpy fallback draws another stream).
"""

import numpy as np
import pytest

from distributed_sddmm_tpu import native
from distributed_sddmm_tpu.dist import ingest as J
from distributed_sddmm_tpu_torch.dist import ingest as P
from distributed_sddmm_tpu_torch.utils.coo import HostCOO, sanitize_coo

COUNT_KEYS = ("out_of_range", "non_finite", "duplicates", "dropped",
              "row_out_of_range_seen", "nnz_local", "chunks", "threads", "chunk_bytes",
              "row_range")


def _canon(coo):
    s = coo.sorted_by_row()
    return s.rows, s.cols, s.vals


def _assert_bit_identical(a, b):
    ra, ca, va = _canon(a)
    rb, cb, vb = _canon(b)
    assert a.M == b.M and a.N == b.N
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(va.view(np.int64), vb.view(np.int64))


def _same_shard(j, p):
    """One shard of JAX's and the port's, field by field."""
    np.testing.assert_array_equal(p.coo.rows, j.coo.rows)
    np.testing.assert_array_equal(p.coo.cols, j.coo.cols)
    np.testing.assert_array_equal(p.coo.vals.view(np.int64), j.coo.vals.view(np.int64))
    assert (p.row0, p.row1, p.nproc, p.proc_id, p.M, p.N) == (
        j.row0, j.row1, j.nproc, j.proc_id, j.M, j.N)
    assert set(p.report) == set(j.report)
    for k in COUNT_KEYS:
        if k in j.report:
            assert p.report[k] == j.report[k], k
    threads = j.report.get("threads", 1)
    if threads == 1:
        assert p.report["peak_bytes"] == j.report["peak_bytes"]
    else:
        assert abs(p.report["peak_bytes"] - j.report["peak_bytes"]) <= (
            threads * 8 * j.report["chunk_bytes"])


def _both(path, nproc, **kw):
    """JAX's and the port's shards of one file, checked equal."""
    j = [J.load_mtx_partitioned(path, nproc, k, **kw) for k in range(nproc)]
    p = [P.load_mtx_partitioned(path, nproc, k, **kw) for k in range(nproc)]
    for a, b in zip(j, p):
        _same_shard(a, b)
    return j, p


def _whole(path, mode, reader=None):
    """The port's whole loader (``scipy.io``; ``reader`` another
    ``(rows, cols, vals, M, N)`` reader) and sanitizer."""
    if reader is not None:
        return sanitize_coo(*reader(str(path)), mode=mode)
    S = HostCOO.load_mtx(path)
    return sanitize_coo(S.rows, S.cols, S.vals, S.M, S.N, mode=mode)


def test_native_layer_is_built():
    assert native.available()


@pytest.fixture(scope="module")
def mtx_file(tmp_path_factory):
    rng = np.random.default_rng(7)
    M, N, nnz = 101, 77, 6000  # duplicates guaranteed
    S = HostCOO(rng.integers(0, M, nnz), rng.integers(0, N, nnz), rng.standard_normal(nnz),
                M, N)
    path = tmp_path_factory.mktemp("mtx") / "mat.mtx"
    S.save_mtx(str(path))
    return path, M, N


class TestBitIdenticalAssembly:
    @pytest.mark.parametrize("nproc", [1, 2, 3, 4, 5, 6, 7, 8])
    def test_repair_assembly_matches_jax_and_whole_loader(self, mtx_file, nproc):
        path, M, _N = mtx_file
        whole, _ = _whole(path, "repair")
        _j, shards = _both(path, nproc, mode="repair", chunk_bytes=2048, threads=3)
        edges = [s.row0 for s in shards] + [shards[-1].row1]
        assert edges[0] == 0 and edges[-1] == M
        assert all(e1 >= e0 for e0, e1 in zip(edges, edges[1:]))
        _assert_bit_identical(P.assemble(shards), whole)
        assert sum(s.report["dropped"] for s in shards) == 6000 - whole.nnz

    @pytest.mark.parametrize("nproc", [1, 4])
    def test_one_thread_peak_bytes_equal(self, mtx_file, nproc):
        path, _M, _N = mtx_file
        _both(path, nproc, mode="repair", chunk_bytes=4096, threads=1)

    def test_strict_on_clean_file_matches(self, tmp_path):
        S = HostCOO.erdos_renyi(64, 50, 3, seed=1, values="normal")
        path = tmp_path / "clean.mtx"
        S.save_mtx(str(path))
        whole, rep = _whole(path, "strict")
        assert rep["duplicates"] == 0
        _j, shards = _both(path, 3, mode="strict", chunk_bytes=1024)
        _assert_bit_identical(P.assemble(shards), whole)

    def test_strict_raises_on_duplicates_like_jax(self, mtx_file):
        path, _M, _N = mtx_file
        for mod in (J, P):
            with pytest.raises(ValueError, match="duplicates"):
                for k in range(3):
                    mod.load_mtx_partitioned(path, 3, k, mode="strict")

    @pytest.mark.parametrize("symmetry", ["symmetric", "skew-symmetric"])
    def test_symmetric_expansion_partitions(self, tmp_path, symmetry):
        scipy_io = pytest.importorskip("scipy.io")
        import scipy.sparse as sp

        A = sp.random(60, 60, density=0.05, random_state=1)
        A = A + A.T if symmetry == "symmetric" else sp.triu(A, 1) - sp.triu(A, 1).T
        path = tmp_path / "sym.mtx"
        scipy_io.mmwrite(str(path), A.tocoo(), symmetry=symmetry)
        whole, _ = _whole(path, "repair")
        _j, shards = _both(path, 3, mode="repair", chunk_bytes=1024)
        _assert_bit_identical(P.assemble(shards), whole)

    def test_pattern_file(self, tmp_path):
        path = tmp_path / "pattern.mtx"
        path.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                        "5 4 6\n1 1\n2 4\n5 2\n3 3\n4 1\n1 4\n")
        whole, _ = _whole(path, "strict")
        _j, shards = _both(path, 2, mode="strict")
        _assert_bit_identical(P.assemble(shards), whole)
        assert all(np.all(s.coo.vals == 1.0) for s in shards)


class TestEdgeCases:
    def test_empty_host_shard(self, tmp_path):
        S = HostCOO([0, 2], [1, 0], [1.0, 2.0], 3, 4)
        path = tmp_path / "tiny.mtx"
        S.save_mtx(str(path))
        _j, shards = _both(path, 5)
        assert [s.nnz for s in shards] == [1, 0, 1, 0, 0]
        assert shards[3].row0 == shards[3].row1 == 3
        _assert_bit_identical(P.assemble(shards), S)

    def test_row_range_matches_jax(self):
        for M in (0, 1, 7, 101, 4096):
            for p in (1, 2, 3, 5, 8):
                ranges = [P.row_range(M, p, k) for k in range(p)]
                assert ranges == [J.row_range(M, p, k) for k in range(p)]
                assert ranges[0][0] == 0 and ranges[-1][1] == M
                sizes = [r1 - r0 for r0, r1 in ranges]
                assert max(sizes) - min(sizes) <= 1
        for args in ((10, 2, 2), (10, 0, 0)):
            with pytest.raises(ValueError):
                P.row_range(*args)

    def test_out_of_range_rows_claimed_once_by_shard_zero(self, tmp_path):
        path = tmp_path / "oob.mtx"
        path.write_text("%%MatrixMarket matrix coordinate real general\n"
                        "4 4 3\n1 1 1.0\n9 2 5.0\n4 4 2.0\n")
        # scipy's reader refuses a row past M: JAX's native reader is the
        # whole loader here.
        whole, wrep = _whole(path, "repair", native.mtx_read)
        _j, shards = _both(path, 2, mode="repair")
        assert wrep["out_of_range"] == 1
        assert [s.report["out_of_range"] for s in shards] == [1, 0]
        _assert_bit_identical(P.assemble(shards), whole)
        for k in range(2):
            for mod in (J, P):
                with pytest.raises(ValueError, match="out_of_range"):
                    mod.load_mtx_partitioned(path, 2, k, mode="strict")

    def test_truncated_file_fails_loudly_in_every_mode(self, tmp_path):
        S = HostCOO.erdos_renyi(50, 40, 4, seed=9, values="normal")
        path = tmp_path / "full.mtx"
        S.save_mtx(str(path))
        lines = path.read_text().splitlines()
        cut = tmp_path / "cut.mtx"
        cut.write_text("\n".join(lines[:-7]) + "\n")
        for mode in ("strict", "repair"):
            for k in range(2):
                for mod in (J, P):
                    with pytest.raises(IOError, match="truncated or corrupt"):
                        mod.load_mtx_partitioned(cut, 2, k, mode=mode)

    def test_interior_comment_lines_skip_like_whole_loader(self, tmp_path):
        path = tmp_path / "comments.mtx"
        path.write_text("%%MatrixMarket matrix coordinate real general\n"
                        "4 4 2\n1 1 1.5\n% a mid-data comment some writers emit\n"
                        "3 4 -2.0\n")
        # scipy's reader refuses a comment among the data lines: JAX's
        # native reader is the whole loader here.
        whole, _ = _whole(path, "strict", native.mtx_read)
        assert whole.nnz == 2
        _j, shards = _both(path, 2)
        _assert_bit_identical(P.assemble(shards), whole)

    @pytest.mark.parametrize("line", ["1 2.5 3.0", "2 2 3.5xx", "1_0 1 1.0", "1 1",
                                      "1 1 1.0 x"])
    def test_malformed_line_raises_in_both(self, tmp_path, line):
        path = tmp_path / "bad.mtx"
        path.write_text("%%MatrixMarket matrix coordinate real general\n"
                        f"4 4 2\n1 1 1.5\n{line}\n")
        for mod in (J, P):
            with pytest.raises(ValueError, match="malformed"):
                mod.load_mtx_partitioned(path, 1, 0, mode="repair")

    def test_append_rows_on_partitioned_shard(self, tmp_path):
        S = HostCOO.erdos_renyi(40, 30, 3, seed=4, values="normal")
        path = tmp_path / "grow.mtx"
        S.save_mtx(str(path))
        whole, _ = _whole(path, "strict")
        jsh, shards = _both(path, 3, mode="strict")
        new_cols, new_vals = [[1, 5], [2]], [[0.5, -1.5], [2.25]]
        first_whole, _ = whole.append_rows(new_cols, new_vals)
        first_shard, rep = shards[2].append_rows(new_cols, new_vals)
        jsh[2].append_rows(new_cols, new_vals)
        _same_shard(jsh[2], shards[2])
        assert first_shard == first_whole == 40
        assert rep["dropped"] == 0
        assert shards[2].row1 == shards[2].M == 42
        _assert_bit_identical(P.assemble(shards), whole)
        with pytest.raises(ValueError, match="last row shard"):
            shards[0].append_rows(new_cols, new_vals)


class TestChunkParser:
    BUFS = [
        b"3 1 0.1000000000000000055511151231257827\n1 2 -7.25e-3\n\n2 3 1e308\n",
        b"1 1 0x1.8p1\n2 2 -inf\n3 3 nan\n4 4 INFINITY\n5 5 .5\n6 6 1.\n",
        b"+1 -2 +3e+2\n007 8 9 10 11\n% comment\n   \n1\t2\t3.25\n",
        b"1 1 1e999\n2 2 4.9406564584124654e-324\n",
    ]

    @pytest.mark.parametrize("i", range(len(BUFS)))
    def test_port_parser_equals_jax_native(self, i):
        want = native.parse_triplets(self.BUFS[i])
        got = P._parse_chunk(self.BUFS[i], False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g).view(np.int64),
                                          np.asarray(w).view(np.int64))
            assert g.dtype == w.dtype

    def test_pattern_chunk(self):
        for g, w in zip(P._parse_chunk(b"1 1\n2 5\n", True),
                        native.parse_triplets(b"1 1\n2 5\n", pattern=True)):
            np.testing.assert_array_equal(g, w)


class TestMemoryBound:
    def test_peak_bytes_scale_with_one_over_p(self, tmp_path):
        rng = np.random.default_rng(3)
        M, N, nnz = 400, 300, 40_000
        S = HostCOO(rng.integers(0, M, nnz), rng.integers(0, N, nnz),
                    rng.standard_normal(nnz), M, N)
        path = tmp_path / "big.mtx"
        S.save_mtx(str(path))
        whole_bytes = nnz * P.ENTRY_BYTES
        chunk, threads = 8192, 2
        peaks = {}
        for nproc in (4, 8):
            _j, shards = _both(path, nproc, mode="repair", chunk_bytes=chunk,
                               threads=threads)
            for s in shards:
                bound = (3 * P.ENTRY_BYTES * (nnz // nproc + 1) + threads * 8 * chunk
                         + (1 << 16))
                assert s.report["peak_bytes"] <= bound
                assert s.report["peak_bytes"] < 2.6 * whole_bytes / nproc
            peaks[nproc] = max(s.report["peak_bytes"] for s in shards)
        assert peaks[8] < 0.8 * peaks[4]


class TestPartitionedGenerators:
    @pytest.mark.parametrize("nproc", [1, 2, 3])
    def test_erdos_renyi_equals_jax_and_is_p_invariant(self, nproc):
        def mk(mod, p, k):
            return mod.erdos_renyi_partitioned(128, 96, 4, p, k, seed=3, values="normal",
                                               chunk_edges=100)

        shards = []
        for k in range(nproc):
            j, p = mk(J, nproc, k), mk(P, nproc, k)
            _same_shard(j, p)
            shards.append(p)
        one = mk(P, 1, 0).coo
        _assert_bit_identical(one, P.assemble(shards))
        assert one.nnz > 0

    @pytest.mark.parametrize("nproc", [1, 4])
    def test_rmat_equals_jax_native_and_is_bounded(self, nproc):
        assert native.available()

        def mk(mod, p, k):
            return mod.rmat_partitioned(8, 4, p, k, seed=3, chunk_edges=128)

        shards = []
        for k in range(nproc):
            j, p = mk(J, nproc, k), mk(P, nproc, k)
            _same_shard(j, p)
            shards.append(p)
        one = mk(P, 1, 0).coo
        _assert_bit_identical(one, P.assemble(shards))
        for s in shards:
            assert s.report["peak_bytes"] <= (
                3 * P.ENTRY_BYTES * (one.nnz // nproc + 1) + 4 * 128 * P.ENTRY_BYTES
                + 2 * 8 * 256 + (1 << 14))

    def test_rmat_skewed_initiator_equals_jax(self):
        kw = dict(a=0.57, b=0.19, c=0.19, d=0.05, seed=11, chunk_edges=300)
        for k in range(3):
            _same_shard(J.rmat_partitioned(9, 8, 3, k, **kw),
                        P.rmat_partitioned(9, 8, 3, k, **kw))

    def test_generator_shard_strategy_ingest(self):
        sh = P.erdos_renyi_partitioned(96, 80, 4, 2, 1, seed=5, values="normal",
                                       chunk_edges=64)
        assert sh.M == 96 and sh.N == 80
        assert sh.coo.rows.min() >= sh.row0 and sh.coo.rows.max() < sh.row1

    def test_host_coo_load_mtx_partitioned(self, mtx_file):
        path, _M, _N = mtx_file
        got = HostCOO.load_mtx_partitioned(str(path), 3, 1, mode="repair")
        _same_shard(J.load_mtx_partitioned(str(path), 3, 1, mode="repair"), got)
