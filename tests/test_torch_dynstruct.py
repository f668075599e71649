"""The port's dynamic structure (``dynstruct/``, ``utils/buckets.py``'s
capacity scope, ``HostCOO.append_rows``, the dynamic mask specs) against
the JAX package's, on the same seeded inputs.

Each of the JAX package's ``tests/test_dynstruct.py`` non-smoke tests has
its counterpart here, held against the JAX function where there is one:
the capacity ladder and scope, the row rung, the dynamic mask grammar (the
same values and the same errors), the serve key's capacity segment, the
capacity fingerprint, and rebind across the four strategies. Rebind is
held to a cold rebuild of the grown pattern bit for bit (every op, at (8,
2) on a ``LocalWorld``; every tile tensor keeps its ``data_ptr`` on a
fit), and the rebound SDDMM to the JAX package's rebind on the same grown
matrix: bit for bit on integer values, within 1e-5 of the max abs value on
N(0, 1) data.
"""

import os

import numpy as np
import pytest

import jax

from distributed_sddmm_tpu import dynstruct as jax_dyn
from distributed_sddmm_tpu import masks as jax_masks
from distributed_sddmm_tpu.common import KernelMode as JaxKM
from distributed_sddmm_tpu.programs import keys as jax_keys
from distributed_sddmm_tpu.utils import buckets as jax_buckets
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch import dynstruct, masks
from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel, banded, select_variant
from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.bench.harness import make_algorithm
from distributed_sddmm_tpu_torch.obs import metrics
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel import sharding
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.programs import keys
from distributed_sddmm_tpu_torch.utils import buckets
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

from _torch_strategy_cases import run_ops

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

STRATEGIES = ("15d_fusion2", "15d_sparse", "25d_dense_replicate", "25d_sparse_replicate")
#: The grid of the rebind tests: (p, c) = (8, 2) of a LocalWorld, the JAX
#: package's eight forced CPU devices.
P, C, R = 8, 2, 16


def _port(S) -> HostCOO:
    return HostCOO(S.rows.copy(), S.cols.copy(), S.vals.copy(), S.M, S.N)


def _build(name, S, headroom=4.0, **kw):
    kw.setdefault("kernel", CudaTileKernel("f32", device="cpu"))
    return dynstruct.build(name, S, R, C, headroom=headroom, world=LocalWorld(P),
                           device="cpu", **kw)


def _grow(S, rounds: int, seed: int) -> None:
    """The JAX suite's growth: ``rounds`` appended rows of 1-3 normal values
    (``mode="repair"``), into either package's ``HostCOO``."""
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        n = int(rng.integers(1, 4))
        cols = rng.choice(S.N, size=n, replace=False).astype(np.int64)
        S.append_rows([cols], [rng.standard_normal(n)], mode="repair")


def _ptrs(alg) -> list:
    out = []
    for name in alg.SETUP_TILE_SETS:
        tiles = getattr(alg, name)
        out += [getattr(tiles, f).data_ptr()
                for f in sharding.DEVICE_FIELDS[type(tiles).__name__]]
        out += [v.data_ptr() for _, v in sorted((getattr(tiles, "band_arrays", None)
                                                 or {}).items())]
    return out


def _ops_data(S, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return (rng.integers(-3, 4, (S.M, R)).astype(np.float32),
                rng.integers(-3, 4, (S.N, R)).astype(np.float32),
                rng.integers(-2, 3, S.nnz).astype(np.float32))
    return (rng.standard_normal((S.M, R)).astype(np.float32),
            rng.standard_normal((S.N, R)).astype(np.float32),
            rng.standard_normal(S.nnz).astype(np.float32))


def _sddmm(alg, A, B, v, jax_side: bool = False):
    """sddmmA in host order, with the strategy's pre-shift."""
    from distributed_sddmm_tpu_torch.common import KernelMode

    KM = JaxKM if jax_side else KernelMode
    Ad, Bd = alg.put_a(A), alg.put_b(B)
    a, b = alg.initial_shift(Ad, Bd, KM.SDDMM_A)
    return np.asarray(alg.gather_s_values(alg.sddmm_a(a, b, alg.scatter_s_values(v))))


# --------------------------------------------------------------------- #
# Capacity ladder
# --------------------------------------------------------------------- #


def test_pow2_at_least_never_rounds_down():
    for n in list(range(-2, 300)) + [1025, 2**20 + 1]:
        cap = buckets.pow2_at_least(n)
        assert cap == jax_buckets.pow2_at_least(n)
        assert cap >= max(n, 1) and cap & (cap - 1) == 0
    assert buckets.pow2_ladder(100) == jax_buckets.pow2_ladder(100)
    ladder = buckets.pow2_ladder(48)
    assert [buckets.bucket_for(n, ladder) for n in (0, 1, 3, 33, 48, 99)] == [
        jax_buckets.bucket_for(n, ladder) for n in (0, 1, 3, 33, 48, 99)]


def test_dyn_rung_outside_scope_is_inert():
    assert buckets.dyn_rung(100) is None and buckets.dyn_capacity_state() is None


@pytest.mark.parametrize("headroom", [1.0, 1.5, 4.0])
def test_dyn_rung_scope_realizes_and_replays_floors(headroom):
    reqs = [(100, 1), (5, 3), (0, 1), (1000, 8), (7, 1)]
    realized = {}
    for mod, name in ((buckets, "port"), (jax_buckets, "jax")):
        with mod.dyn_capacity(headroom=headroom) as scope:
            caps = [mod.dyn_rung(raw, multiple=m) for raw, m in reqs]
        with mod.dyn_capacity(headroom=headroom, floors=tuple(scope.realized)) as again:
            smaller = [mod.dyn_rung(max(raw // 2, 0), multiple=m) for raw, m in reqs]
        realized[name] = (caps, list(scope.realized), smaller, list(again.realized))
    assert realized["port"] == realized["jax"]
    caps, _, smaller, _ = realized["port"]
    assert smaller == caps  # a smaller pattern pads back up to the floors


def test_dyn_capacity_scope_guards():
    with pytest.raises(ValueError):
        with buckets.dyn_capacity(headroom=0.5):
            pass
    with buckets.dyn_capacity():
        with pytest.raises(RuntimeError, match="do not nest"):
            with buckets.dyn_capacity():
                pass
    assert buckets.dyn_capacity_state() is None


def test_row_capacity_reserves_growth_rung(monkeypatch):
    for m in (1, 3, 100, 128, 129, 65536):
        for grow in (True, False):
            assert dynstruct.row_capacity(m, grow) == jax_dyn.row_capacity(m, grow)
    assert dynstruct.row_capacity(128) == 256
    S = HostCOO(np.array([0, 2]), np.array([1, 3]), np.ones(2), 3, 4)
    S_cap = dynstruct.with_row_capacity(S, 8)
    assert (S_cap.M, S_cap.N, S_cap.nnz) == (8, 4, 2)
    with pytest.raises(ValueError):
        dynstruct.with_row_capacity(S, 2)
    # The knobs' grammar.
    assert (dynstruct.default_headroom(), dynstruct.default_grow_rows()) == (1.0, True)
    monkeypatch.setenv("SDDMM_TORCH_DYNSTRUCT_HEADROOM", "2.5")
    monkeypatch.setenv("SDDMM_TORCH_DYNSTRUCT_ROWS", "0")
    assert (dynstruct.default_headroom(), dynstruct.default_grow_rows()) == (2.5, False)


# --------------------------------------------------------------------- #
# HostCOO.append_rows
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["strict", "repair"])
def test_append_rows_equals_jax(mode):
    """The grown triplets, the first new row and the sanitize report equal
    the JAX package's bit for bit; in strict mode a corrupt block raises
    the same error and leaves the matrix untouched."""
    base = JaxCOO.erdos_renyi(40, 30, 3, seed=3, values="normal")
    rng = np.random.default_rng(4)
    clean_cols = [rng.choice(30, k, replace=False) for k in (3, 0, 5, 1)]
    clean_vals = [rng.standard_normal(len(c)) for c in clean_cols]
    bad_cols = [np.array([1, 1, 40, 2]), np.array([0, 3])]
    bad_vals = [np.array([1.0, 2.0, 3.0, np.nan]), np.array([np.inf, 4.0])]
    blocks = [(clean_cols, clean_vals), ([], [])]
    if mode == "repair":
        blocks.append((bad_cols, bad_vals))
    got_S, want_S = _port(base), JaxCOO(base.rows.copy(), base.cols.copy(),
                                       base.vals.copy(), base.M, base.N)
    for cols, vals in blocks:
        got = got_S.append_rows(cols, vals, mode=mode)
        want = want_S.append_rows(cols, vals, mode=mode)
        assert got == want
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got_S, f), getattr(want_S, f))
        assert getattr(got_S, f).dtype == getattr(want_S, f).dtype
    assert (got_S.M, got_S.N) == (want_S.M, want_S.N)
    if mode == "strict":
        before = (got_S.M, got_S.nnz)
        with pytest.raises(ValueError) as got_e:
            got_S.append_rows(bad_cols, bad_vals, mode="strict")
        with pytest.raises(ValueError) as want_e:
            want_S.append_rows(bad_cols, bad_vals, mode="strict")
        assert str(got_e.value) == str(want_e.value)
        assert (got_S.M, got_S.nnz) == before
        with pytest.raises(ValueError, match="length mismatch"):
            got_S.append_rows([[1]], [])


# --------------------------------------------------------------------- #
# Dynamic mask grammar
# --------------------------------------------------------------------- #


def test_dynamic_spec_roundtrip():
    assert masks.DYNAMIC_FAMILIES == jax_masks.DYNAMIC_FAMILIES
    for spec in ("window:3", "window:w=5", "topk:7", "topk:k=1", "window:0"):
        got = masks.parse_dynamic_spec(spec)
        assert got == jax_masks.parse_dynamic_spec(spec)
        canon = masks.format_dynamic_spec(*got)
        assert canon == jax_masks.format_dynamic_spec(*got)
        assert masks.parse_dynamic_spec(canon) == got


@pytest.mark.parametrize("bad", ["window:", "topk:", "window:w=x", "topk:q=3", "window:-1",
                                 "topk:0", "gauss:3"])
def test_dynamic_spec_strict_errors(bad):
    with pytest.raises(ValueError) as got:
        masks.parse_dynamic_spec(bad)
    with pytest.raises(ValueError) as want:
        jax_masks.parse_dynamic_spec(bad)
    assert str(got.value) == str(want.value)


def test_dynamic_spec_capacity_bounds():
    assert masks.parse_dynamic_spec("window:4", w_max=4) == ("window", 4)
    for spec, kw in (("window:5", {"w_max": 4}), ("topk:10", {"k_max": 9})):
        with pytest.raises(ValueError, match="serving capacity") as got:
            masks.parse_dynamic_spec(spec, **kw)
        with pytest.raises(ValueError) as want:
            jax_masks.parse_dynamic_spec(spec, **kw)
        assert str(got.value) == str(want.value)


def test_from_spec_window_param_and_topk_rejection():
    got, want = masks.from_spec("window:w=2", 16), jax_masks.from_spec("window:w=2", 16)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    for spec, match in (("topk:4", "request-time dynamic"), ("window:q=2", "unknown window key")):
        with pytest.raises(ValueError, match=match) as g:
            masks.from_spec(spec, 16)
        with pytest.raises(ValueError) as w:
            jax_masks.from_spec(spec, 16)
        assert str(g.value) == str(w.value)


def test_format_dynamic_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown dynamic mask kind") as got:
        masks.format_dynamic_spec("gauss", 3)
    with pytest.raises(ValueError) as want:
        jax_masks.format_dynamic_spec("gauss", 3)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# Key surgery
# --------------------------------------------------------------------- #


def test_serve_key_cap_segment_roundtrip():
    base = keys.serve_program_key("attention", 4, 8, 16, "cpu", code="abc123")
    bucketed = keys.serve_program_key("attention", 4, 8, 16, "cpu", code="abc123",
                                      cap="w4.n128")
    assert base == jax_keys.serve_program_key("attention", 4, 8, 16, "cpu", code="abc123")
    assert bucketed == jax_keys.serve_program_key("attention", 4, 8, 16, "cpu",
                                                  code="abc123", cap="w4.n128")
    assert bucketed != base and bucketed.startswith(base)
    assert keys.parse_serve_key(bucketed) == jax_keys.parse_serve_key(bucketed)
    assert keys.parse_serve_key(bucketed)["cap"] == "w4.n128"
    assert "cap" not in keys.parse_serve_key(base)


def test_op_key_capacity_segment():
    """An exact build's op key carries no capacity segment; a capacity
    build's carries its rungs, so the two never alias."""
    S = HostCOO.erdos_renyi(64, 64, 4, seed=0)
    exact = make_algorithm("15d_fusion2", S, R, C, world=LocalWorld(P), device="cpu",
                           kernel=CudaTileKernel("f32", device="cpu"))
    dyn = _build("15d_fusion2", S)
    assert exact.S_tiles.dyn_cap is None
    assert exact._program_cache_key("sddmm", False) == ("sddmm", False, "full")
    cap = dyn._program_cache_key("sddmm", False)
    assert cap[:3] == ("sddmm", False, "full")
    assert cap[3] == "cap=" + "x".join(str(x) for x in dyn.S_tiles.dyn_cap)


def test_fingerprint_capacity_bucket_mode():
    from distributed_sddmm_tpu.autotune.fingerprint import Problem as JaxProblem
    from distributed_sddmm_tpu.autotune.fingerprint import make_fingerprint as jax_fp

    from distributed_sddmm_tpu_torch.autotune.fingerprint import make_fingerprint

    S1, S2 = (HostCOO.erdos_renyi(64, 64, 4, seed=s) for s in (0, 1))
    p1, p2 = Problem.from_coo(S1, R=16), Problem.from_coo(S2, R=16)
    machine = dict(p=8, backend="cpu", code="deadbeef")
    exact = make_fingerprint(p1, **machine)
    assert exact == make_fingerprint(p1, capacity_bucket=False, **machine)
    assert dict(exact.fields)["nnz"] == p1.nnz
    cap = make_fingerprint(p1, capacity_bucket=True, **machine)
    assert cap != exact and dict(cap.fields)["capacity_mode"] == "pow2"
    assert p1.nnz != p2.nnz
    assert make_fingerprint(p2, capacity_bucket=True, **machine) == cap
    assert make_fingerprint(p2, **machine) != exact
    # The nnz field and the mode marker are the JAX package's.
    jp = JaxProblem.from_coo(JaxCOO(S1.rows, S1.cols, S1.vals, S1.M, S1.N), R=16)
    want = dict(jax_fp(jp, capacity_bucket=True, **machine).fields)
    assert (dict(cap.fields)["nnz"], dict(cap.fields)["capacity_mode"]) == (
        want["nnz"], want["capacity_mode"])


# --------------------------------------------------------------------- #
# Rebind across the four strategies
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", STRATEGIES)
def test_append_rebind_bit_identical_to_cold_rebuild(name):
    """Appended rows rebind in place (a fit, every tile tensor kept), and
    every op then equals a cold build of the grown pattern bit for bit on
    integer data; the rebound SDDMM equals the JAX package's rebind on the
    same grown matrix bit for bit on integers and within 1e-5 of the max
    abs value on N(0, 1) data."""
    S_j = JaxCOO.erdos_renyi(96, 96, 4, seed=7, values="normal")
    S = _port(S_j)
    alg = _build(name, S)
    h = alg._dynstruct
    assert h.row_cap == 128 and h.floors and alg.S_tiles.dyn_cap
    ptrs, nnz = _ptrs(alg), alg.S_tiles.nnz
    _grow(S, rounds=3, seed=8)
    _grow(S_j, rounds=3, seed=8)
    before = metrics.GLOBAL.get("dynstruct_rebinds")
    update = dynstruct.rebind(alg, S)
    assert update.fit and update.alg is alg, update.reason
    assert update.nnz_after == S.nnz > update.nnz_before == nnz
    assert metrics.GLOBAL.get("dynstruct_rebinds") == before + 1
    assert _ptrs(alg) == ptrs
    cold = _build(name, S)
    assert cold._dynstruct.floors == alg._dynstruct.floors
    ints = _ops_data(S, "int", 1)
    got, want = run_ops(alg, *ints), run_ops(cold, *ints)
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)

    jalg = jax_dyn.build(name, S_j, R, C, headroom=4.0, devices=jax.devices()[:P])
    assert jax_dyn.rebind(jalg, S_j).fit
    for kind in ("int", "normal"):
        A, B, v = _ops_data(S, kind, 2)
        g, w = _sddmm(alg, A, B, v), _sddmm(jalg, A, B, v, jax_side=True)
        if kind == "int":
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 1e-5 * float(np.abs(w).max())


def test_banked_rebind_keeps_band_tensors(monkeypatch):
    """A banked build's band tables sit at capacity rungs too: rows that
    move between bands rebind in place (band tensors kept), and every op
    equals a cold build bit for bit; a pattern whose live bands change
    spills."""
    monkeypatch.setattr(banded, "SPLIT", 3)
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.repeat(np.arange(4), 40), rng.integers(4, 96, 300)])
    cols = rng.integers(0, 96, rows.size)
    S = HostCOO(rows, cols, np.ones(rows.size), 96, 96).deduplicated()
    variant = select_variant(Problem.from_coo(S, R))
    assert variant.banked
    kernel = BankedCudaKernel(variant, "f32", device="cpu")
    alg = _build("15d_fusion2", S, headroom=2.0, kernel=kernel)
    assert alg.S_tiles.band_arrays and alg.kernel_variant_realized == variant.variant_id
    ptrs = _ptrs(alg)
    _grow(S, rounds=5, seed=6)
    update = dynstruct.rebind(alg, S)
    assert update.fit, update.reason
    assert _ptrs(alg) == ptrs
    ints = _ops_data(S, "int", 3)
    got = run_ops(alg, *ints)
    want = run_ops(_build("15d_fusion2", S, headroom=2.0, kernel=kernel), *ints)
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)
    # Every heavy row gone: the heavy band's tables vanish, a structure
    # change the fit check catches.
    light = HostCOO(S.rows[S.rows >= 4], S.cols[S.rows >= 4], S.vals[S.rows >= 4], S.M, S.N)
    update = dynstruct.rebind(alg, light)
    assert update.spilled and "structure signature" in update.reason


def test_zero_new_nnz_rebind_is_noop_fit():
    S = _port(JaxCOO.erdos_renyi(96, 96, 4, seed=9, values="normal"))
    alg = _build("15d_fusion2", S, headroom=2.0)
    ints = _ops_data(S, "int", 4)
    before, ptrs = run_ops(alg, *ints), _ptrs(alg)
    update = dynstruct.rebind(alg, S)
    assert update.fit and update.nnz_after == update.nnz_before and _ptrs(alg) == ptrs
    after = run_ops(alg, *ints)
    for op in before:
        np.testing.assert_array_equal(after[op], before[op], err_msg=op)


def test_bucket_spill_returns_replacement():
    S_j = JaxCOO.erdos_renyi(96, 96, 4, seed=10, values="normal")
    S = _port(S_j)
    alg = _build("15d_fusion2", S, headroom=1.0)
    jalg = jax_dyn.build("15d_fusion2", S_j, R, C, headroom=1.0, devices=jax.devices()[:P])
    row_cap = alg._dynstruct.row_cap
    assert row_cap == jalg._dynstruct.row_cap
    _grow(S, rounds=row_cap - S.M + 1, seed=11)
    _grow(S_j, rounds=row_cap - S_j.M + 1, seed=11)
    assert S.M > row_cap
    spills = metrics.GLOBAL.get("dynstruct_bucket_spills")
    retraces = metrics.GLOBAL.get("structure_retraces")
    update = dynstruct.rebind(alg, S)
    assert update.spilled and update.alg is not alg and "row capacity" in update.reason
    assert update.alg._dynstruct.row_cap == 256 > row_cap
    assert metrics.GLOBAL.get("dynstruct_bucket_spills") == spills + 1
    assert metrics.GLOBAL.get("structure_retraces") == retraces + 1
    ints = _ops_data(S, "int", 5)
    got = run_ops(update.alg, *ints)
    want = run_ops(_build("15d_fusion2", S, headroom=1.0), *ints)
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)
    # The JAX package spills at the same row rung, to the same next one.
    jup = jax_dyn.rebind(jalg, S_j)
    assert jup.spilled and jup.alg._dynstruct.row_cap == update.alg._dynstruct.row_cap
    assert jup.reason == update.reason


def test_rebind_rejects_foreign_strategy_and_column_growth():
    S = HostCOO.erdos_renyi(64, 64, 4, seed=12)
    plain = make_algorithm("15d_fusion2", S, R, C, world=LocalWorld(P), device="cpu",
                           kernel=CudaTileKernel("f32", device="cpu"))
    with pytest.raises(ValueError, match="_dynstruct handle"):
        dynstruct.rebind(plain, S)
    alg = _build("15d_fusion2", S)
    with pytest.raises(ValueError, match="column count"):
        dynstruct.rebind(alg, HostCOO(S.rows, S.cols, S.vals, S.M, S.N + 8))


def test_verify_algorithms_on_grown_matrix():
    """The grown pattern is a matrix like any other: the verify protocol
    passes on it across the four strategies, as in the JAX package."""
    from distributed_sddmm_tpu_torch.utils.verify import verify_algorithms

    S = _port(JaxCOO.erdos_renyi(96, 96, 4, seed=13, values="normal"))
    _grow(S, rounds=4, seed=14)
    assert verify_algorithms(R=R, c=C, alg_names=list(STRATEGIES), S=S,
                             kernel=CudaTileKernel("f32", device="cpu"), device="cpu",
                             world=LocalWorld(P))
