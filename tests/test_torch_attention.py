"""Block-sparse attention in the port against the JAX package.

The same numpy inputs go through the JAX package (its ``masks``, its
``XlaKernel`` softmax passes, and ``DenseShift15D`` with
``PallasKernel(interpret=True, precision="f32")``) and through the port
(the plain versions of its CUDA attention kernels, ``TorchKernel`` and its
``DenseShift15D`` on both routes). Tolerances:

* masks, row maxima and the bit-for-bit checks: exact (the same numpy
  arithmetic, or the same max, or the same kernels in the same order);
* row denominators: 1e-6 relative (float32 sums of exps in another order);
* weights: 1e-6 absolute (they lie in [0, 1]);
* attention outputs: 1e-5 of the reference's max abs value (float32 sums
  in another order), and 1e-5 against the float64 oracle.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_sddmm_tpu import masks as jax_masks
from distributed_sddmm_tpu.common import MatMode as JaxMode
from distributed_sddmm_tpu.ops.blocked import CHUNK, build_blocked
from distributed_sddmm_tpu.ops.kernels import XlaKernel
from distributed_sddmm_tpu.ops.kernels import attn_merge_stats as jax_merge
from distributed_sddmm_tpu.ops.pallas_kernels import BlockedTile, PallasKernel
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch import masks
from distributed_sddmm_tpu_torch.bench import harness
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.ops import cuda_kernels
from distributed_sddmm_tpu_torch.ops.cuda_kernels import (
    CudaTileKernel, attn_norm_tile_plain, attn_stats_tile_plain,
)
from distributed_sddmm_tpu_torch.ops.kernels import (
    ATTN_NEG, TorchKernel, attn_merge_stats,
)
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.layouts import ShardedBlockCyclicColumn
from distributed_sddmm_tpu_torch.parallel.sharding import build_tiles
from distributed_sddmm_tpu_torch.utils import oracle
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.interop import state_from_reference

MR, NC, NNZ = 700, 500, 3000
DEAD_ROW = 3


def _port_coo(S) -> HostCOO:
    return HostCOO(S.rows, S.cols, S.vals, S.M, S.N)


def _masked(S, rng, frac=0.1):
    """Unit mask with ``frac`` of the entries zeroed and row DEAD_ROW
    fully masked (present in the pattern, gate 0 everywhere)."""
    vals = np.ones(S.nnz)
    vals[rng.random(S.nnz) < frac] = 0.0
    vals[S.rows == DEAD_ROW] = 0.0
    return S.with_values(vals)


# --------------------------------------------------------------------- #
# (a) masks
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("build", [
    lambda m: m.sliding_window(128, 4),
    lambda m: m.sliding_window(200, 0),
    lambda m: m.bigbird(256, 3, n_global=2, n_random=2, seed=0),
    lambda m: m.bigbird(160, 5, n_global=3, n_random=1, seed=7),
    lambda m: m.from_spec("window:6", 130),
    lambda m: m.from_spec("bigbird:w=2,g=1,r=3", 150, seed=4),
    lambda m: m.from_spec("bigbird", 140),
], ids=["window", "window0", "bigbird", "bigbird-seed7", "spec-window",
        "spec-bigbird", "spec-bigbird-defaults"])
def test_masks_equal_jax(build):
    got, want = build(masks), build(jax_masks)
    assert (got.M, got.N) == (want.M, want.N)
    for field in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_graph_mask_equal_jax():
    G = JaxCOO.rmat(log_m=7, edge_factor=4, seed=0)
    got, want = masks.from_spec("graph", 128, graph=_port_coo(G)), jax_masks.graph_mask(G)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.vals, want.vals)


@pytest.mark.parametrize("spec", [
    "swizzle:3", "bigbird:q=1", "graph", "topk:4", "window:x", "window:k=3",
    "bigbird:w=x",
])
def test_bad_mask_specs_raise_the_jax_errors(spec):
    with pytest.raises(ValueError) as want:
        jax_masks.from_spec(spec, 32)
    with pytest.raises(want.type) as got:
        masks.from_spec(spec, 32)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# (b) plain versions of the tile kernels against the Pallas kernels
# --------------------------------------------------------------------- #


def _tile_data(seed=0):
    """One random tile in both packages' encodings (as in
    ``tests/test_torch_kernels.py``), standard-normal logits, 10% of the
    gates zeroed and row DEAD_ROW fully masked."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, MR, NNZ).astype(np.int64)
    cols = rng.integers(0, NC, NNZ).astype(np.int64)
    meta = build_blocked(1, np.zeros(NNZ, np.int64), rows, cols, MR, NC)
    blk = BlockedTile(
        lr=jnp.array(meta.lr[0]), lc=jnp.array(meta.lc[0]),
        meta=jnp.array(meta.meta[0]), bm=meta.bm, bn=meta.bn,
        gr_blocks=meta.gr_blocks, gc_blocks=meta.gc_blocks, group=meta.group,
    )
    ts = build_tiles(HostCOO(rows, cols, np.ones(NNZ), MR, NC),
                     ShardedBlockCyclicColumn(MR, NC, 1, 1), MR, NC,
                     torch.device("cpu"))
    gate = (rng.random(NNZ) >= 0.1).astype(np.float32)
    gate[rows == DEAD_ROW] = 0.0
    z = rng.standard_normal(NNZ).astype(np.float32)
    assert np.any(rows == DEAD_ROW)
    return meta, blk, ts, gate, z


def _chunked(meta, v):
    out = np.zeros(meta.n_chunks * CHUNK, np.float32)
    out[meta.host_to_chunk] = v
    return jnp.array(out)


def test_attn_tile_plain_matches_pallas():
    meta, blk, ts, gate, z = _tile_data()
    k = PallasKernel(interpret=True, precision="f32")
    gj, zj = _chunked(meta, gate), _chunked(meta, z)
    mj, dj = k.attn_stats_tile_t(blk, gj, zj)
    pj = np.asarray(k.attn_norm_tile_t(blk, gj, zj, mj, dj, jnp.float32))
    pj = pj[meta.host_to_chunk]
    mj, dj = np.asarray(mj)[:MR, 0], np.asarray(dj)[:MR, 0]

    t = ts.tile(0, 0)
    g, zt = ts.scatter_values(gate)[0, 0], ts.scatter_values(z)[0, 0]
    m, d = attn_stats_tile_plain(t, g, zt)
    p = attn_norm_tile_plain(t, g, zt, m, d)

    np.testing.assert_array_equal(m.numpy(), mj)
    np.testing.assert_allclose(d.numpy(), dj, rtol=1e-6)
    assert m[DEAD_ROW] == ATTN_NEG and d[DEAD_ROW] == 0
    got_p = ts.gather_values(p[None, None])
    assert np.abs(got_p - pj).max() <= 1e-6
    assert np.all(got_p[gate == 0] == 0) and np.all(pj[gate == 0] == 0)


def test_attn_tile_plain_pads_give_zero():
    """Tiles of a 2x2 split carry pads at their tail: their weights are
    exactly 0 and they add nothing to the row stats."""
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, MR, NNZ), rng.integers(0, NC, NNZ)
    ts = build_tiles(HostCOO(rows, cols, np.ones(NNZ), MR, NC),
                     ShardedBlockCyclicColumn(MR, NC, 2, 1), MR // 2, NC // 2,
                     torch.device("cpu"))
    gate = ts.like_values(1.0)
    z = ts.scatter_values(rng.standard_normal(NNZ).astype(np.float32))
    n_pads = 0
    for dev in range(2):
        for s in range(2):
            t, pads = ts.tile(dev, s), ts.mask[dev, s] == 0
            n_pads += int(pads.sum())
            m, d = attn_stats_tile_plain(t, gate[dev, s], z[dev, s])
            real = t.rows[~pads].long()
            assert torch.all(d[real] > 0)
            p = attn_norm_tile_plain(t, gate[dev, s], z[dev, s], m, d)
            assert torch.all(p[pads] == 0)
            sums = torch.zeros(t.n_rows).index_add_(0, t.rows, p)
            torch.testing.assert_close(sums[real], torch.ones(len(real)),
                                       rtol=0, atol=1e-6)
    assert n_pads > 0


def test_attn_wrappers_run_plain_on_cpu_without_counting():
    _, _, ts, gate, z = _tile_data(seed=1)
    t = ts.tile(0, 0)
    g, zt = ts.scatter_values(gate)[0, 0], ts.scatter_values(z)[0, 0]
    k = CudaTileKernel(device="cpu")
    cuda_kernels.reset_launch_counts()
    m, d = k.attn_stats_tile(t, g, zt)
    p = k.attn_norm_tile(t, g, zt, m, d)
    want_m, want_d = attn_stats_tile_plain(t, g, zt)
    torch.testing.assert_close(m, want_m, rtol=0, atol=0)
    torch.testing.assert_close(d, want_d, rtol=0, atol=0)
    torch.testing.assert_close(p, attn_norm_tile_plain(t, g, zt, m, d), rtol=0, atol=0)
    assert set(cuda_kernels.launch_counts().values()) == {0}


def test_attn_wrappers_raise_on_a_non_cpu_tensor():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is never taken for it."""
    _, _, ts, _, _ = _tile_data(seed=2)
    t = ts.tile(0, 0)
    meta = torch.device("meta")
    g, z = torch.empty(t.cap, device=meta), torch.empty(t.cap, device=meta)
    m, d = torch.empty(t.n_rows, device=meta), torch.empty(t.n_rows, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.attn_stats_tile(t, g, z)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.attn_norm_tile(t, g, z, m, d)


# --------------------------------------------------------------------- #
# (c) the flat softmax passes: streaming scan, merge, JAX XlaKernel
# --------------------------------------------------------------------- #


def _flat_data(seed=0):
    rng = np.random.default_rng(seed)
    S = _masked(jax_masks.bigbird(200, 3, 2, 2), rng)
    z = rng.standard_normal(S.nnz).astype(np.float32) * 4
    return S, S.vals.astype(np.float32), z


def test_streaming_stats_equal_one_pass_and_jax():
    S, gate, z = _flat_data()
    rows, g, zt = torch.from_numpy(S.rows), torch.from_numpy(gate), torch.from_numpy(z)
    m1, d1 = TorchKernel().attn_stats(rows, g, zt, S.M)
    m2, d2 = TorchKernel(stream_budget=64).attn_stats(rows, g, zt, S.M)
    assert S.nnz > 64
    torch.testing.assert_close(m2, m1, rtol=0, atol=0)
    torch.testing.assert_close(d2, d1, rtol=1e-6, atol=0)
    mj, dj = XlaKernel().attn_stats(jnp.array(S.rows), jnp.array(gate),
                                    jnp.array(z), S.M)
    np.testing.assert_array_equal(m1.numpy(), np.asarray(mj))
    np.testing.assert_allclose(d1.numpy(), np.asarray(dj), rtol=1e-6)
    assert m1[DEAD_ROW] == ATTN_NEG and d1[DEAD_ROW] == 0
    p = TorchKernel(stream_budget=64).attn_normalize(rows, g, zt, m2, d2)
    np.testing.assert_allclose(p.numpy(), oracle.masked_softmax(_port_coo(S), z),
                               atol=1e-6)


def test_softmax_one_call_equals_the_two_halves():
    S, gate, z = _flat_data(seed=1)
    rows, g, zt = torch.from_numpy(S.rows), torch.from_numpy(gate), torch.from_numpy(z)
    k = TorchKernel()
    m, d = k.attn_stats(rows, g, zt, S.M)
    torch.testing.assert_close(k.attn_softmax(rows, g, zt, S.M),
                               k.attn_normalize(rows, g, zt, m, d), rtol=0, atol=0)


def test_merge_stats_matches_jax_and_absorbs_empty_partitions():
    neg = ATTN_NEG
    parts = [([0.0, neg, 2.0], [1.0, 0.0, 3.0]), ([neg, neg, 4.0], [0.0, 0.0, 5.0])]
    m, d = attn_merge_stats([(torch.tensor(a), torch.tensor(b)) for a, b in parts])
    mj, dj = jax_merge([(jnp.array(a, jnp.float32), jnp.array(b, jnp.float32))
                        for a, b in parts])
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), [1.0, 0.0, 3.0 * np.exp(-2.0) + 5.0],
                               rtol=1e-6)


def test_oracle_softmax_matches_jax_oracle():
    from distributed_sddmm_tpu.utils import oracle as jax_oracle

    S, _, z = _flat_data(seed=2)
    rng = np.random.default_rng(3)
    A, B = rng.standard_normal((S.M, 8)), rng.standard_normal((S.N, 8))
    np.testing.assert_array_equal(oracle.masked_softmax(_port_coo(S), z),
                                  jax_oracle.masked_softmax(S, z))
    got, want = oracle.fused_attention_a(_port_coo(S), A, B), jax_oracle.fused_attention_a(S, A, B)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------- #
# (d, e) the strategy: A and B modes, both routes, fused == unfused
# --------------------------------------------------------------------- #


def _jax_attention(S, R, A, B):
    ja = JaxDS(S, R=R, c=1, fusion_approach=2,
               kernel=PallasKernel(interpret=True, precision="f32"),
               devices=jax.devices()[:1])
    Aj, Bj = ja.put_a(A), ja.put_b(B)
    vals = S.vals.astype(np.float32)
    oa, pa = ja.fused_attention(Aj, Bj, ja.scatter_s_values(vals))
    ob, pb = ja.fused_attention(Aj, Bj, ja.scatter_st_values(vals), JaxMode.B)
    want = {"outA": ja.host_a(oa), "probsA": ja.gather_s_values(pa),
            "outB": ja.host_b(ob), "probsB": ja.gather_st_values(pb)}
    return want, (ja.host_a(Aj), ja.host_b(Bj), ja.gather_s_values(ja.scatter_s_values(vals)))


def _port_attention(cs, R, kernel, fusion=2):
    alg = DenseShift15D(cs.S, R=R, fusion_approach=fusion, kernel=kernel, device="cpu")
    A, B = alg.put_a(cs.A), alg.put_b(cs.B)
    sv, st = alg.scatter_s_values(cs.s_vals), alg.scatter_st_values(cs.s_vals)
    oa, pa = alg.fused_attention(A, B, sv)
    ob, pb = alg.fused_attention(A, B, st, MatMode.B)
    got = {"outA": alg.host_a(oa), "probsA": alg.gather_s_values(pa),
           "outB": alg.host_b(ob), "probsB": alg.gather_st_values(pb)}
    return alg, (A, B, sv, st), got


def _check(got, want):
    for op in want:
        if op.startswith("probs"):
            assert np.abs(got[op] - want[op]).max() <= 1e-6, op
        else:
            scale = float(np.abs(want[op]).max())
            assert np.abs(got[op] - want[op]).max() <= 1e-5 * scale, op


@pytest.mark.parametrize("family,R", [("bigbird", 8), ("window", 20)])
def test_fused_attention_matches_jax_pallas_and_oracle(family, R):
    rng = np.random.default_rng(R)
    base = (jax_masks.bigbird(160, 3, 2, 2) if family == "bigbird"
            else jax_masks.sliding_window(128, 5))
    S = _masked(base, rng)
    A = rng.standard_normal((S.M, R)).astype(np.float32)
    B = rng.standard_normal((S.N, R)).astype(np.float32)
    want, state = _jax_attention(S, R, A, B)
    cs = state_from_reference(S.rows, S.cols, S.vals, S.M, S.N, *state, device="cpu")
    out_a, p_a = oracle.fused_attention_a(cs.S, A, B)
    out_b, p_b = oracle.fused_attention_a(cs.S.transpose(), B, A)
    exact = {"outA": out_a, "probsA": p_a, "outB": out_b, "probsB": p_b}
    for kernel in (CudaTileKernel(device="cpu"), TorchKernel()):
        _, _, got = _port_attention(cs, R, kernel)
        _check(got, want)
        for op in exact:
            scale = 1.0 if op.startswith("probs") else float(np.abs(exact[op]).max())
            assert np.abs(got[op] - exact[op]).max() <= 1e-5 * scale, op
        assert np.all(got["outA"][DEAD_ROW] == 0)
        assert np.all(got["probsA"][S.rows == DEAD_ROW] == 0)


@pytest.mark.parametrize("kernel", [CudaTileKernel(device="cpu"), TorchKernel(),
                                    CudaTileKernel("bf16", device="cpu")],
                         ids=["tile", "flat", "tile-bf16"])
@pytest.mark.parametrize("fusion", [1, 2])
def test_fused_equals_unfused_bit_for_bit(kernel, fusion):
    rng = np.random.default_rng(5)
    S = _port_coo(_masked(jax_masks.bigbird(128, 3, 2, 2), rng))
    R = 8
    cs = state_from_reference(S.rows, S.cols, S.vals, S.M, S.N,
                              rng.standard_normal((S.M, R)),
                              rng.standard_normal((S.N, R)), S.vals, device="cpu")
    alg, (A, B, sv, st), _ = _port_attention(cs, R, kernel, fusion)
    for vals, mode in ((sv, MatMode.A), (st, MatMode.B)):
        out_f, p_f = alg.fused_attention(A, B, vals, mode)
        out_u, p_u = alg.attention_unfused(A, B, vals, mode)
        out_p, p_p = alg.attention_program(vals, mode)(A, B)
        assert torch.equal(out_f, out_u) and torch.equal(p_f, p_u)
        assert torch.equal(out_f, out_p) and torch.equal(p_f, p_p)
    calls = {k: v["calls"] for k, v in alg.metrics.items()}
    assert calls == {"fusedAttn": 4, "sddmmA": 1, "sddmmB": 1, "attnSoftmax": 2,
                     "spmmA": 1, "spmmB": 1}


def test_bf16_attention_within_1e2_of_f32():
    rng = np.random.default_rng(6)
    S = _port_coo(_masked(jax_masks.sliding_window(160, 4), rng))
    X = rng.standard_normal((S.M, 20)) / np.sqrt(20)
    cs = state_from_reference(S.rows, S.cols, S.vals, S.M, S.N, X, X, S.vals,
                              device="cpu")
    _, _, f32 = _port_attention(cs, 20, CudaTileKernel("f32", device="cpu"))
    _, _, bf16 = _port_attention(cs, 20, CudaTileKernel("bf16", device="cpu"))
    for op in f32:
        scale = float(np.abs(f32[op]).max())
        assert np.abs(bf16[op] - f32[op]).max() <= 1e-2 * scale, op


def test_softmax_tile_route_launches_one_pair_per_tile():
    """The tile route calls ``attn_stats_tile`` once per tile, merges,
    then ``attn_norm_tile`` once per tile (p = 1: one tile)."""
    S = masks.sliding_window(64, 2)
    calls = []

    class Recording(CudaTileKernel):
        def attn_stats_tile(self, tile, gate, logits):
            calls.append("stats")
            return super().attn_stats_tile(tile, gate, logits)

        def attn_norm_tile(self, tile, gate, logits, m, d):
            calls.append("norm")
            return super().attn_norm_tile(tile, gate, logits, m, d)

    alg = DenseShift15D(S, R=4, kernel=Recording(device="cpu"), device="cpu")
    alg.fused_attention(alg.dummy_initialize(MatMode.A),
                        alg.dummy_initialize(MatMode.B), alg.like_s_values(1.0))
    assert calls == ["stats", "norm"]


# --------------------------------------------------------------------- #
# (f) the harness and the capability gate
# --------------------------------------------------------------------- #


def test_make_algorithm_refuses_attention_where_not_capable():
    S = masks.sliding_window(64, 2)
    for name in ("15d_sparse", "25d_dense_replicate", "25d_sparse_replicate"):
        with pytest.raises(ValueError, match="fused attention"):
            harness.make_algorithm(name, S, R=8, attention=True, device="cpu")
    for name in harness.ATTENTION_CAPABLE:
        alg = harness.make_algorithm(name, S, R=8, attention=True, device="cpu")
        out, _ = alg.fused_attention(alg.dummy_initialize(MatMode.A),
                                     alg.dummy_initialize(MatMode.B),
                                     alg.like_s_values(1.0))
        assert torch.isfinite(out).all()


def test_base_fused_attention_raises_not_implemented():
    alg = DenseShift15D(masks.sliding_window(32, 2), R=4, device="cpu")
    A = alg.dummy_initialize(MatMode.A)
    with pytest.raises(NotImplementedError, match="denominator"):
        DistributedSparse.fused_attention(alg, A, A, alg.like_s_values(1.0))


def test_benchmark_record_carries_mask_and_counted_bytes():
    S = masks.from_spec("window:4", 128)
    rec = harness.benchmark_algorithm(S, "15d_fusion2", None, fused=True, R=8,
                                      app="attention", trials=2, warmup=1,
                                      mask="window:4", device="cpu")
    assert rec["app"] == "attention" and rec["mask"] == "window:4"
    hbm = rec["attention_hbm"]
    assert hbm["fused_bytes"] < hbm["unfused_bytes"] and hbm["savings_frac"] > 0
    assert rec["metrics"]["fusedAttn"]["calls"] == 2
    unfused = harness.benchmark_algorithm(S, "15d_fusion1", None, fused=False,
                                          R=8, app="attention", trials=1,
                                          mask="window:4", device="cpu")
    assert unfused["metrics"]["attnSoftmax"]["calls"] == 1
    assert unfused["attention_hbm"] == hbm
    vanilla = harness.benchmark_algorithm(S, "15d_fusion2", None, fused=True,
                                          R=8, trials=1, mask="window:4",
                                          device="cpu")
    assert vanilla["mask"] is None and "attention_hbm" not in vanilla


def test_benchmark_refuses_unported_and_unknown_apps():
    S = masks.sliding_window(32, 1)
    for app in ("gat", "als"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            harness.benchmark_algorithm(S, "15d_fusion2", None, True, 4, app=app,
                                        device="cpu")
    with pytest.raises(ValueError, match="unknown app"):
        harness.benchmark_algorithm(S, "15d_fusion2", None, True, 4, app="nope",
                                    device="cpu")
