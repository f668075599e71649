"""The port's ring loops and ablation wrappers (``parallel/loops.py``)
against the JAX package's: hop counts of the sequential and the overlapped
loop, with and without the final shift and on a ring of one; the
overlapped loop gives the sequential loop's bits; the ablated collectives
give the shapes the JAX package's do; and ``measure_breakdown`` reports
its regions and leaves the mode as it found it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_sddmm_tpu.parallel import loops as jax_loops

from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.parallel import loops
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.mesh import make_grid
from distributed_sddmm_tpu_torch.utils.coo import HostCOO


def _jax_hops(n, final, overlap):
    hops = []

    def shift(x):
        hops.append(1)
        return x

    if overlap:
        jax_loops.ring_loop_overlap(n, lambda s, c, m: c, 0, 0, shift,
                                    final_shift=final)
    else:
        jax_loops.ring_loop(n, lambda s, st: st, 0, shift,
                            shift_final=shift if final else None)
    return len(hops)


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_hop_counts_equal_jax(n, final):
    seq, ovl, steps = [], [], []

    def shift(state):
        seq.append(1)
        return state

    def start(mov):
        ovl.append(1)
        return lambda: mov

    loops.ring_loop(n, lambda s, st: steps.append(s) or st, 0, shift,
                    shift_final=shift if final else None)
    loops.ring_loop_overlap(n, lambda s, c, m: c, 0, 0, start, final_shift=final)
    want = n - 1 + (final and n > 1)
    assert len(seq) == len(ovl) == want
    assert len(seq) == _jax_hops(n, final, False) == _jax_hops(n, final, True)
    assert steps == list(range(n))


@pytest.mark.parametrize("final", [False, True])
def test_overlap_bit_equal_to_sequential_on_a_ring(final):
    """Five ranks each add the block they hold at every step; the moving
    blocks hop one rank a step through a ``LocalWorld`` comm."""
    rng = np.random.default_rng(0)
    comm = LocalWorld(5).comm(make_grid(5, 1, 1), "cpu")
    blocks = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
              for _ in range(5)]
    shift = loops.Shifter(comm, "rows", 5)

    def body(s, accs, movs):
        return [a * 1.5 + m for a, m in zip(accs, movs)]

    def step(s, state):
        return body(s, state[0], state[1]), state[1]

    def hop(state):
        return state[0], shift(state[1])

    zero = [torch.zeros(3, 4) for _ in range(5)]
    seq = loops.ring_loop(5, step, (zero, blocks), hop, hop if final else None)
    ovl = loops.ring_loop_overlap(5, body, zero, blocks, shift.start, final_shift=final)
    for a, b in zip(seq[0] + seq[1], ovl[0] + ovl[1]):
        assert torch.equal(a, b)
    # A complete rotation brings every block home, moving no tensor.
    assert all(a is b for a, b in zip(seq[1], blocks)) == final


@pytest.mark.parametrize("c", [1, 2, 4])
def test_ablated_collectives_have_the_jax_shapes(c):
    comm = LocalWorld(4).comm(make_grid(4 // c, c, 1), "cpu")
    xs = [torch.ones(6, 3) * h for h in range(4)]
    for mode in loops.ABLATION_MODES:
        with loops.ablation_mode(mode), jax_loops.ablation_mode(mode):
            gathered = loops.abl_all_gather(comm, xs, "cols", c)
            scattered = loops.abl_psum_scatter(comm, [torch.ones(6 * c, 3)] * 4, "cols", c)
            hopped = loops.abl_ppermute(comm, xs, "rows", loops.ring_perm(4 // c))()
            if mode == "local":  # the JAX wrappers run without a mesh here
                want_g = jax_loops.abl_all_gather(jnp.ones((6, 3)), "cols", axis=0, size=c)
                want_s = jax_loops.abl_psum_scatter(jnp.ones((6 * c, 3)), "cols",
                                                    scatter_dimension=0, size=c)
                assert tuple(gathered[0].shape) == want_g.shape
                assert tuple(scattered[0].shape) == want_s.shape
            assert all(tuple(g.shape) == (6 * c, 3) for g in gathered)
            assert all(tuple(s.shape) == (6, 3) for s in scattered)
            assert len(hopped) == 4 and all(tuple(h.shape) == (6, 3) for h in hopped)
            if mode != "full":
                assert hopped is xs
        assert loops.ablation() == "full"
    with pytest.raises(ValueError, match="unknown ablation mode"):
        with loops.ablation_mode("none"):
            pass


def test_ring_perm_equals_jax():
    for n in (1, 2, 7):
        assert loops.ring_perm(n) == jax_loops.ring_perm(n)


def test_measure_breakdown_reports_the_regions():
    S = HostCOO.rmat(6, 4)
    alg = DenseShift15D(S, 4, c=2, world=LocalWorld(4), device="cpu")
    A, B = alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B)
    out = alg.measure_breakdown(A, B, alg.like_s_values(1.0), trials=2)
    assert set(out) == {"fusedSpMM", "replication", "ppermute", "fusedSpMM_total"}
    assert all(v >= 0 for v in out.values()) and out["fusedSpMM_total"] > 0
    assert loops.ablation() == "full"
    assert alg.metrics["fusedSpMM"]["calls"] == 9
    with pytest.raises(ValueError, match="op must be one of"):
        alg.measure_breakdown(A, B, alg.like_s_values(1.0), op="spmmB")
