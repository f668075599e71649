"""The port's process grid (``parallel/mesh.py``) against the JAX
package's ``GridSpec``: the same flat rank of every coordinate and the same
coordinate of every rank for each adjacency, and ``self_test`` passing
through the comm layer's ``LocalWorld``."""

import pytest

import jax

from distributed_sddmm_tpu.parallel.mesh import make_grid as jax_make_grid

from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.mesh import make_grid

DIMS = [(2, 2, 2), (4, 2, 1), (8, 1, 1)]


@pytest.mark.parametrize("dims", DIMS, ids=["2x2x2", "4x2x1", "8x1x1"])
@pytest.mark.parametrize("adjacency", range(1, 7))
def test_rank_order_equals_jax(adjacency, dims):
    want = jax_make_grid(*dims, adjacency=adjacency, devices=jax.devices()[:8])
    got = make_grid(*dims, adjacency=adjacency)
    assert got.p == want.p == 8
    for i, j, k in got.coords():
        assert got.flat_rank(i, j, k) == want.flat_rank(i, j, k)
    for rank in range(8):
        assert got.grid_coords(rank) == want.grid_coords(rank)
        # The JAX mesh places flat device ``rank`` at its coordinate.
        assert want.mesh.devices[got.grid_coords(rank)] == jax.devices()[rank]
    assert got.self_test(LocalWorld(8).comm(got, "cpu"))


def test_self_test_catches_a_miswired_comm():
    grid = make_grid(4, 2, 1, adjacency=3)
    comm = LocalWorld(8).comm(grid, "cpu")
    comm.ranks = comm.ranks[::-1]
    assert not grid.self_test(comm)


def test_pretty_print_lists_every_rank():
    text = make_grid(2, 2, 1, adjacency=3).pretty_print()
    assert "adjacency 3, p=4" in text and "(i=1, j=0, k=0) -> rank 2" in text


@pytest.mark.parametrize("bad", [0, 7])
def test_bad_adjacency_raises_like_jax(bad):
    with pytest.raises(ValueError, match="adjacency must be 1..6"):
        make_grid(2, 2, 1, adjacency=bad)
    with pytest.raises(ValueError, match="adjacency must be 1..6"):
        jax_make_grid(2, 2, 1, adjacency=bad, devices=jax.devices()[:4])


def test_local_world_refuses_a_grid_of_another_size():
    with pytest.raises(ValueError, match="LocalWorld of 4"):
        LocalWorld(4).comm(make_grid(2, 1, 1), "cpu")
