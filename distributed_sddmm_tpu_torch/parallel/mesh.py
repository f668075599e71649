"""3-D process grid with adjacency (rank-ordering) control (counterpart of
``parallel/mesh.py``).

A grid ``nr x nc x nh`` names its axes ``rows``, ``cols`` and ``layers``;
every collective of ``parallel/comm.py`` runs over one axis or a tuple of
axes. ``adjacency`` (1..6) selects which grid axis varies fastest in flat
rank order, so which ranks are neighbours in the process numbering (the
ranks of one host, or of one NVLink island). :class:`GridSpec` is pure
geometry: the ranks themselves belong to a world (``parallel/comm.py``),
which binds a grid with :meth:`~distributed_sddmm_tpu_torch.parallel.comm.
LocalWorld.comm`.
"""

from __future__ import annotations

import dataclasses

ROWS, COLS, LAYERS = "rows", "cols", "layers"
AXES = (ROWS, COLS, LAYERS)

# adjacency -> permutation, most-adjacent grid axis first (0 = i/rows,
# 1 = j/cols, 2 = k/layers).
_ADJACENCY_PERMUTATIONS = {
    1: (0, 1, 2),  # crf
    2: (0, 2, 1),  # cfr
    3: (1, 0, 2),  # rcf
    4: (1, 2, 0),  # rfc
    5: (2, 0, 1),  # fcr
    6: (2, 1, 0),  # frc
}


def _flat_rank(adjacency: int, dims: tuple, i: int, j: int, k: int) -> int:
    """Grid coordinate -> flat rank."""
    perm = _ADJACENCY_PERMUTATIONS[adjacency]
    coord = (i, j, k)
    rank = coord[perm[0]]
    rank += coord[perm[1]] * dims[perm[0]]
    rank += coord[perm[2]] * dims[perm[0]] * dims[perm[1]]
    return rank


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """An ``nr x nc x nh`` grid and its rank ordering."""

    nr: int
    nc: int
    nh: int
    adjacency: int

    @property
    def p(self) -> int:
        return self.nr * self.nc * self.nh

    @property
    def dims(self) -> tuple:
        return (self.nr, self.nc, self.nh)

    def flat_rank(self, i: int, j: int, k: int) -> int:
        return _flat_rank(self.adjacency, self.dims, i, j, k)

    def grid_coords(self, rank: int) -> tuple[int, int, int]:
        """Flat rank -> grid coordinate."""
        perm = _ADJACENCY_PERMUTATIONS[self.adjacency]
        dims = self.dims
        coord = [0, 0, 0]
        coord[perm[0]] = rank % dims[perm[0]]
        coord[perm[1]] = (rank // dims[perm[0]]) % dims[perm[1]]
        coord[perm[2]] = (rank // (dims[perm[0]] * dims[perm[1]])) % dims[perm[2]]
        return tuple(coord)

    def coords(self) -> list[tuple[int, int, int]]:
        """Every grid coordinate in row-major ``(i, j, k)`` order: the
        order of the dense blocks and the tile slots."""
        return [(i, j, k) for i in range(self.nr) for j in range(self.nc)
                for k in range(self.nh)]

    def pretty_print(self) -> str:
        """Human-readable coordinate -> rank map."""
        lines = [
            f"GridSpec {self.nr}x{self.nc}x{self.nh} "
            f"(rows x cols x layers), adjacency {self.adjacency}, p={self.p}"
        ]
        for i, j, k in self.coords():
            lines.append(f"  (i={i}, j={j}, k={k}) -> rank {self.flat_rank(i, j, k)}")
        return "\n".join(lines)

    def self_test(self, comm) -> bool:
        """Collective sanity check of the grid wiring through ``comm`` (a
        world bound to this grid): the host round trip first; then every
        rank the comm holds reports its ``(i, j, k)`` (its position among
        the flat ranks all-gathered over each axis) and the size of each
        axis "world" (rows, cols, layers and the three axis pairs, by an
        all-reduce sum of ones). The result must reproduce the host-side
        coordinate math exactly."""
        import torch

        for i, j, k in self.coords():
            if self.grid_coords(self.flat_rank(i, j, k)) != (i, j, k):
                return False
        mine = [torch.tensor([r], dtype=torch.int32, device=comm.device)
                for r in comm.ranks]
        gathered = [comm.all_gather(mine, axis) for axis in AXES]
        ones = [torch.ones(1, dtype=torch.int32, device=comm.device)
                for _ in comm.ranks]
        pairs = ((ROWS, COLS), (ROWS, LAYERS), (COLS, LAYERS))
        sizes = [comm.all_reduce(ones, axis, "sum") for axis in AXES + pairs]
        want_sizes = (self.nr, self.nc, self.nh, self.nr * self.nc,
                      self.nr * self.nh, self.nc * self.nh)
        for h, rank in enumerate(comm.ranks):
            got = tuple(g[h].tolist().index(rank) for g in gathered)
            got_sizes = tuple(int(s[h]) for s in sizes)
            if (got != comm.coords[h] or got != self.grid_coords(rank)
                    or got_sizes != want_sizes):
                return False
        return True


def make_grid(nr: int, nc: int, nh: int = 1, adjacency: int = 3) -> GridSpec:
    """An ``nr x nc x nh`` grid; adjacency in 1..6."""
    if adjacency not in _ADJACENCY_PERMUTATIONS:
        raise ValueError(f"adjacency must be 1..6, got {adjacency}")
    if min(nr, nc, nh) < 1:
        raise ValueError(f"grid dims must be positive, got {nr}x{nc}x{nh}")
    return GridSpec(nr=nr, nc=nc, nh=nh, adjacency=adjacency)
