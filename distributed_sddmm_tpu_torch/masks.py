"""Structured attention masks as unit-valued ``HostCOO`` patterns
(counterpart of ``masks.py``).

SDDMM, a row-wise masked softmax and SpMM are block-sparse attention, and
the mask is the sparse matrix: ``vals == 1`` at attended positions, the
``gate != 0`` indicator the softmax kernels read. Three families:

* :func:`sliding_window` -- each token attends to its +-w neighbourhood;
* :func:`bigbird` -- sliding window, global tokens (full rows and
  columns) and seeded random links;
* :func:`graph_mask` -- the pattern of an existing sparse matrix.

:func:`from_spec` parses the ``--mask`` grammar (``window:8``,
``bigbird:w=8,g=2,r=2``, ``graph``) with the JAX package's errors;
:func:`parse_dynamic_spec` and :func:`format_dynamic_spec` the
request-time dynamic specs (``window:<w>`` narrowing, ``topk:<k>``) a
dynamic-mask workload resolves per request.

numpy and the port's ``HostCOO`` only: the same arguments give the same
arrays as the JAX package's generators.
"""

from __future__ import annotations

import numpy as np

from distributed_sddmm_tpu_torch.utils.coo import HostCOO


def _dedup(rows: np.ndarray, cols: np.ndarray, n: int) -> HostCOO:
    key = np.unique(rows.astype(np.int64) * n + cols.astype(np.int64))
    return HostCOO(rows=key // n, cols=key % n, vals=np.ones(key.size), M=n, N=n)


def sliding_window(n: int, window: int = 8) -> HostCOO:
    """Row ``i`` attends to columns ``[i-window, i+window]`` clipped at the
    edges, diagonal included: ``2*window+1`` nonzeros in interior rows."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    offs = np.arange(-window, window + 1, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), offs.size)
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    return HostCOO(rows=rows[keep], cols=cols[keep],
                   vals=np.ones(int(keep.sum())), M=n, N=n)


def bigbird(n: int, window: int = 8, n_global: int = 2, n_random: int = 2,
            seed: int = 0) -> HostCOO:
    """Sliding window, ``n_global`` global tokens (their full rows and
    columns) and ``n_random`` seeded random columns per row; the
    deduplicated union, deterministic for a seed."""
    base = sliding_window(n, window)
    parts_r, parts_c = [base.rows], [base.cols]
    if n_global:
        g = np.arange(min(n_global, n), dtype=np.int64)
        full = np.arange(n, dtype=np.int64)
        parts_r += [np.repeat(g, n), np.repeat(full, g.size)]
        parts_c += [np.tile(full, g.size), np.tile(g, n)]
    if n_random:
        rng = np.random.default_rng(seed)
        parts_r.append(np.repeat(np.arange(n, dtype=np.int64), n_random))
        parts_c.append(rng.integers(0, n, size=n * n_random).astype(np.int64))
    return _dedup(np.concatenate(parts_r), np.concatenate(parts_c), n)


def graph_mask(S: HostCOO) -> HostCOO:
    """Attention mask from an existing sparse pattern (attend over graph
    edges). Unit values; duplicate edges collapse."""
    return _dedup(S.rows, S.cols, max(S.M, S.N))


def from_spec(spec: str, n: int, graph: HostCOO | None = None,
              seed: int = 0) -> HostCOO:
    """One ``--mask`` spec as a mask matrix over ``n`` tokens:
    ``window:<w>``, ``bigbird:w=<w>,g=<g>,r=<r>`` (keys optional, default
    ``w=8,g=2,r=2``) or ``graph`` (the pattern of ``graph``, required)."""
    fam, _, rest = spec.partition(":")
    if fam == "window":
        return sliding_window(n, _int_param(spec, "window", rest, "w", 8))
    if fam == "bigbird":
        kw = {"w": 8, "g": 2, "r": 2}
        for part in filter(None, rest.split(",")):
            k, _, v = part.partition("=")
            if k not in kw:
                raise ValueError(f"unknown bigbird key {k!r} in mask spec {spec!r}")
            kw[k] = int(v)
        return bigbird(n, window=kw["w"], n_global=kw["g"], n_random=kw["r"],
                       seed=seed)
    if fam == "graph":
        if graph is None:
            raise ValueError("mask spec 'graph' needs a source matrix")
        return graph_mask(graph)
    if fam == "topk":
        raise ValueError(
            f"mask spec {spec!r} is request-time dynamic (the kept "
            "positions depend on the computed scores) — it has no static "
            "mask matrix; serve it through a dynamic-mask workload "
            "(parse_dynamic_spec)"
        )
    raise ValueError(
        f"unknown mask spec {spec!r}; expected window:<w>, "
        "bigbird:w=..,g=..,r=.., graph, or topk:<k>"
    )


def _int_param(spec: str, fam: str, rest: str, key: str, default) -> int:
    """One strict integer parameter, ``fam:<v>`` or ``fam:key=<v>``;
    unknown keys and non-integers raise."""
    rest = rest.strip()
    if not rest:
        if default is None:
            raise ValueError(
                f"mask spec {spec!r} needs a value "
                f"({fam}:<{key}> or {fam}:{key}=<{key}>)"
            )
        return int(default)
    if "=" in rest:
        k, _, v = rest.partition("=")
        if k != key:
            raise ValueError(f"unknown {fam} key {k!r} in mask spec {spec!r}")
        rest = v
    try:
        return int(rest)
    except ValueError:
        raise ValueError(
            f"mask spec {spec!r}: {key} must be an integer, got {rest!r}"
        ) from None


# --------------------------------------------------------------------- #
# Request-time dynamic mask specs
# --------------------------------------------------------------------- #

#: The families a dynamic-mask workload resolves per request: window
#: narrowing and score top-k. Both are run-time inputs of a capacity-sized
#: structure, never part of the structure itself.
DYNAMIC_FAMILIES = ("window", "topk")


def parse_dynamic_spec(spec: str, w_max: int | None = None,
                       k_max: int | None = None) -> tuple[str, int]:
    """One per-request dynamic mask spec as ``(kind, param)``.

    ``window:<w>`` / ``window:w=<w>`` attends to the +-w neighbourhood
    (``w >= 0``); ``topk:<k>`` / ``topk:k=<k>`` keeps the k highest-scoring
    positions within capacity (``k >= 1``; ties at the threshold all
    kept). ``w_max`` / ``k_max`` bound the parameter to the serving
    structure's capacity: a request may narrow its mask, never widen it."""
    fam, _, rest = spec.partition(":")
    if fam == "window":
        w = _int_param(spec, "window", rest, "w", None)
        if w < 0:
            raise ValueError(f"mask spec {spec!r}: w must be >= 0")
        if w_max is not None and w > w_max:
            raise ValueError(
                f"mask spec {spec!r}: w exceeds the serving capacity w_max={w_max}")
        return "window", w
    if fam == "topk":
        k = _int_param(spec, "topk", rest, "k", None)
        if k < 1:
            raise ValueError(f"mask spec {spec!r}: k must be >= 1")
        if k_max is not None and k > k_max:
            raise ValueError(
                f"mask spec {spec!r}: k exceeds the serving capacity k_max={k_max}")
        return "topk", k
    raise ValueError(
        f"unknown dynamic mask spec {spec!r}; expected one of "
        f"{[f + ':<n>' for f in DYNAMIC_FAMILIES]}"
    )


def format_dynamic_spec(kind: str, param: int) -> str:
    """The printable form of a dynamic mask, which round-trips through
    :func:`parse_dynamic_spec`."""
    if kind not in DYNAMIC_FAMILIES:
        raise ValueError(
            f"unknown dynamic mask kind {kind!r}; expected one of {DYNAMIC_FAMILIES}")
    return f"{kind}:{int(param)}"
