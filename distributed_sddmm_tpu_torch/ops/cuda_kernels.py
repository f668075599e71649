"""Hand-written CUDA tile kernels and their plain PyTorch versions
(counterpart of ``ops/pallas_kernels.py``).

Three kernels in ``ops/csrc/tile_kernels.cu`` and two in
``ops/csrc/attn_kernels.cu``, each behind a wrapper here:

* :func:`sddmm_tile` replaces ``_tile_call(op="sddmm")``
  (``pallas_kernels.py:327``, ``_make_sddmm_body``):
  ``mid[k] = sv[k] * <A[r_k], B[c_k]>``.
* :func:`spmm_tile` replaces ``_tile_call(op="spmm")``
  (``pallas_kernels.py:341``, ``_make_spmm_body``):
  ``out[r] = sum_{k: r_k = r} sv[k] * B[c_k]``.
* :func:`fused_tile` replaces ``_tile_call(op="fused")``
  (``pallas_kernels.py:305``, ``_make_fused_body``): both in one pass that
  gathers each ``B[c_k]`` row once and keeps the output row in registers.
* :func:`attn_stats_tile` replaces ``_attn_call(op="attn_reduce")``
  (``pallas_kernels.py:419``, ``_make_attn_reduce_body``): the masked
  softmax's per-row max ``m`` and denominator ``d`` over one tile.
* :func:`attn_norm_tile` replaces ``_attn_call(op="attn_norm")``
  (``pallas_kernels.py:465``, ``_make_attn_norm_body``): the weights
  ``exp(z - m[r]) / d[r]`` from the merged row stats.

Bound on an H100: all three are memory-bound, two flops per gathered
element. The least traffic is the indices, values and ``mid`` (12 bytes a
nonzero), A and the output once and B once; with B too large for the
50 MB L2, every nonzero gathers a full B row from HBM instead, which is
what these row-owned kernels pay. Design: one warp per output row of the
tile's CSR, no atomics, fixed summation order (see the ``.cu`` header).
The two attention kernels move 8 and 16 bytes a slot and are f32 in both
precision modes (``attn_kernels.cu`` header).

Every wrapper takes the tile's CSR view (:class:`~distributed_sddmm_tpu_torch.
parallel.sharding.TileView`). On a CPU tensor it runs the plain version;
on a CUDA tensor it launches the kernel, adds one to its launch count and
raises if the launch fails — it never falls back. The plain versions
compute the same function with index gathers and ``index_add_``, with the
same bf16 rounding points, in segments that bound their memory.
"""

from __future__ import annotations

import torch

from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.ops import _build
from distributed_sddmm_tpu_torch.ops.kernels import (
    ATTN_STREAM_BUDGET, GATHER_BUDGET, attn_row_stats, attn_weights, segments,
)
from distributed_sddmm_tpu_torch.parallel.sharding import TileView

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {"sddmm_tile": 0, "spmm_tile": 0, "fused_tile": 0,
            "attn_stats_tile": 0, "attn_norm_tile": 0}

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------------ #
# Plain PyTorch versions
# ------------------------------------------------------------------ #


def sddmm_tile_plain(tile: TileView, sv, at, bt, budget: int = GATHER_BUDGET):
    """``mid = sv * rowwise_dot(at[rows], bt[cols])`` in float32."""
    mid = torch.empty(tile.cap, dtype=torch.float32, device=sv.device)
    for sl in segments(tile.cap, bt.shape[-1], budget):
        dots = torch.sum(
            at[tile.rows[sl]].float() * bt[tile.cols[sl]].float(), dim=-1
        )
        mid[sl] = dots * sv[sl]
    return mid


def spmm_tile_plain(tile: TileView, sv, bt, budget: int = GATHER_BUDGET):
    """``out[r] += round(bt[c] * sv)`` for every slot, float32 output;
    ``round`` is to bf16 when ``bt`` is bf16 (the TPU kernel's rounding
    point), else the identity."""
    out = torch.zeros(tile.n_rows, bt.shape[-1], dtype=torch.float32,
                      device=sv.device)
    for sl in segments(tile.cap, bt.shape[-1], budget):
        contrib = bt[tile.cols[sl]].float() * sv[sl, None]
        if bt.dtype == torch.bfloat16:
            contrib = contrib.bfloat16().float()
        out.index_add_(0, tile.rows[sl], contrib)
    return out


def fused_tile_plain(tile: TileView, sv, at, bt, budget: int = GATHER_BUDGET):
    """SDDMM, then SpMM weighted by its output: ``(out, mid)``."""
    mid = sddmm_tile_plain(tile, sv, at, bt, budget)
    return spmm_tile_plain(tile, mid, bt, budget), mid


def attn_stats_tile_plain(tile: TileView, gate, logits,
                          budget: int = ATTN_STREAM_BUDGET):
    """Per-row masked max and sum-of-exp ``(m [n_rows], d [n_rows])``
    over the tile's slots; ``(ATTN_NEG, 0)`` for rows with none."""
    return attn_row_stats(tile.rows, gate, logits, tile.n_rows, budget)


def attn_norm_tile_plain(tile: TileView, gate, logits, m, d):
    """``p [cap]``: ``exp(z - m[r]) / d[r]``, exactly 0 at masked and pad
    slots and in rows with ``d == 0``."""
    return attn_weights(tile.rows, gate, logits, m, d)


# ------------------------------------------------------------------ #
# Kernel wrappers
# ------------------------------------------------------------------ #


def _on_card(dev, *tensors) -> None:
    """``dev`` is a CUDA device and every tensor lies on it, contiguous."""
    if dev.type != "cuda":
        raise ValueError(f"tile kernels run on CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("tile kernel operands must be contiguous")


def _check(tile: TileView, sv, at, bt) -> tuple[bool, bool]:
    """Validate what the kernel takes; returns ``(bf16, vec)``."""
    dense = [t for t in (at, bt) if t is not None]
    index = (tile.row_ptr, tile.cols)
    _on_card(sv.device, *dense, *index)
    if sv.dtype != torch.float32 or sv.shape != (tile.cap,) or not sv.is_contiguous():
        raise ValueError(f"values must be contiguous float32 [{tile.cap}]")
    if any(t.dtype != torch.int32 for t in index):
        raise ValueError("row_ptr and cols must be int32")
    if tile.row_ptr.shape != (tile.n_rows + 1,) or tile.cols.shape != (tile.cap,):
        raise ValueError("tile CSR arrays do not match its frame")
    R = bt.shape[-1]
    if bt.dtype not in _DTYPES.values() or any(t.dtype != bt.dtype for t in dense):
        raise ValueError("dense operands must share float32 or bfloat16")
    if any(t.dim() != 2 or t.shape[1] != R for t in dense) or R < 1:
        raise ValueError("dense operands must be [rows, R] with one R >= 1")
    if bt.shape[0] < tile.n_cols or (at is not None and at.shape[0] < tile.n_rows):
        raise ValueError("dense operands are shorter than the tile frame")
    if tile.cap >= 2**31 or tile.n_rows >= 2**31 - 1:
        raise ValueError("tile too large for 32-bit slot indices")
    vec = R % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in dense)
    return bt.dtype == torch.bfloat16, vec


def _check_attn(tile: TileView, gate, logits, m=None, d=None) -> None:
    """Validate what the attention kernels take."""
    slots = (gate, logits)
    stats = tuple(t for t in (m, d) if t is not None)
    index = (tile.row_ptr, tile.rows)
    _on_card(gate.device, *slots, *stats, *index)
    if any(t.dtype != torch.float32 or t.shape != (tile.cap,) for t in slots):
        raise ValueError(f"gate and logits must be float32 [{tile.cap}]")
    if any(t.dtype != torch.float32 or t.shape != (tile.n_rows,) for t in stats):
        raise ValueError(f"row stats must be float32 [{tile.n_rows}]")
    if any(t.dtype != torch.int32 for t in index):
        raise ValueError("row_ptr and rows must be int32")
    if tile.row_ptr.shape != (tile.n_rows + 1,):
        raise ValueError("tile CSR arrays do not match its frame")
    if tile.cap >= 2**31 or tile.n_rows >= 2**31 - 1:
        raise ValueError("tile too large for 32-bit slot indices")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.tile_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def sddmm_tile(tile: TileView, sv, at, bt):
    """``mid [cap]`` float32; 0 at pad slots."""
    if sv.device.type == "cpu":
        return sddmm_tile_plain(tile, sv, at, bt)
    bf16, vec = _check(tile, sv, at, bt)
    lib = _build.load()
    mid = torch.empty(tile.cap, dtype=torch.float32, device=sv.device)
    rc = lib.sddmm_tile(
        tile.row_ptr.data_ptr(), tile.cols.data_ptr(), sv.data_ptr(),
        at.data_ptr(), bt.data_ptr(), mid.data_ptr(), tile.n_rows, tile.cap,
        bt.shape[1], int(bf16), int(vec), _stream(sv.device),
    )
    _raise_on(lib, rc, "sddmm_tile")
    LAUNCHES["sddmm_tile"] += 1
    return mid


def spmm_tile(tile: TileView, sv, bt):
    """``out [n_rows, R]`` float32."""
    if sv.device.type == "cpu":
        return spmm_tile_plain(tile, sv, bt)
    bf16, vec = _check(tile, sv, None, bt)
    lib = _build.load()
    out = torch.empty(tile.n_rows, bt.shape[1], dtype=torch.float32,
                      device=sv.device)
    rc = lib.spmm_tile(
        tile.row_ptr.data_ptr(), tile.cols.data_ptr(), sv.data_ptr(),
        bt.data_ptr(), out.data_ptr(), tile.n_rows, bt.shape[1], int(bf16),
        int(vec), _stream(sv.device),
    )
    _raise_on(lib, rc, "spmm_tile")
    LAUNCHES["spmm_tile"] += 1
    return out


def fused_tile(tile: TileView, sv, at, bt):
    """``(out [n_rows, R], mid [cap])``, both float32."""
    if sv.device.type == "cpu":
        return fused_tile_plain(tile, sv, at, bt)
    bf16, vec = _check(tile, sv, at, bt)
    lib = _build.load()
    out = torch.empty(tile.n_rows, bt.shape[1], dtype=torch.float32,
                      device=sv.device)
    mid = torch.empty(tile.cap, dtype=torch.float32, device=sv.device)
    rc = lib.fused_tile(
        tile.row_ptr.data_ptr(), tile.cols.data_ptr(), sv.data_ptr(),
        at.data_ptr(), bt.data_ptr(), out.data_ptr(), mid.data_ptr(),
        tile.n_rows, tile.cap, bt.shape[1], int(bf16), int(vec),
        _stream(sv.device),
    )
    _raise_on(lib, rc, "fused_tile")
    LAUNCHES["fused_tile"] += 1
    return out, mid


def attn_stats_tile(tile: TileView, gate, logits):
    """``(m [n_rows], d [n_rows])`` float32: partial row stats of one tile,
    to merge with :func:`~distributed_sddmm_tpu_torch.ops.kernels.attn_merge_stats`."""
    if gate.device.type == "cpu":
        return attn_stats_tile_plain(tile, gate, logits)
    _check_attn(tile, gate, logits)
    lib = _build.load()
    m = torch.empty(tile.n_rows, dtype=torch.float32, device=gate.device)
    d = torch.empty_like(m)
    rc = lib.attn_stats_tile(
        tile.row_ptr.data_ptr(), gate.data_ptr(), logits.data_ptr(),
        m.data_ptr(), d.data_ptr(), tile.n_rows, _stream(gate.device),
    )
    _raise_on(lib, rc, "attn_stats_tile")
    LAUNCHES["attn_stats_tile"] += 1
    return m, d


def attn_norm_tile(tile: TileView, gate, logits, m, d):
    """``p [cap]`` float32 from the merged row stats; 0 at pad slots."""
    if gate.device.type == "cpu":
        return attn_norm_tile_plain(tile, gate, logits, m, d)
    _check_attn(tile, gate, logits, m, d)
    lib = _build.load()
    p = torch.empty(tile.cap, dtype=torch.float32, device=gate.device)
    rc = lib.attn_norm_tile(
        tile.rows.data_ptr(), gate.data_ptr(), logits.data_ptr(),
        m.data_ptr(), d.data_ptr(), p.data_ptr(), tile.cap,
        _stream(gate.device),
    )
    _raise_on(lib, rc, "attn_norm_tile")
    LAUNCHES["attn_norm_tile"] += 1
    return p


class CudaTileKernel:
    """The tile kernels behind the strategies' tile protocol (the
    counterpart of ``PallasKernel``'s tile entry points).

    ``precision``: ``"f32"``, or ``"bf16"`` where the dense operands are
    rounded to bf16, scatter contributions round to bf16 and every sum
    stays float32. Default: bf16 on CUDA, f32 on the CPU. The attention
    kernels are float32 in both modes.
    """

    is_tiled = True

    def __init__(self, precision: str | None = None, device=None):
        self.device = resolve_device(device)
        if precision is None:
            precision = "bf16" if self.device.type == "cuda" else "f32"
        if precision not in _DTYPES:
            raise ValueError(f"precision must be 'bf16' or 'f32', got {precision!r}")
        self.precision = precision
        self.name = f"cuda-{precision}"

    def prep(self, X: torch.Tensor) -> torch.Tensor:
        """Dense operand in the kernels' type, row-major and contiguous."""
        return X.to(_DTYPES[self.precision]).contiguous()

    def sddmm_tile(self, tile: TileView, vals, at, bt):
        return sddmm_tile(tile, vals, at, bt)

    def spmm_tile(self, tile: TileView, vals, bt):
        return spmm_tile(tile, vals, bt)

    def fused_tile(self, tile: TileView, vals, at, bt):
        return fused_tile(tile, vals, at, bt)

    def attn_stats_tile(self, tile: TileView, gate, logits):
        return attn_stats_tile(tile, gate, logits)

    def attn_norm_tile(self, tile: TileView, gate, logits, m, d):
        return attn_norm_tile(tile, gate, logits, m, d)
