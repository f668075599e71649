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
what these row-owned kernels pay. Design: one group of lanes per output
row of the tile's CSR, no atomics, fixed summation order (see the header
of ``tile_common.cuh``). The two attention kernels move 8 and 16 bytes a
slot and are f32 in both precision modes (``attn_kernels.cu`` header).

The banked launches of ``codegen/kernel.py::BankedCudaKernel`` (the
counterpart of ``BankedPallasKernel``, ``codegen/kernel.py:110-197``) run
per row band (``codegen/banded.py``), each wrapper writing its band's
part of one output:

* :func:`sddmm_rows`, :func:`spmm_rows`, :func:`fused_rows` and
  :func:`attn_stats_rows` -- the short and mid bands: the same kernels
  with the band's row list (``tile_kernels.cu``, ``attn_kernels.cu``).
* :func:`sddmm_split`, :func:`spmm_split`, :func:`fused_split` -- pass 1
  of the heavy band, one lane group per segment of at most ``split`` slots:
  ``mid`` at the segment's slots, the partial output rows into a
  ``[n_seg, R]`` f32 workspace (``banked_kernels.cu``).
* :func:`split_reduce` -- pass 2: each heavy row's partials summed into
  its output row, a long row's segments spread over warps and blocks by
  the band's unit table (``codegen/banded.py::reduce_units``).
* :func:`attn_stats_split` and :func:`attn_stats_merge` -- the heavy
  band's per-segment softmax stats and their merge per row by the
  :func:`~distributed_sddmm_tpu_torch.ops.kernels.attn_merge_stats` rule,
  over the same units.

Every wrapper takes the tile's CSR view (:class:`~distributed_sddmm_tpu_torch.
parallel.sharding.TileView`). On a CPU tensor it runs the plain version;
on a CUDA tensor it launches the kernel, adds one to its launch count and
raises if the launch fails — it never falls back. The plain versions
compute the same function with index gathers and ``index_add_``, with the
same bf16 rounding points, in segments that bound their memory. The band
wrappers allocate only a split's workspace and pass 2's chunk partials
(PyTorch's caching allocator, on the current stream); the caller
allocates the output they share. Pass 2's per-row counters live in the
band (``RowBand.counters``, zero), and its kernels leave them at zero.
"""

from __future__ import annotations

import torch

from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.ops import _build
from distributed_sddmm_tpu_torch.ops.kernels import (
    ATTN_NEG, ATTN_STREAM_BUDGET, GATHER_BUDGET, attn_row_stats, attn_weights,
    segments,
)
from distributed_sddmm_tpu_torch.parallel.sharding import TileView

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {"sddmm_tile": 0, "spmm_tile": 0, "fused_tile": 0,
            "attn_stats_tile": 0, "attn_norm_tile": 0,
            "sddmm_rows": 0, "spmm_rows": 0, "fused_rows": 0,
            "attn_stats_rows": 0, "sddmm_split": 0, "spmm_split": 0,
            "fused_split": 0, "split_reduce": 0, "attn_stats_split": 0,
            "attn_stats_merge": 0}
#: Of those, the launches whose dense operands were bf16 (the attention
#: kernels and the split's reduce read float32 only).
BF16_LAUNCHES = dict.fromkeys(LAUNCHES, 0)

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def launch_counts(precision: str | None = None) -> dict:
    """Launches per wrapper: all of them, or those on ``"f32"`` or
    ``"bf16"`` dense operands."""
    if precision not in (None, "f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    if precision is None:
        return dict(LAUNCHES)
    if precision == "bf16":
        return dict(BF16_LAUNCHES)
    return {name: n - BF16_LAUNCHES[name] for name, n in LAUNCHES.items()}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = BF16_LAUNCHES[name] = 0


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


def _ranges(beg, end):
    """The slots of the ranges ``[beg[i], end[i])``, in order, and the
    range index of each (int64)."""
    beg, end = beg.long(), end.long()
    lens = end - beg
    owner = torch.repeat_interleave(torch.arange(beg.numel(), device=beg.device), lens)
    first = torch.cumsum(lens, 0) - lens
    slots = beg[owner] + torch.arange(owner.numel(), device=beg.device) - first[owner]
    return slots, owner


def _row_ranges(tile: TileView, band):
    rows = band.rows.long()
    return _ranges(tile.row_ptr[rows], tile.row_ptr[rows + 1])


def _seg_ranges(band):
    return _ranges(band.seg_beg, band.seg_end)


def _zero_pads(tile: TileView, mid) -> None:
    mid[int(tile.row_ptr[tile.n_rows]):] = 0


def _sddmm_slots(tile: TileView, slots, sv, at, bt, mid, budget: int) -> None:
    """``mid[slots] = sv * rowwise_dot(at[rows], bt[cols])``, as
    :func:`sddmm_tile_plain` computes each slot."""
    for sl in segments(slots.numel(), bt.shape[-1], budget):
        k = slots[sl]
        dots = torch.sum(at[tile.rows[k]].float() * bt[tile.cols[k]].float(), dim=-1)
        mid[k] = dots * sv[k]


def _spmm_slots(tile: TileView, slots, owner, n_out: int, sv, bt, budget: int):
    """``acc[owner[i]] += round(bt[cols[slots[i]]] * sv[slots[i]])`` in slot
    order into a zero ``[n_out, R]`` float32 accumulator."""
    acc = torch.zeros(n_out, bt.shape[-1], dtype=torch.float32, device=sv.device)
    for sl in segments(slots.numel(), bt.shape[-1], budget):
        k = slots[sl]
        contrib = bt[tile.cols[k]].float() * sv[k, None]
        if bt.dtype == torch.bfloat16:
            contrib = contrib.bfloat16().float()
        acc.index_add_(0, owner[sl], contrib)
    return acc


def sddmm_rows_plain(tile: TileView, band, sv, at, bt, mid, zero_pads: bool,
                     budget: int = GATHER_BUDGET) -> None:
    """Write ``mid`` at the slots of the band's rows (and 0 at the pads
    with ``zero_pads``)."""
    if zero_pads:
        _zero_pads(tile, mid)
    _sddmm_slots(tile, _row_ranges(tile, band)[0], sv, at, bt, mid, budget)


def spmm_rows_plain(tile: TileView, band, sv, bt, out,
                    budget: int = GATHER_BUDGET) -> None:
    """Write the output rows of the band's rows."""
    slots, owner = _row_ranges(tile, band)
    out[band.rows.long()] = _spmm_slots(tile, slots, owner, band.n_rows, sv, bt, budget)


def fused_rows_plain(tile: TileView, band, sv, at, bt, out, mid, zero_pads: bool,
                     budget: int = GATHER_BUDGET) -> None:
    sddmm_rows_plain(tile, band, sv, at, bt, mid, zero_pads, budget)
    spmm_rows_plain(tile, band, mid, bt, out, budget)


def sddmm_split_plain(tile: TileView, band, sv, at, bt, mid, zero_pads: bool,
                      budget: int = GATHER_BUDGET) -> None:
    """Write ``mid`` at the slots of the heavy band's segments."""
    if zero_pads:
        _zero_pads(tile, mid)
    _sddmm_slots(tile, _seg_ranges(band)[0], sv, at, bt, mid, budget)


def spmm_split_plain(tile: TileView, band, sv, bt, budget: int = GATHER_BUDGET):
    """``work [n_seg, R]`` float32: each segment's partial output row, by a
    per-segment ``index_add_``."""
    slots, owner = _seg_ranges(band)
    return _spmm_slots(tile, slots, owner, band.n_seg, sv, bt, budget)


def fused_split_plain(tile: TileView, band, sv, at, bt, mid, zero_pads: bool,
                      budget: int = GATHER_BUDGET):
    sddmm_split_plain(tile, band, sv, at, bt, mid, zero_pads, budget)
    return spmm_split_plain(tile, band, mid, bt, budget)


def _seg_owner(band):
    return torch.repeat_interleave(torch.arange(band.n_rows, device=band.rows.device),
                                   torch.diff(band.seg_ptr.long()))


def split_reduce_plain(band, work, out) -> None:
    """Write each heavy row's output row: its segments' partial rows summed
    in segment order (0 for a row with none)."""
    acc = torch.zeros(band.n_rows, work.shape[-1], dtype=torch.float32,
                      device=work.device)
    out[band.rows.long()] = acc.index_add_(0, _seg_owner(band), work)


def attn_stats_rows_plain(tile: TileView, band, gate, logits, m, d,
                          budget: int = ATTN_STREAM_BUDGET) -> None:
    """Write the row stats of the band's rows."""
    slots, owner = _row_ranges(tile, band)
    rows = band.rows.long()
    m[rows], d[rows] = attn_row_stats(owner, gate[slots], logits[slots],
                                      band.n_rows, budget)


def attn_stats_split_plain(tile: TileView, band, gate, logits,
                           budget: int = ATTN_STREAM_BUDGET):
    """Per-segment stats ``(wm [n_seg], wd [n_seg])``."""
    slots, owner = _seg_ranges(band)
    return attn_row_stats(owner, gate[slots], logits[slots], band.n_seg, budget)


def attn_stats_merge_plain(band, wm, wd, m, d) -> None:
    """Write each heavy row's stats, its segments' pairs merged by the
    ``attn_merge_stats`` rule; ``(ATTN_NEG, 0)`` for a row with none."""
    owner = _seg_owner(band)
    rm = torch.full((band.n_rows,), ATTN_NEG, dtype=torch.float32, device=wm.device)
    rm = rm.scatter_reduce(0, owner, wm, "amax", include_self=True)
    rd = torch.zeros_like(rm).index_add_(0, owner, wd * torch.exp(wm - rm[owner]))
    rows = band.rows.long()
    m[rows], d[rows] = rm, rd


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


def _check_band(tile: TileView, band, dev) -> None:
    """Validate a band's arrays against its tile."""
    arrays = [band.rows]
    if band.heavy:
        arrays += [band.seg_ptr, band.seg_row, band.seg_beg, band.seg_end]
    _on_card(dev, *arrays)
    if any(a.dtype != torch.int32 or a.dim() != 1 for a in arrays):
        raise ValueError("band arrays must be int32 vectors")
    if band.n_rows > tile.n_rows:
        raise ValueError("band has more rows than its tile")
    if band.heavy and (band.seg_ptr.shape != (band.n_rows + 1,)
                       or not (band.seg_row.shape == band.seg_beg.shape
                               == band.seg_end.shape)):
        raise ValueError("band segment table does not match its rows")


def _check_out(t, shape: tuple, dev) -> None:
    """An output the caller allocated: float32, contiguous, on ``dev``."""
    _on_card(dev, t)
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"output must be float32 {list(shape)}")


def _launch(name: str, fn, *args, bf16: bool = False) -> None:
    lib = _build.load()
    _raise_on(lib, getattr(lib, fn)(*args), name)
    LAUNCHES[name] += 1
    BF16_LAUNCHES[name] += bf16


def _ptr(t) -> int:
    return t.data_ptr()


def sddmm_tile(tile: TileView, sv, at, bt):
    """``mid [cap]`` float32; 0 at pad slots."""
    if sv.device.type == "cpu":
        return sddmm_tile_plain(tile, sv, at, bt)
    bf16, vec = _check(tile, sv, at, bt)
    mid = torch.empty(tile.cap, dtype=torch.float32, device=sv.device)
    _launch("sddmm_tile", "sddmm_tile",
            _ptr(tile.row_ptr), None, _ptr(tile.cols), _ptr(sv), _ptr(at), _ptr(bt),
            _ptr(mid), tile.n_rows, tile.n_rows, tile.cap, 1, bt.shape[1], int(bf16),
            int(vec), _stream(sv.device), bf16=bf16)
    return mid


def spmm_tile(tile: TileView, sv, bt):
    """``out [n_rows, R]`` float32."""
    if sv.device.type == "cpu":
        return spmm_tile_plain(tile, sv, bt)
    bf16, vec = _check(tile, sv, None, bt)
    out = torch.empty(tile.n_rows, bt.shape[1], dtype=torch.float32,
                      device=sv.device)
    _launch("spmm_tile", "spmm_tile",
            _ptr(tile.row_ptr), None, _ptr(tile.cols), _ptr(sv), _ptr(bt), _ptr(out),
            tile.n_rows, bt.shape[1], int(bf16), int(vec), _stream(sv.device), bf16=bf16)
    return out


def fused_tile(tile: TileView, sv, at, bt):
    """``(out [n_rows, R], mid [cap])``, both float32."""
    if sv.device.type == "cpu":
        return fused_tile_plain(tile, sv, at, bt)
    bf16, vec = _check(tile, sv, at, bt)
    out = torch.empty(tile.n_rows, bt.shape[1], dtype=torch.float32,
                      device=sv.device)
    mid = torch.empty(tile.cap, dtype=torch.float32, device=sv.device)
    _launch("fused_tile", "fused_tile",
            _ptr(tile.row_ptr), None, _ptr(tile.cols), _ptr(sv), _ptr(at), _ptr(bt),
            _ptr(out), _ptr(mid), tile.n_rows, tile.n_rows, tile.cap, 1, bt.shape[1],
            int(bf16), int(vec), _stream(sv.device), bf16=bf16)
    return out, mid


# ---------------------------- banked launches ------------------------------ #
# A band writes only its own part of an output the caller allocated for
# the whole tile: mid at its slots (and, with zero_pads, 0 at the pads),
# out at its rows, the row stats at its rows.


def sddmm_rows(tile: TileView, band, sv, at, bt, mid, zero_pads: bool) -> None:
    if sv.device.type == "cpu":
        return sddmm_rows_plain(tile, band, sv, at, bt, mid, zero_pads)
    bf16, vec = _check(tile, sv, at, bt)
    _check_band(tile, band, sv.device)
    _check_out(mid, (tile.cap,), sv.device)
    _launch("sddmm_rows", "sddmm_tile",
            _ptr(tile.row_ptr), _ptr(band.rows), _ptr(tile.cols), _ptr(sv), _ptr(at),
            _ptr(bt), _ptr(mid), band.n_rows, tile.n_rows, tile.cap, int(zero_pads),
            bt.shape[1], int(bf16), int(vec), _stream(sv.device), bf16=bf16)


def spmm_rows(tile: TileView, band, sv, bt, out) -> None:
    if sv.device.type == "cpu":
        return spmm_rows_plain(tile, band, sv, bt, out)
    bf16, vec = _check(tile, sv, None, bt)
    _check_band(tile, band, sv.device)
    _check_out(out, (tile.n_rows, bt.shape[1]), sv.device)
    _launch("spmm_rows", "spmm_tile",
            _ptr(tile.row_ptr), _ptr(band.rows), _ptr(tile.cols), _ptr(sv), _ptr(bt),
            _ptr(out), band.n_rows, bt.shape[1], int(bf16), int(vec),
            _stream(sv.device), bf16=bf16)


def fused_rows(tile: TileView, band, sv, at, bt, out, mid, zero_pads: bool) -> None:
    if sv.device.type == "cpu":
        return fused_rows_plain(tile, band, sv, at, bt, out, mid, zero_pads)
    bf16, vec = _check(tile, sv, at, bt)
    _check_band(tile, band, sv.device)
    _check_out(out, (tile.n_rows, bt.shape[1]), sv.device)
    _check_out(mid, (tile.cap,), sv.device)
    _launch("fused_rows", "fused_tile",
            _ptr(tile.row_ptr), _ptr(band.rows), _ptr(tile.cols), _ptr(sv), _ptr(at),
            _ptr(bt), _ptr(out), _ptr(mid), band.n_rows, tile.n_rows, tile.cap,
            int(zero_pads), bt.shape[1], int(bf16), int(vec), _stream(sv.device), bf16=bf16)


def _seg_args(band) -> tuple:
    return _ptr(band.seg_row), _ptr(band.seg_beg), _ptr(band.seg_end)


def sddmm_split(tile: TileView, band, sv, at, bt, mid, zero_pads: bool) -> None:
    if sv.device.type == "cpu":
        return sddmm_split_plain(tile, band, sv, at, bt, mid, zero_pads)
    bf16, vec = _check(tile, sv, at, bt)
    _check_band(tile, band, sv.device)
    _check_out(mid, (tile.cap,), sv.device)
    _launch("sddmm_split", "sddmm_split",
            _ptr(tile.row_ptr), *_seg_args(band), _ptr(tile.cols), _ptr(sv), _ptr(at),
            _ptr(bt), _ptr(mid), band.n_seg, tile.n_rows, tile.cap, int(zero_pads),
            bt.shape[1], int(bf16), int(vec), _stream(sv.device), bf16=bf16)


def spmm_split(tile: TileView, band, sv, bt):
    """``work [n_seg, R]`` float32: the segments' partial output rows."""
    if sv.device.type == "cpu":
        return spmm_split_plain(tile, band, sv, bt)
    bf16, vec = _check(tile, sv, None, bt)
    _check_band(tile, band, sv.device)
    work = torch.empty(band.n_seg, bt.shape[1], dtype=torch.float32, device=sv.device)
    _launch("spmm_split", "spmm_split",
            *_seg_args(band), _ptr(tile.cols), _ptr(sv), _ptr(bt), _ptr(work),
            band.n_seg, bt.shape[1], int(bf16), int(vec), _stream(sv.device), bf16=bf16)
    return work


def fused_split(tile: TileView, band, sv, at, bt, mid, zero_pads: bool):
    """Writes ``mid`` at the segments' slots; returns ``work [n_seg, R]``."""
    if sv.device.type == "cpu":
        return fused_split_plain(tile, band, sv, at, bt, mid, zero_pads)
    bf16, vec = _check(tile, sv, at, bt)
    _check_band(tile, band, sv.device)
    _check_out(mid, (tile.cap,), sv.device)
    work = torch.empty(band.n_seg, bt.shape[1], dtype=torch.float32, device=sv.device)
    _launch("fused_split", "fused_split",
            _ptr(tile.row_ptr), *_seg_args(band), _ptr(tile.cols), _ptr(sv), _ptr(at),
            _ptr(bt), _ptr(work), _ptr(mid), band.n_seg, tile.n_rows, tile.cap,
            int(zero_pads), bt.shape[1], int(bf16), int(vec), _stream(sv.device), bf16=bf16)
    return work


def _unit_args(band, dev) -> tuple:
    """The heavy band's second-pass unit table (``codegen/banded.py``): its
    arrays are int32, built together from ``seg_ptr`` and moved together
    by ``RowBand.to``, so one call checks where they lie, not their types
    (a launch-bound kernel pays for every check on the host)."""
    _on_card(dev, band.rows, band.seg_ptr, band.unit_row, band.counters)
    return (_ptr(band.seg_ptr), _ptr(band.rows), _ptr(band.unit_row), _ptr(band.unit_beg),
            _ptr(band.unit_end), _ptr(band.counters))


def split_reduce(band, work, out) -> None:
    """Write the heavy rows of ``out`` from the segments' partial rows.
    Allocates the chunk units' partial rows (``[n_units - n_short, R]``)."""
    if work.device.type == "cpu":
        return split_reduce_plain(band, work, out)
    dev = work.device
    _on_card(dev, work, out)
    if not band.heavy or work.dtype != torch.float32 or out.dtype != torch.float32:
        raise ValueError("split_reduce takes a heavy band and float32 work and out")
    if work.shape != (band.n_seg, out.shape[1]) or out.dim() != 2:
        raise ValueError("work must be [n_seg, R] for an out of R columns")
    if band.n_rows > out.shape[0]:
        raise ValueError("band has more rows than the output")
    units = _unit_args(band, dev)
    R = out.shape[1]
    partial = torch.empty(band.n_units - band.n_short, R, dtype=torch.float32, device=dev)
    # partial is fresh from the caching allocator: aligned.
    vec = R % 4 == 0 and (work.data_ptr() | out.data_ptr()) % 16 == 0
    _launch("split_reduce", "split_reduce",
            *units, _ptr(work), _ptr(out), _ptr(partial), band.n_short, band.n_units,
            band.chunk, R, int(vec), _stream(dev))


def attn_stats_tile(tile: TileView, gate, logits):
    """``(m [n_rows], d [n_rows])`` float32: partial row stats of one tile,
    to merge with :func:`~distributed_sddmm_tpu_torch.ops.kernels.attn_merge_stats`."""
    if gate.device.type == "cpu":
        return attn_stats_tile_plain(tile, gate, logits)
    _check_attn(tile, gate, logits)
    m = torch.empty(tile.n_rows, dtype=torch.float32, device=gate.device)
    d = torch.empty_like(m)
    _launch("attn_stats_tile", "attn_stats_tile",
            _ptr(tile.row_ptr), None, _ptr(gate), _ptr(logits), _ptr(m), _ptr(d),
            tile.n_rows, _stream(gate.device))
    return m, d


def attn_stats_rows(tile: TileView, band, gate, logits, m, d) -> None:
    """Write the row stats of the band's rows into ``m`` and ``d``."""
    if gate.device.type == "cpu":
        return attn_stats_rows_plain(tile, band, gate, logits, m, d)
    _check_attn(tile, gate, logits, m, d)
    _check_band(tile, band, gate.device)
    _launch("attn_stats_rows", "attn_stats_tile",
            _ptr(tile.row_ptr), _ptr(band.rows), _ptr(gate), _ptr(logits), _ptr(m),
            _ptr(d), band.n_rows, _stream(gate.device))


def attn_stats_split(tile: TileView, band, gate, logits):
    """``(wm [n_seg], wd [n_seg])``: the heavy band's per-segment stats."""
    if gate.device.type == "cpu":
        return attn_stats_split_plain(tile, band, gate, logits)
    _check_attn(tile, gate, logits)
    _check_band(tile, band, gate.device)
    wm = torch.empty(band.n_seg, dtype=torch.float32, device=gate.device)
    wd = torch.empty_like(wm)
    _launch("attn_stats_split", "attn_stats_split",
            _ptr(band.seg_beg), _ptr(band.seg_end), _ptr(gate), _ptr(logits),
            _ptr(wm), _ptr(wd), band.n_seg, _stream(gate.device))
    return wm, wd


def attn_stats_merge(band, wm, wd, m, d) -> None:
    """Write the heavy rows' stats into ``m`` and ``d``. Allocates the
    chunk units' partial pairs (``[2, n_units - n_short]``)."""
    if wm.device.type == "cpu":
        return attn_stats_merge_plain(band, wm, wd, m, d)
    dev = wm.device
    _on_card(dev, wm, wd, m, d)
    if any(t.dtype != torch.float32 for t in (wm, wd, m, d)):
        raise ValueError("stats must be float32")
    if wm.shape != (band.n_seg,) or wd.shape != (band.n_seg,) or m.shape != d.shape:
        raise ValueError("segment stats must be [n_seg], row stats of one shape")
    if band.n_rows > m.shape[0]:
        raise ValueError("band has more rows than the row stats")
    units = _unit_args(band, dev)
    partial = torch.empty(2, band.n_units - band.n_short, dtype=torch.float32, device=dev)
    _launch("attn_stats_merge", "attn_stats_merge",
            *units, _ptr(wm), _ptr(wd), _ptr(m), _ptr(d), _ptr(partial), band.n_short,
            band.n_units, band.chunk, _stream(dev))


def attn_norm_tile(tile: TileView, gate, logits, m, d):
    """``p [cap]`` float32 from the merged row stats; 0 at pad slots."""
    if gate.device.type == "cpu":
        return attn_norm_tile_plain(tile, gate, logits, m, d)
    _check_attn(tile, gate, logits, m, d)
    p = torch.empty(tile.cap, dtype=torch.float32, device=gate.device)
    _launch("attn_norm_tile", "attn_norm_tile",
            _ptr(tile.rows), _ptr(gate), _ptr(logits), _ptr(m), _ptr(d), _ptr(p),
            tile.cap, _stream(gate.device))
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
