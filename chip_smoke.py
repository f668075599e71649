"""Drive the PyTorch / CUDA port on one NVIDIA card and hold each of its
hand-written kernels against its plain PyTorch version.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
last line is printed):

1. device   -- CUDA must be present; the card's name and power limit.
2. build    -- ``nvcc`` builds every ``ops/csrc/*.cu`` (sm_90a), one
   process per source, all started together; ptxas must report no spill
   in any instantiation of the walks of ``ops/csrc/tile_common.cuh``
   (``WALK_KERNELS``: the SDDMM / SpMM / fused walk and the stats walk).
2b. edges   -- the SDDMM, SpMM and fused walks on a small tile whose rows
   hold 0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100,
   129 and 4099 slots (around every batch and index-chunk size of the
   walk), plus pads, at R = 16, 32, 64, 100, 128, 256, 512 and 520, f32 and
   bf16, for the three item kinds: whole tile rows, every row as one
   band's row list, and the segments (at most 33 slots) of the rows above
   16 slots. Each against its plain version (phase 3's tolerances),
   ``mid == 0`` exactly at the pads, two launches bit-equal. Then the
   attention stats walk on the same tile, its three item kinds, with
   aligned and unaligned gate and logits, a fully masked row and a row of
   one live slot: ``m`` equal to the plain version's, ``d`` within
   ``ATTN_STATS_RTOL``, two launches bit-equal. Then the heavy band's
   second pass (``split_reduce``, ``attn_stats_merge``) on the same tile's
   heavy band at several chunk sizes and R (edge_pass2): bit-equal to the
   plain version on integer data, within phase 3's f32 tolerance on
   normal data, every call twice in a row with the same bits and its
   per-row counters back at 0.
3. kernels  -- at the headline tile (R-mat log_m=16, edge_factor=32, R=128,
   the ``DenseShift15D`` S tile), each kernel against its plain version on
   standard-normal operands, in f32 and bf16. Error is the max abs
   difference over the max abs plain value: <= 1e-5 in f32 (the same f32
   sums in another order), <= 1e-2 in bf16 (bf16 rounding points are the
   same, but a last-bit change of ``mid`` can move one rounded contribution
   by one bf16 step). Pad slots must give ``mid == 0`` exactly, and two
   launches must agree bit for bit (no atomics).
4. verify   -- the main path: ``make_algorithm("15d_fusion2"/"15d_fusion1")``
   run through the port's verify protocol at the headline size, in f32 and
   bf16; fingerprints against the float64 oracle within 1e-4 (f32, the JAX
   package's verify tolerance) and 1e-2 (bf16). The launch counters, zeroed
   just before each run and read just after, must show every kernel ran.
5. full     -- R-mat log_m=20, edge_factor=32, R=128, ``15d_fusion2``, in f32
   and bf16: warmup pairs, then timed fused pairs (GFLOP/s by ``bench.py``'s
   formula ``2*nnz*2*R*pairs/elapsed``), sampled rows against a float64
   host reference, peak device memory; then each kernel's time per launch at
   these shapes beside its plain version, its bound, and one PyTorch call
   that computes the same function (a yardstick the port never calls).
6. attention_verify -- block-sparse attention at the headline size
   (2**16 tokens, R=128, self-attention on ``X = N(0,1)/sqrt(R)``, the serve
   path's data) through ``make_algorithm("15d_fusion2", attention=True)``
   for the masks ``window:16`` and ``bigbird:w=8,g=2,r=2``, in f32 and
   bf16, A and B modes: ``out`` within 1e-4 (f32) / 1e-2 (bf16) of the
   float64 oracle's max abs value, weights within 1e-5 (f32) / 1e-2 (bf16)
   absolute; fused equals unfused bit for bit; each fused call launches
   exactly one SDDMM, attn_stats, attn_norm and SpMM kernel, each then
   timed alone on the inputs the call gives it (breakdown). First, on the
   window mask's tile (kernels_headline), the two attention kernels against
   their plain versions on standard-normal logits with 10% of the gates
   zeroed and one fully masked row: m and d within 1e-5 relative, weights
   within 1e-6 absolute, masked and pad slots exactly 0, two launches
   equal; each timed beside its bound and ``torch.sparse.softmax`` of the
   same logits (one call for the pair).
7. attention_full -- 2**20 tokens, ``window:64`` (135.3M nonzeros), R=128,
   ``15d_fusion2``, f32 and bf16: the harness's own loop
   (``_run_attention``), fused and unfused, with GFLOP/s by its formula and
   the counted bytes; each kernel of one call timed alone (breakdown, as
   in phase 6); 64 sampled rows on the normal data against float64 on the
   host; peak device memory; then the attention kernels against their
   plain versions at this tile (kernels_full), and the SDDMM, SpMM and
   fused kernels too, with their bounds and library calls
   (kernels_window64).
8. banked   -- the banked codegen kernels (``BankedCudaKernel``, one launch
   per nnz/row band, heavy rows split into segments). Graph500 R-mat
   (initiator 0.57/0.19/0.19/0.05, edge_factor 32, R=128) at log_m=16: the
   verify protocol with the selected variant, fusion 2 and 1, f32 and bf16
   (same tolerances as phase 4), launches as the band structure predicts
   and no generic launch; banked == generic bit for bit on operands in
   {-1, 0, 1}; each new kernel against its plain version (phase 3's
   tolerances, pads exactly 0, two launches equal; the second pass twice
   in a row, counters back at 0, also timed as a CUDA graph of launches
   (device time without the host), each timing method's launch floor
   beside it). At log_m=20: ms per
   fused pair, generic and banked in turns, sampled rows (the heaviest
   among them) against float64, the kernels against their plain versions
   again, and a sweep of the segment length. Bigbird ``w=8,g=2,r=2`` at
   2**16 tokens: phase 6's checks through the banked kernel, the new
   attention-stats kernels against their plain versions (a fully masked
   heavy row gives (ATTN_NEG, 0)), ms per call generic and banked in
   turns, the banked call's breakdown. The uniform R-mat of phase 5: one
   band after the degeneration guard, ms per pair generic and banked.
9. cli -- ``bench.cli.main(["er", "16", "32", "15d_fusion2", "128", "1",
   "--app", "attention", ...])`` on the card, then one ``--kernel-variant``
   run; the records they append.
10. ring -- ``DenseShift15D`` at p > 1 over a ``LocalWorld`` (p logical
   ranks on this card) and over NCCL. verify: the headline R-mat at (p, c)
   = (2, 1), (4, 1), (4, 2), (8, 4), fusion 2, 1 and 2 overlapped, f32
   and bf16, fingerprints against float64 (phase 4's tolerances); on
   operands in {-1, 0, 1} every f32 output equal to p = 1's bit for bit;
   p * p/c launches of the fused kernel a pair. attention: ``window:16``
   at 2**16 tokens, (4, 2), f32, A and B modes, within 1e-5 of p = 1's
   output (of its max abs value) and 1e-6 on the weights, two all-reduces
   (the c-axis stats merge) a call. banked: the Graph500 R-mat of phase 8
   at log_m=16, its variant, (4, 2): banked equals generic bit for bit on
   integer data, launches as every rank's bands predict. scaling: phase
   5's cell at (p, c) = (1, 1), (4, 1), (16, 1), (16, 4), f32 and bf16,
   through the harness's own loop (3 warmup, 10 timed pairs): ms and
   GFLOP/s a pair, launches a pair, peak memory, the breakdown
   (``measure_breakdown``: full, no_ring, local), and sampled rows of one
   pair against float64. nccl: one process, ``init_process_group("nccl",
   file://...)`` at world size 1: ``GridSpec.self_test`` through NCCL, and
   the headline verify through a ``DistWorld`` equal to ``LocalWorld``'s at
   p = 1 bit for bit.
11. apps -- ALS-CG and the GAT forward pass (``models/``). als_protocol:
   the JAX package's ALS protocol (``tests/test_als.py``: ER 48 x 32, R =
   8, 5 CG iterations, p = 8 with c = 2) on the card, ``r1 < 0.5 r0`` and
   ``r2 < 1.01 r1``; then the ladder on the card: guards on, ``S_host``
   given, the Gram operator poisoned twice, ``run_cg`` raises
   ``NumericalFault`` with the factors untouched (no host fallback on the
   card). als_full: phase
   5's cell through the harness's ``_run_als`` (one warmup step, 3 timed
   steps of 10 CG iterations a half-step), f32 and bf16: ms a step, the
   residual trajectory a step at a time (the first step's ``r1 / r0``
   within ``ALS_RATIO_TOL`` of the float64 serial solver's on a uniform
   R-mat of the same shape at log_m 12, both precisions: 128 unknowns a
   row against about 32 observations leave far more than half the
   residual after a step of 10 CG iterations; f32: no step raises it by
   1%, and a control whose Gram operator drops one slot in
   ``ALS_CONTROL_GATED`` must miss that tolerance), a CG iteration
   through the model's own ``cgStep`` split by CUDA events into
   the fused pair and the rest beside the rest's byte bound (7 frames of
   M x R x 4 bytes), peak memory. als_oracle: uniform R-mat log_m=12,
   R=32, from the float64 serial solver's factors and observations: after
   2 steps the port's residual within 1.05 x the serial one either way
   and its factors within 1e-4 of the serial ones. als_ring: the headline R-mat, one step at
   (p, c) = (4, 2) within 1e-4 of p = 1's factors (of their max abs
   value); Graph500 16 with its variant, two steps within 1e-4 relative of
   the generic kernel's residual, the banked launches of each half-step as
   the bands predict (no generic launch, ``split_reduce`` in B mode).
   gat_headline: the harness's GAT (heads 4, 4, 6, 128 features a head) on
   the headline R-mat against a float64 host forward pass with the same
   weights, within 1e-4 (f32) / 1e-2 (bf16) of its max abs value.
   gat_full: ``_run_gat`` at phase 5's cell (1 warmup, 3 timed forwards),
   a forward through ``GAT.layer_forward`` (the code ``forward`` times)
   split per layer into projection, SDDMM, SpMM and elementwise work by
   CUDA events, peak memory. cli: ``er ... --app als`` with
   ``--checkpoint-dir``, the same with ``--resume`` (it starts from the
   stored step), ``er ... --app gat``. Launch counts as each drive
   predicts.
12. strategies -- the other three strategies (``SparseShift15D``,
   ``CannonDense25D``, ``CannonSparse25D``) beside ``DenseShift15D``, on
   the tile kernels in their new roles (R-split operands 16-64 wide,
   tiles spanning all ``N_pad`` columns, the swapped Cannon tiles).
   verify: the headline R-mat at (p, c) = (4, 1), (8, 2), (16, 4) of a
   ``LocalWorld``, f32 and bf16: the verify protocol (phase 4's
   tolerances, launches one kernel a rank a ring step), every op on
   operands in {-1, 0, 1} equal to p = 1's bit for bit (f32), sampled
   rows of every op on N(0, 1) operands against float64 (phase 4's
   tolerances); the f32 spmmA fingerprints of all four at every grid
   within 1e-5 of each other. banked: Graph500 16 with its variant at
   (4, 1): sparse shift and Cannon dense banked equal to generic bit for
   bit, launches as every tile's bands predict; Cannon sparse builds
   generic (realized variant None, a ``codegen_generic_fallbacks`` a
   tile set) and launches the generic kernel. full: phase 5's cell at
   (4, 1), all four, f32 and bf16, the harness's loop (3 warmup, 10 timed
   pairs): ms and GFLOP/s a pair, launches a pair, peak memory, set-up
   seconds, the breakdown, sampled rows against float64; the SDDMM and
   SpMM kernels at each R-split strategy's shapes against their plain
   versions (``kernels_<strategy>_full``). nccl: ``CannonDense25D`` over
   NCCL at world size 1 equal to ``LocalWorld`` bit for bit. cli: ``er
   12 8 15d|25d|all ... 128 1`` over four logical ranks, one record a
   member, ``all --fusion overlap`` reporting both Cannon members skipped.
13. training -- gradients through the strategies (``ops/autograd.py``):
   the tile kernels in new roles in the backward (an SDDMM for the value
   grads and ``<G_out, B>``, an SpMM for ``dA``), the column scatter
   ``index_add_``. headline: the sddmm, spmm and fused grads at the
   headline R-mat, p = 1, f32 and bf16, against float64 on 64 sampled rows
   and their nonzeros and 64 sampled columns (1e-4 / 1e-2 of the max abs
   value); each backward launches the kernels the design names (SDDMM +
   SpMM, SDDMM, 2 SDDMM + SpMM), on float32 operands in both modes (the
   launches are counted by the type of the operands they read), and no
   plain version runs. banked:
   Graph500 16 with its variant, the fused pair's grads equal to the
   generic kernel's (1e-5), the bands' launches in the backward. strategies:
   the four at (4, 1), f32, every op's grads within 1e-5 of p = 1's.
   timing: the full cell's fused pair, f32 and bf16, ms of the forward and
   of forward + backward (CUDA events), peak memory. gat: at the headline
   R-mat one step's weight grads of the harness's GAT (heads 4, 4, 6, 128
   a head) within 1e-4 of a float64 CPU autograd of the same network from
   the same weights at the port's own branch pattern (read from
   ``GAT.layer_forward``), every logit and aggregate where that pattern
   leaves float64's within float32 rounding of its kink (``gat_kinks``),
   and within ``GAT_TRAIN["own_cap"]`` at float64's own pattern; at the
   full cell 1 + 3 steps of plain SGD on an MSE
   against an N(0, 0.1) target, f32 and bf16: ms a step, the loss at each
   step (it must fall), peak memory, the backward's launches on float32.
14. apps_strategies -- ALS and GAT on ``SparseShift15D``,
   ``CannonDense25D`` and ``CannonSparse25D`` (the per-op counters). protocol:
   phase 11's ALS protocol on each. full: phase 5's cell at (4, 1) on the
   tile sets phase 12 built, f32: ALS through ``_run_als`` (ms a step, the
   first step's ratio within ``ALS_RATIO_TOL`` of the float64 solver's),
   the GAT forward (ms a forward, the output within 1e-4 of the dense
   shift's at p = 1 from the same weights). cli: ``er 12 8 all ... 128 1
   --app als`` and ``--app gat`` over four logical ranks, a record a
   member, none skipped.
15. kernels line -- ``{"kernels": [...]}``.
16. last line -- ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --gat-grad-drift [SEED ...]`` is another mode
(``gat_grad_drift``): the readings behind GAT_DRIFT["plain"].
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import io
import json
import math
import multiprocessing
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from distributed_sddmm_tpu_torch import masks
from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.bench import cli, harness
from distributed_sddmm_tpu_torch.bench.harness import make_algorithm
from distributed_sddmm_tpu_torch.bench.kernel_ab import band_coo
from distributed_sddmm_tpu_torch.codegen import (
    BankedCudaKernel, banded, build_banded, select_variant,
)
from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.models import als as als_mod
from distributed_sddmm_tpu_torch.models import gat as gat_mod
from distributed_sddmm_tpu_torch.models.serial_als import SerialALS
from distributed_sddmm_tpu_torch.ops import _build, cuda_kernels
from distributed_sddmm_tpu_torch.ops import autograd as tile_autograd
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.ops.kernels import ATTN_NEG
from distributed_sddmm_tpu_torch.parallel import comm as comm_mod
from distributed_sddmm_tpu_torch.parallel import sharding
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.comm import DistWorld, LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.mesh import make_grid
from distributed_sddmm_tpu_torch.parallel.sharding import BankedTileView, TileView
from distributed_sddmm_tpu_torch.resilience import CheckpointStore, NumericalFault
from distributed_sddmm_tpu_torch.utils import oracle, verify
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

HEADLINE = {"log_m": 16, "edge_factor": 32, "R": 128}
FULL = {"log_m": 20, "edge_factor": 32, "R": 128}
PRECISIONS = ("f32", "bf16")
KERNEL_TOL = {"f32": 1e-5, "bf16": 1e-2}
VERIFY_RTOL = {"f32": 1e-4, "bf16": 1e-2}
WARMUP_PAIRS, TIMED_PAIRS = 3, 20
KERNEL_REPS, PLAIN_REPS = 20, 3

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and
# the float32 rate outside the tensor cores, where these kernels do their
# arithmetic in both precisions (bf16 operands are widened to f32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SOURCE = "distributed_sddmm_tpu_torch/ops/csrc/tile_kernels.cu"
ATTN_SOURCE = "distributed_sddmm_tpu_torch/ops/csrc/attn_kernels.cu"
BANKED_SOURCE = "distributed_sddmm_tpu_torch/ops/csrc/banked_kernels.cu"
BANKED_PY = "distributed_sddmm_tpu/codegen/kernel.py"
REPLACES = {
    "sddmm_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:327",
    "spmm_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:341",
    "fused_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:305",
    "attn_stats_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:419",
    "attn_norm_tile": "distributed_sddmm_tpu/ops/pallas_kernels.py:465",
    # The banked launches of BankedPallasKernel: sddmm_tile_t l.117,
    # spmm_tile_t l.131 (its band partials add at l.135), fused_tile_t
    # l.145, attn_stats_tile_t l.171 (merged at l.178).
    "sddmm_rows": f"{BANKED_PY}:117", "sddmm_split": f"{BANKED_PY}:117",
    "spmm_rows": f"{BANKED_PY}:131", "spmm_split": f"{BANKED_PY}:131",
    "split_reduce": f"{BANKED_PY}:135",
    "fused_rows": f"{BANKED_PY}:145", "fused_split": f"{BANKED_PY}:145",
    "attn_stats_rows": f"{BANKED_PY}:171", "attn_stats_split": f"{BANKED_PY}:171",
    "attn_stats_merge": f"{BANKED_PY}:178",
}
SOURCES = {op: SOURCE for op in ("sddmm_tile", "spmm_tile", "fused_tile", "sddmm_rows",
                                 "spmm_rows", "fused_rows")}
SOURCES.update({op: ATTN_SOURCE for op in ("attn_stats_tile", "attn_norm_tile",
                                          "attn_stats_rows")})
SOURCES.update({op: BANKED_SOURCE for op in ("sddmm_split", "spmm_split", "fused_split",
                                            "split_reduce", "attn_stats_split",
                                            "attn_stats_merge")})
OPS = ("sddmm_tile", "spmm_tile", "fused_tile")
ATTN_OPS = ("attn_stats_tile", "attn_norm_tile")
#: Kernels that run in float32 whatever the precision mode.
F32_ONLY = ATTN_OPS + ("attn_stats_rows", "attn_stats_split", "attn_stats_merge",
                       "split_reduce")

# Edge checks of the walks (phase edges): row lengths around each batch
# (2 to 16 slots) and index chunk (4 to 32 slots) of the tile walk and
# twice them, empty rows, a `window:64` row (129), a row of several
# thousand slots, pads; every lane layout of the walk (R/16 lanes an item
# for a dot, R/4 in f32 and R/8 in bf16 for the SpMM, from 4 lanes at R =
# 16 up to the warp, the scalar path at R = 100 in bf16, two slabs at
# 520). The stats walk:
# a fully masked row (EDGE_DEAD, also a heavy row's segments) and a row
# with one live slot (EDGE_ONE).
EDGE = {"lens": (0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 0, 4099,
                 100, 129),
        "Rs": (16, 32, 64, 100, 128, 256, 512, 520), "pads": 13, "n_cols": 4096,
        "heavy_above": 16, "split": 33}
EDGE_DEAD, EDGE_ONE = 16, 12
#: The heavy band's second pass at the edges (phase edges): the edge
#: tile's heavy band (rows of 1 to 125 segments) with its unit table at
#: these chunk sizes (4: every row of more than one segment in chunks, the
#: 4099-slot row in 32 of them; the default: every row in one chunk), at
#: these R (every lane layout, 7 the scalar path, an output 4 bytes off a
#: 16-byte boundary the scalar path again).
EDGE_PASS2 = {"chunks": (4, 8, banded.REDUCE_CHUNK), "Rs": (4, 7, 16, 20, 100, 128, 520)}
#: Segments of the long rows of pass 2 (long_pass2): past the merge's
#: one-block rows (1024 segments), fully masked, empty.
EDGE_LONG = (3000, 2000, 0)
#: The ``__global__`` walks of ``ops/csrc/tile_common.cuh`` (and the dot
#: walk's out-of-line helper), whose every instantiation phase build
#: holds to no spill.
WALK_KERNELS = ("dot_walk_kernel", "stats_walk_kernel", "dot_slabs")

# Banked launches (phase banked). The Graph500 initiator fills all three
# bands; the uniform one collapses to one (PERF.md section 4).
GRAPH500 = {"a": 0.57, "b": 0.19, "c": 0.19, "d": 0.05}
BANKED = {"log_ms": (16, 20), "edge_factor": 32, "R": 128,
          "bigbird": "bigbird:w=8,g=2,r=2", "log_n": 16}
BANKED_PAIRS = 10
SPLITS = (32, 64, 128, 256, 512)

# Attention: the headline size, with both masks of the README, and the
# full cell (the README's headline mask at 2**20 tokens). The attention
# kernels are float32 in both precision modes.
ATTN_HEADLINE = {"log_n": 16, "R": 128, "masks": ("window:16", "bigbird:w=8,g=2,r=2")}
ATTN_FULL = {"log_n": 20, "R": 128, "mask": "window:64"}
ATTN_OUT_RTOL = {"f32": 1e-4, "bf16": 1e-2}
ATTN_PROBS_ATOL = {"f32": 1e-5, "bf16": 1e-2}
ATTN_STATS_RTOL, ATTN_P_ATOL = 1e-5, 1e-6
ATTN_WARMUP, ATTN_TRIALS, ATTN_CALL_REPS = 2, 10, 3
DEAD_ROW = 3
#: Kernel launches of one fused attention call at p = 1.
ATTN_CALL = {**dict.fromkeys(cuda_kernels.LAUNCHES, 0), "sddmm_tile": 1,
             "spmm_tile": 1, "attn_stats_tile": 1, "attn_norm_tile": 1}
# The ring (phase ring): (p, c) grids of logical ranks on this card.
RING = {"verify": ((2, 1), (4, 1), (4, 2), (8, 4)), "attention": (4, 2),
        "banked": (4, 2), "scaling": ((1, 1), (4, 1), (16, 1), (16, 4))}
#: (fusion, overlap) builds of the ring verify.
RING_BUILDS = ((2, False), (1, False), (2, True))
RING_WARMUP, RING_TRIALS, RING_BREAKDOWN_TRIALS = 3, 10, 3
RING_OUT_RTOL, RING_P_ATOL = 1e-5, 1e-6
# The four strategies (phase strategies): the verify grids at the
# headline size, the banked grid at Graph500 16, the full cell's grid, the
# strategy over NCCL; the harness's loop at the full cell.
STRATEGIES = {"names": ("15d_fusion2", "15d_sparse", "25d_dense_replicate",
                        "25d_sparse_replicate"),
              "r_split": ("15d_sparse", "25d_dense_replicate", "25d_sparse_replicate"),
              "grids": ((4, 1), (8, 2), (16, 4)), "banked": (4, 1), "full": (4, 1),
              "nccl": "25d_dense_replicate"}
STRATEGY_LABELS = {"15d_sparse": "sparse_shift", "25d_dense_replicate": "cannon_dense",
                   "25d_sparse_replicate": "cannon_sparse"}
STRAT_WARMUP, STRAT_TRIALS, STRAT_BREAKDOWN_TRIALS = 3, 10, 3
#: The spmmA fingerprints of every strategy and grid agree within this
#: (the JAX package's ``test_fused_and_four_algorithm_fingerprints``).
STRAT_FP_RTOL = 1e-5
# The apps (phase apps): ALS-CG and the GAT forward pass of ``models/``.
# ALS: one warmup step, then timed steps of cg_iters CG iterations a
# half-step; its float64 oracle at log_m 12 (R 32, 2 steps, the port's
# residual within ``slack`` of the serial one); one step at (p, c) within
# ``tol`` of p = 1's factors; two banked steps within ``rtol`` of the
# generic kernel's residual (Graph500 16, its selected variant).
ALS = {"cg_iters": 10, "warmup": 1, "steps": 3}
#: The JAX package's own ALS protocol (``tests/test_als.py``): ER 48 x 32,
#: 5 nonzeros a row, R = 8, 5 CG iterations, 8 ranks with c = 2; step 1
#: more than halves the residual, step 2 does not raise it by 1%.
ALS_PROTOCOL = {"M": 48, "N": 32, "nnz_per_row": 5, "R": 8, "cg_iters": 5, "p": 8, "c": 2}
#: At the full cell (128 unknowns a row, about 32 observations, 10 CG
#: iterations) a step cuts the residual far less; its first-step ratio is
#: held to the float64 serial solver's on a uniform R-mat of the same
#: shape at this log_m (edge_factor and R of the full cell). The tolerance
#: lies between the gaps of sound runs (f32, bf16) and those of controls
#: whose Gram operator drops one nonzero slot in k (k in ALS_CONTROLS):
#: the control at ALS_CONTROL_GATED must land outside it, or the gate is
#: blind and the phase fails. Readings on an H100 (PERF.md, section 6): sound
#: 2.57e-4 (f32); controls (every pair of the step dropping slots) k = 10,
#: 100, 1000, 10000: 1.71e-2, 1.45e-3, 8.6e-5, 2.40e-4.
ALS_SHAPE_LOG_M, ALS_RATIO_TOL = 12, 5e-4
ALS_CONTROLS, ALS_CONTROL_GATED = (10, 100, 1000, 10000), 100
#: The port's residual within ``slack`` of the serial one (both ways) and
#: its factors within ``factor_tol`` of the serial ones (of their max abs).
ALS_ORACLE = {"log_m": 12, "edge_factor": 32, "R": 32, "steps": 2, "slack": 1.05,
              "factor_tol": 1e-4}
ALS_RING = {"grid": (4, 2), "tol": 1e-4, "banked_steps": 2, "banked_rtol": 1e-4}
#: Frames of M_pad x R float32 the CG vector algebra must move an
#: iteration at the least: X, r, p and the Gram product read; X, r, p
#: written.
CG_FRAMES = 7
#: GAT: the harness's network (heads 4, 4, 6, features_per_head = R);
#: the headline output against float64 within these of its max abs value.
GAT = {"warmup": 1, "forwards": 3}
GAT_TOL = {"f32": 1e-4, "bf16": 1e-2}
# Training (phase training): the grads of the tile ops through a strategy
# against float64 on sampled rows (f32 / bf16 tolerances of the max abs
# value), the four strategies and the banked kernel against the generic
# p = 1 grads, the fused pair timed with its backward at the full cell.
TRAINING = {"sample": 64, "grad_tol": {"f32": 1e-4, "bf16": 1e-2}, "grid": (4, 1),
            "strategy_tol": 1e-5, "reps": 5}
#: Kernel launches of one backward at p = 1 (``ops/autograd.py``), when
#: the values and both dense operands ask for grads.
BACKWARD_LAUNCHES = {"sddmm": {"sddmm_tile": 1, "spmm_tile": 1},
                     "spmm": {"sddmm_tile": 1},
                     "fused": {"sddmm_tile": 2, "spmm_tile": 1}}
#: GAT training: the harness's network on an N(0, 1) input, MSE against an
#: N(0, target_std) target, plain SGD at ``lr``. The network is
#: homogeneous of degree 27 in its input (a layer's logits are bilinear in
#: its projection, the aggregation linear; ReLU and LeakyReLU commute with
#: a positive scale), so a probe forward at ``probe_scale`` fixes the
#: input scale at which the output's RMS is ``target_std``: a fixed scale
#: would leave the output vanishing or overflowing for other weights (at
#: log_m 10, 0.1 gives an RMS of 4e-9, 0.3 of 3e4). At that scale lr 0.1
#: lowered the loss at every step on uniform R-mats of log_m 10 and 12
#: (1.0 collapses the output in one step). One step's weight grads at the
#: headline size are held to a float64 CPU autograd of the same network at
#: the port's own pattern (``training_gat``): LeakyReLU's and ReLU's kinks
#: let float32 rounding pick another branch for the few logits and
#: aggregates within rounding of 0, which moves any float32 evaluation's
#: first-layer grads, plain PyTorch's too, from float64's. So the port's
#: pattern may leave float64's only within float32 rounding of a kink
#: (``gat_kinks``), and its distance from float64 at float64's own pattern
#: is capped at ``own_cap``: ten times the largest distance of plain
#: PyTorch float32 (CPU) over GAT_DRIFT["seeds"] (GAT_DRIFT["plain"], by
#: layer a seed, from ``python3 chip_smoke.py --gat-grad-drift`` on an
#: NVIDIA H100 80GB HBM3 host, PERF.md section 6; the port read 5.0e-4,
#: 1.8e-4 and 9.7e-5 at layer 1 there).
GAT_DRIFT = {"seeds": (5, 6, 7),
             "plain": ((4.566155905847896e-05, 3.311793385536195e-07, 1.6368348376874323e-07),
                       (1.849948181010732e-04, 5.303029448024412e-07, 9.535799883600262e-07),
                       (9.811061580664375e-05, 2.756981301660221e-07, 1.3480779407220779e-06))}
GAT_TRAIN = {"probe_scale": 0.19, "target_std": 0.1, "lr": 0.1, "warmup": 1, "steps": 3,
             "grad_tol": 1e-4, "seed": GAT_DRIFT["seeds"][0],
             "own_cap": 10 * max(max(seed) for seed in GAT_DRIFT["plain"])}
#: The float64 host references of the headline GAT (``HostReference``): a
#: spawned process of ``threads`` CPU threads, started before phase edges,
#: which the card's phases overlap (the two grads take about five minutes
#: of host time); the forward check's weights seed; the most seconds to
#: wait for a result.
GAT_REF = {"threads": 4, "forward_seed": 0, "timeout": 900}
#: ALS on the R-split strategies at the full cell (phase apps_strategies):
#: timed steps after ALS["warmup"].
ALS_STRAT = {"steps": 2}
PLAIN = {
    "sddmm_tile": cuda_kernels.sddmm_tile_plain,
    "spmm_tile": cuda_kernels.spmm_tile_plain,
    "fused_tile": cuda_kernels.fused_tile_plain,
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def call(kernel: CudaTileKernel, op: str, tile, sv, at, bt):
    if op == "spmm_tile":
        return kernel.spmm_tile(tile, sv, bt)
    return getattr(kernel, op)(tile, sv, at, bt)


def call_plain(op: str, tile, sv, at, bt):
    if op == "spmm_tile":
        return PLAIN[op](tile, sv, bt)
    return PLAIN[op](tile, sv, at, bt)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def time_ms(fn, reps: int) -> float:
    """Device time per call: CUDA events around ``reps`` calls after one
    warmup call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(op: str, nnz: int, M: int, N: int, R: int, esize: int) -> dict:
    """Least time for the work: each input read once and each output
    written once over HBM bandwidth, or the flops over the f32 rate,
    whichever is larger. ``gather_ms`` counts B as ``nnz`` gathered rows
    instead of once, the traffic when B does not stay in the 50 MB L2."""
    index = nnz * 8 + (M + 1) * 4          # cols + values, row_ptr
    a_in = M * R * esize
    out = M * R * 4
    mid = nnz * 4
    moved = {"sddmm_tile": index + a_in + mid,
             "spmm_tile": index + out,
             "fused_tile": index + a_in + mid + out}[op]
    flops = {"sddmm_tile": 2 * nnz * R + nnz,
             "spmm_tile": 2 * nnz * R,
             "fused_tile": 4 * nnz * R + nnz}[op]
    t_bytes = (moved + N * R * esize) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "gather_ms": max((moved + nnz * R * esize) / HBM_BYTES_PER_S * 1e3, t_ops),
    }


def attn_bound(op: str, nnz: int, n_rows: int) -> dict:
    """Least time of one attention kernel: ``attn_stats`` reads row_ptr,
    gate and logits (8 B a slot, 4 B a row) and writes m and d (8 B a row);
    ``attn_norm`` reads rows, gate and logits and writes p (16 B a slot)
    and reads m and d once (8 B a row). Operations: compare, subtract, exp
    and add a slot for the stats; subtract, exp and divide for the
    weights."""
    moved = (8 * nnz + 12 * n_rows if op == "attn_stats_tile"
             else 16 * nnz + 8 * n_rows)
    ops = (4 if op == "attn_stats_tile" else 3) * nnz
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def launch_key(op: str, prec: str) -> tuple:
    """Launch-count key: the attention kernels and the split's reduce are
    float32 in both modes."""
    return (op, "f32" if op in F32_ONLY else prec)


def add_launches(launches: dict, counts: dict, prec: str) -> None:
    for op, n in counts.items():
        key = launch_key(op, prec)
        launches[key] = launches.get(key, 0) + n


def by_type() -> dict:
    """The launches since the counters were zeroed, by the type of the
    dense operands each launch read (``cuda_kernels.launch_counts``)."""
    return {prec: cuda_kernels.launch_counts(prec) for prec in ("f32", "bf16")}


def add_by_type(launches: dict, counts: dict) -> None:
    """Add ``by_type`` counts, each under the type its launches read."""
    for prec, n in counts.items():
        add_launches(launches, n, prec)


def library_csr(tile, sv, n_cols: int):
    """The tile as a PyTorch CSR matrix with sorted columns (cuSPARSE's
    input), built once outside any timed region."""
    nnz = int(tile.row_ptr[-1])
    key = tile.rows[:nnz].long() * n_cols + tile.cols[:nnz].long()
    order = torch.argsort(key)
    return torch.sparse_csr_tensor(
        tile.row_ptr, tile.cols[:nnz][order], sv[:nnz][order],
        size=(tile.n_rows, n_cols), check_invariants=False)


def library_ms(op: str, csr, A, B, Bt) -> float | None:
    """One PyTorch call computing the op, timed as a yardstick:
    ``sampled_addmm`` (the sampled product ``A B^T`` at S's pattern, without
    the value scaling) for SDDMM, ``sparse.mm`` for SpMM, in the operands'
    type; the fused pair has no single call."""
    if op == "sddmm_tile":
        return time_ms(lambda: torch.sparse.sampled_addmm(csr, A, Bt, beta=0.0),
                       KERNEL_REPS)
    if op == "spmm_tile":
        return time_ms(lambda: torch.sparse.mm(csr, B), KERNEL_REPS)
    return None


def rel_err(got, want) -> tuple[float, float]:
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **info})
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    # ptxas's report of every instantiation: registers, spills.
    ptxas = [line.split(":", 1)[-1].strip() for line in info["log"].splitlines()
             if "Used" in line or "spill" in line]
    walks = {name: r for name, r in _build.ptxas_report(info["log"]).items()
             if any(k in name for k in WALK_KERNELS)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "cached": info["cached"],
          "ptxas": ptxas, "walks": walks})
    for kernel in WALK_KERNELS[:2]:
        require(any(kernel in name for name in walks),
                f"ptxas reported no instantiation of {kernel}")
    spilled = {name: r for name, r in walks.items()
               if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    require(not spilled, f"ptxas spills in a walk: {spilled}")


def edge_tile(dev):
    """The edge tile: rows of EDGE["lens"] slots on random columns, then
    the pads; a band listing every row, and the heavy band of the rows
    above EDGE["heavy_above"] slots cut into segments of EDGE["split"]."""
    lens = np.asarray(EDGE["lens"])
    n_rows = lens.size
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    nnz = int(row_ptr[-1])
    cap = nnz + EDGE["pads"]
    rows = np.zeros(cap, np.int32)
    rows[:nnz] = np.repeat(np.arange(n_rows), lens)
    cols = np.zeros(cap, np.int32)
    cols[:nnz] = np.random.default_rng(7).integers(0, EDGE["n_cols"], nnz)

    def put(x):
        return torch.from_numpy(x).to(dev)

    tile = TileView(put(row_ptr), put(rows), put(cols), n_rows, EDGE["n_cols"])
    every = banded.RowBand(None, np.arange(n_rows, dtype=np.int32), nnz).to(dev)
    heavy = np.flatnonzero(lens > EDGE["heavy_above"]).astype(np.int32)
    seg_ptr, owner, beg, end = banded._segments(row_ptr[heavy], row_ptr[heavy + 1],
                                                EDGE["split"])
    hb = banded.RowBand(None, heavy, int(lens[heavy].sum()),
                        seg_ptr=seg_ptr.astype(np.int32), seg_row=heavy[owner],
                        seg_beg=beg.astype(np.int32), seg_end=end.astype(np.int32))
    return tile, every, hb.to(dev), nnz


def edge_stats(dev, tile, every, hb) -> dict:
    """The stats walk at the edges: whole tile rows, one band's row list
    and heavy segments, each against its plain version on standard-normal
    logits with 10% of the gates zeroed, row EDGE_DEAD fully masked and
    row EDGE_ONE with one live slot; gate and logits 16-byte aligned, then
    4 bytes off (the scalar loads). ``m`` exactly the plain version's,
    ``d`` within ATTN_STATS_RTOL, two launches bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(6)
    ck = cuda_kernels
    nnz = int(tile.row_ptr[-1])
    real = (torch.arange(tile.cap, device=dev) < nnz).float()
    z = torch.randn(tile.cap, generator=gen, device=dev) * real
    gate = real * (torch.rand(tile.cap, generator=gen, device=dev) >= 0.1)
    lo, hi = (int(x) for x in tile.row_ptr[EDGE_DEAD: EDGE_DEAD + 2])
    gate[lo:hi] = 0
    lo, hi = (int(x) for x in tile.row_ptr[EDGE_ONE: EDGE_ONE + 2])
    gate[lo:hi] = 0
    gate[lo + (hi - lo) // 2] = 1

    def off(t):
        """``t`` again, 4 bytes past a 16-byte boundary."""
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t
        return buf[1:]

    def runs(plain: bool, g, lz):
        sfx = "_plain" if plain else ""
        m, d = (torch.full((tile.n_rows,), float("nan"), device=dev) for _ in range(2))
        getattr(ck, f"attn_stats_rows{sfx}")(tile, every, g, lz, m, d)
        return {"tile": getattr(ck, f"attn_stats_tile{sfx}")(tile, g, lz),
                "rows": (m, d),
                "split": getattr(ck, f"attn_stats_split{sfx}")(tile, hb, g, lz)}

    worst = {}
    for align, g, lz in (("aligned", gate, z), ("unaligned", off(gate), off(z))):
        require((g.data_ptr() % 16 == 0) == (align == "aligned"), f"edges stats: {align}")
        got, again, want = runs(False, g, lz), runs(False, g, lz), runs(True, g, lz)
        torch.cuda.synchronize()
        for kind, (m, d) in got.items():
            tag = f"edges attn_stats/{kind}/{align}"
            wm, wd = want[kind]
            rel = float(((d - wd).abs() / wd.abs().clamp_min(1e-30)).max())
            require(torch.equal(m, wm), f"{tag}: m differs from the plain version")
            require(rel <= ATTN_STATS_RTOL, f"{tag}: d error {rel:.3e} > {ATTN_STATS_RTOL}")
            require(torch.equal(m, again[kind][0]) and torch.equal(d, again[kind][1]),
                    f"{tag}: two launches differ")
            if kind != "split":
                require(bool(m[EDGE_DEAD] == ATTN_NEG) and float(d[EDGE_DEAD]) == 0.0,
                        f"{tag}: the fully masked row has stats")
                require(float(d[EDGE_ONE]) == 1.0, f"{tag}: one live slot gives d != 1")
            worst[f"attn_stats_{kind}"] = max(worst.get(f"attn_stats_{kind}", 0.0), rel)
    return worst


def rechunk(band, chunk: int, dev):
    """``band`` with its pass-2 unit table built at ``chunk`` segments."""
    return dataclasses.replace(band, chunk=chunk, unit_row=None, unit_beg=None,
                               unit_end=None, counters=None).to(dev)


def check_pass2_twice(tag: str, band, run) -> tuple:
    """``run()`` twice in a row on the card: the same bits, and every
    counter of ``band`` back at 0 (a counter left behind would change the
    second call's sum). Returns the first outputs."""
    got, again = run(), run()
    torch.cuda.synchronize()
    require(all(torch.equal(g, a) for g, a in zip(got, again)),
            f"{tag}: two calls in a row differ")
    require(bool((band.counters == 0).all()), f"{tag}: a counter left non-zero")
    return got


def edge_pass2(dev, tile, hb) -> dict:
    """split_reduce and attn_stats_merge on the edge tile's heavy band at
    each EDGE_PASS2 chunk size: split_reduce against its plain version on
    integer workspaces (bit-equal) and standard-normal ones (within
    KERNEL_TOL f32), aligned and 4 bytes off; the merge on the stats of
    the split walk (row EDGE_DEAD fully masked: (ATTN_NEG, 0)), ``m``
    equal to the plain version's and ``d`` within ATTN_STATS_RTOL; every
    call twice in a row (check_pass2_twice)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    ck = cuda_kernels
    nnz = int(tile.row_ptr[-1])
    real = (torch.arange(tile.cap, device=dev) < nnz).float()
    z = torch.randn(tile.cap, generator=gen, device=dev) * real
    gate = real * (torch.rand(tile.cap, generator=gen, device=dev) >= 0.1)
    lo, hi = (int(x) for x in tile.row_ptr[EDGE_DEAD: EDGE_DEAD + 2])
    gate[lo:hi] = 0
    wm, wd = ck.attn_stats_split_plain(tile, hb, gate, z)
    rows = hb.rows.long()
    dead = hb.rows.tolist().index(EDGE_DEAD)
    worst = {"split_reduce": 0.0, "attn_stats_merge": 0.0}
    for chunk in EDGE_PASS2["chunks"]:
        b = rechunk(hb, chunk, dev)
        for R in EDGE_PASS2["Rs"]:
            for kind in ("integer", "normal", "unaligned"):
                tag = f"edges split_reduce/{kind} at R={R}, chunk {chunk}"
                work = (torch.randint(-3, 4, (b.n_seg, R), generator=gen, device=dev).float()
                        if kind == "integer"
                        else torch.randn(b.n_seg, R, generator=gen, device=dev))

                def run(plain=False):
                    buf = torch.full((tile.n_rows * R + 1,), float("nan"), device=dev)
                    out = buf[int(kind == "unaligned"):][:tile.n_rows * R].view(tile.n_rows, R)
                    (ck.split_reduce_plain if plain else ck.split_reduce)(b, work, out)
                    return (out[rows],)

                got = check_pass2_twice(tag, b, run)
                want = run(plain=True)
                if kind == "integer":
                    require(torch.equal(got[0], want[0]), f"{tag}: not bit-equal to plain")
                rel = rel_err(got[0], want[0])[1]
                require(rel <= KERNEL_TOL["f32"], f"{tag}: error {rel:.3e}")
                worst["split_reduce"] = max(worst["split_reduce"], rel)
        tag = f"edges attn_stats_merge at chunk {chunk}"

        def merge(plain=False):
            m, d = (torch.full((tile.n_rows,), float("nan"), device=dev) for _ in range(2))
            (ck.attn_stats_merge_plain if plain else ck.attn_stats_merge)(b, wm, wd, m, d)
            return m[rows], d[rows]

        (m, d), (pm, pd) = check_pass2_twice(tag, b, merge), merge(plain=True)
        rel = float(((d - pd).abs() / pd.abs().clamp_min(1e-30)).max())
        require(torch.equal(m, pm), f"{tag}: m differs from the plain version")
        require(rel <= ATTN_STATS_RTOL, f"{tag}: d error {rel:.3e}")
        require(bool(m[dead] == ATTN_NEG) and float(d[dead]) == 0.0,
                f"{tag}: the fully masked row has stats")
        worst["attn_stats_merge"] = max(worst["attn_stats_merge"], rel)
    worst.update(long_pass2(dev, gen))
    return {f"{k}/pass2": v for k, v in worst.items()}


def long_pass2(dev, gen) -> dict:
    """Pass 2 on rows longer than any of the edge tile's: a heavy band of
    EDGE_LONG segments a row (the first past the merge's one-block rows,
    the second fully masked, the third empty) over synthetic segment
    partials, at each EDGE_PASS2 chunk size; split_reduce at R = 128 and
    the merge against their plain versions as in edge_pass2."""
    ck = cuda_kernels
    lens = np.asarray(EDGE_LONG)
    seg_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n_seg = int(seg_ptr[-1])
    zeros = np.zeros(n_seg, np.int32)
    band = banded.RowBand(None, np.arange(lens.size, dtype=np.int32), 0, seg_ptr=seg_ptr,
                          seg_row=zeros, seg_beg=zeros, seg_end=zeros)
    work = torch.randn(n_seg, 128, generator=gen, device=dev)
    wm = torch.randn(n_seg, generator=gen, device=dev) * 4
    wd = torch.rand(n_seg, generator=gen, device=dev) * 100
    dead = slice(int(seg_ptr[1]), int(seg_ptr[2]))
    wm[dead], wd[dead] = ATTN_NEG, 0.0
    worst = {"split_reduce": 0.0, "attn_stats_merge": 0.0}
    for chunk in EDGE_PASS2["chunks"]:
        b = rechunk(band, chunk, dev)
        tag = f"edges long rows, chunk {chunk}"

        def reduce(plain=False):
            out = torch.full((lens.size, 128), float("nan"), device=dev)
            (ck.split_reduce_plain if plain else ck.split_reduce)(b, work, out)
            return (out,)

        def merge(plain=False):
            m, d = (torch.full((lens.size,), float("nan"), device=dev) for _ in range(2))
            (ck.attn_stats_merge_plain if plain else ck.attn_stats_merge)(b, wm, wd, m, d)
            return m, d

        rel = rel_err(check_pass2_twice(f"{tag}: split_reduce", b, reduce)[0],
                      reduce(plain=True)[0])[1]
        require(rel <= KERNEL_TOL["f32"], f"{tag}: split_reduce error {rel:.3e}")
        worst["split_reduce"] = max(worst["split_reduce"], rel)
        (m, d), (pm, pd) = check_pass2_twice(f"{tag}: merge", b, merge), merge(plain=True)
        rel = float(((d - pd).abs() / pd.abs().clamp_min(1e-30)).max())
        require(torch.equal(m, pm) and rel <= ATTN_STATS_RTOL,
                f"{tag}: merge m {m.tolist()} vs {pm.tolist()}, d error {rel:.3e}")
        require(bool(m[1] == ATTN_NEG) and float(d[1]) == 0.0,
                f"{tag}: the fully masked row has stats")
        worst["attn_stats_merge"] = max(worst["attn_stats_merge"], rel)
    return worst


def phase_edges(dev) -> dict:
    """The tile walk at the edges (EDGE): SDDMM, SpMM and fused over whole
    tile rows, one band's row list and heavy segments, each against its
    plain version on standard-normal operands (phase 3's tolerances),
    ``mid == 0`` exactly at the pads, two launches bit-equal; then the
    stats walk (:func:`edge_stats`). Launches here are not the main
    path's and are not counted."""
    tile, every, hb, nnz = edge_tile(dev)
    pads = torch.arange(tile.cap, device=dev) >= nnz
    heavy_slots = cuda_kernels._seg_ranges(hb)[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    ck = cuda_kernels

    def nan(*shape):
        return torch.full(shape, float("nan"), device=dev)

    def runs(plain: bool, sv, at, bt):
        """Every (op, kind) once: the outputs each writes, and its mid
        (None for the SpMM)."""
        sfx = "_plain" if plain else ""
        res = {}
        for op in ("sddmm", "fused"):
            got = getattr(ck, f"{op}_tile{sfx}")(tile, sv, at, bt)
            res[(op, "tile")] = as_tuple(got), as_tuple(got)[-1]
            mid, out = nan(tile.cap), nan(tile.n_rows, bt.shape[1])
            if op == "sddmm":
                getattr(ck, f"sddmm_rows{sfx}")(tile, every, sv, at, bt, mid, True)
                res[(op, "rows")] = (mid,), mid
            else:
                getattr(ck, f"fused_rows{sfx}")(tile, every, sv, at, bt, out, mid, True)
                res[(op, "rows")] = (out, mid), mid
            mid = nan(tile.cap)
            work = getattr(ck, f"{op}_split{sfx}")(tile, hb, sv, at, bt, mid, True)
            res[(op, "split")] = ((mid[heavy_slots],) if op == "sddmm"
                                  else (work, mid[heavy_slots])), mid
        out = nan(tile.n_rows, bt.shape[1])
        getattr(ck, f"spmm_rows{sfx}")(tile, every, sv, bt, out)
        res[("spmm", "tile")] = (getattr(ck, f"spmm_tile{sfx}")(tile, sv, bt),), None
        res[("spmm", "rows")] = (out,), None
        res[("spmm", "split")] = (getattr(ck, f"spmm_split{sfx}")(tile, hb, sv, bt),), None
        return res

    worst = {}
    for R in EDGE["Rs"]:
        A = torch.randn(tile.n_rows, R, generator=gen, device=dev)
        B = torch.randn(tile.n_cols, R, generator=gen, device=dev)
        sv = torch.randn(tile.cap, generator=gen, device=dev) * ~pads
        for prec in PRECISIONS:
            k = CudaTileKernel(prec, device=dev)
            at, bt = k.prep(A), k.prep(B)
            got, again, want = runs(False, sv, at, bt), runs(False, sv, at, bt), \
                runs(True, sv, at, bt)
            torch.cuda.synchronize()
            for key, (outs, mid) in got.items():
                tag = f"edges {key[0]}/{key[1]}/{prec} at R={R}"
                rel = max(rel_err(g, w)[1] for g, w in zip(outs, want[key][0]))
                require(rel <= KERNEL_TOL[prec], f"{tag}: error {rel:.3e} > {KERNEL_TOL[prec]}")
                require(mid is None or bool(torch.all(mid[pads] == 0)),
                        f"{tag}: nonzero mid at a pad slot")
                require(all(torch.equal(g, a) for g, a in zip(outs, again[key][0])),
                        f"{tag}: two launches differ")
                name = f"{key[0]}_{key[1]}/{prec}"
                worst[name] = max(worst.get(name, 0.0), rel)
    worst.update(edge_stats(dev, tile, every, hb))
    worst.update(edge_pass2(dev, tile, hb))
    res = {"rows": int(tile.n_rows), "nnz": nnz, "pads": EDGE["pads"], "Rs": EDGE["Rs"],
           "segments": hb.n_seg, "pass2": EDGE_PASS2, "max_rel_err": worst}
    emit({"phase": "edges", **res})
    return res


def compare_kernels(alg, dev, label: str, entries: dict, reps_plain: int) -> None:
    """Every kernel against its plain version on standard-normal operands
    at ``alg``'s S tile; times the kernel, its plain version and the
    library call. Launches here are not the main path's and are not
    counted."""
    tiles = alg.S_tiles
    tile = tiles.tile(0, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(alg.M_pad, alg.R, generator=gen, device=dev)
    B = torch.randn(alg.N_pad, alg.R, generator=gen, device=dev)
    sv = (tiles.mask * torch.randn(tiles.shape, generator=gen, device=dev))[0, 0]
    pads = tiles.mask[0, 0] == 0
    nnz = int(tiles.nnz_per_tile[0, 0])
    Bt = B.t().contiguous()
    for prec in PRECISIONS:
        k = CudaTileKernel(prec, device=dev)
        at, bt = k.prep(A), k.prep(B)
        # The yardstick in the kernel's own operand type: bf16 values, A, B.
        lib_sv = sv if prec == "f32" else sv.bfloat16()
        csr = library_csr(tile, lib_sv, alg.N_pad)
        lib, lib_err = {}, {}
        for op in OPS:
            try:
                lib[op] = library_ms(op, csr, at, bt, k.prep(Bt))
            except RuntimeError as e:  # PyTorch refuses the type: say why
                if prec == "f32":
                    raise
                lib[op], lib_err[op] = None, str(e).strip().splitlines()[0]
        del csr
        for op in OPS:
            got = as_tuple(call(k, op, tile, sv, at, bt))
            again = as_tuple(call(k, op, tile, sv, at, bt))
            want = as_tuple(call_plain(op, tile, sv, at, bt))
            torch.cuda.synchronize()
            if op != "spmm_tile":
                require(bool(torch.all(got[-1][pads] == 0)),
                        f"{op}/{prec} at {label}: nonzero mid at a pad slot")
            record_kernel(entries, op, prec, label,
                          lambda: call(k, op, tile, sv, at, bt),
                          lambda: call_plain(op, tile, sv, at, bt), got, again, want,
                          KERNEL_TOL[prec],
                          bound(op, nnz, alg.M_pad, alg.N_pad, alg.R, at.element_size()),
                          lib[op], lib_err.get(op), reps_plain, nnz)


def run_counted(fn):
    """Zero the launch counters, run ``fn`` (a drive of the main path),
    synchronise and read them."""
    cuda_kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, cuda_kernels.launch_counts()


def phase_verify(S, dev, launches: dict) -> None:
    want = verify.oracle_fingerprints(S, HEADLINE["R"])
    for prec in PRECISIONS:
        for fusion in (2, 1):
            alg = make_algorithm(f"15d_fusion{fusion}", S, HEADLINE["R"],
                                 kernel=CudaTileKernel(prec, device=dev),
                                 device=dev)
            got, counts = run_counted(lambda: verify.fingerprint_algorithm(alg, S))
            rel = {op: abs(got[op] / want[op] - 1) for op in want}
            emit({"phase": "verify", "algorithm": f"15d_fusion{fusion}",
                  "precision": prec, "rtol": VERIFY_RTOL[prec], "rel_err": rel,
                  "fingerprints": got, "oracle": want, "launches": counts})
            require(all(r <= VERIFY_RTOL[prec] for r in rel.values()),
                    f"verify 15d_fusion{fusion}/{prec}: {rel}")
            # fusion 2: sddmmA, spmmA, spmmB, one fused pair;
            # fusion 1: the fused pair is an SDDMM pass then an SpMM pass.
            expect = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
            expect.update({"sddmm_tile": 1, "spmm_tile": 2, "fused_tile": 1}
                          if fusion == 2 else
                          {"sddmm_tile": 2, "spmm_tile": 3, "fused_tile": 0})
            require(counts == expect,
                    f"verify 15d_fusion{fusion}/{prec}: launches {counts} != {expect}")
            add_launches(launches, counts, prec)


def sampled_reference(S: HostCOO, alg, out, mid, dev, rng, heaviest: int = 0) -> float:
    """Relative error of 64 sampled output rows (and the ``heaviest`` rows
    by degree) and their ``mid`` values against float64 on the host (A =
    the dummy fill, B = 0.01)."""
    deg = np.bincount(S.rows, minlength=S.M)
    rows = rng.choice(np.flatnonzero(deg), 64, replace=False)
    rows = np.union1d(rows, np.argsort(deg)[len(deg) - heaviest:])
    R = alg.R
    out_h = out[torch.as_tensor(rows, device=dev)].double().cpu().numpy()
    mid_h = alg.gather_s_values(mid)
    # The host slots of the sampled rows, in one pass over the nonzeros.
    sampled = np.zeros(S.M, dtype=bool)
    sampled[rows] = True
    slots = np.flatnonzero(sampled[S.rows])
    slot_rows = S.rows[slots]
    err = 0.0
    for i, r in enumerate(rows):
        a = r * R + np.arange(R, dtype=np.float64)
        m = float(a.sum()) * 0.01
        want_out = np.full(R, deg[r] * m * 0.01)
        got_mid = mid_h[slots[slot_rows == r]]
        err = max(err, float(np.abs(out_h[i] - want_out).max() / np.abs(want_out).max()),
                  float(np.abs(got_mid - m).max() / abs(m)))
    return err


def phase_full(dev, launches: dict, entries: dict) -> dict:
    t0 = time.perf_counter()
    S = HostCOO.rmat(FULL["log_m"], FULL["edge_factor"], np.random.default_rng(0))
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # Built with its selected variant's bands, which the generic kernel
    # ignores: phase banked times the banked kernel on these tiles.
    variant = select_variant(Problem.from_coo(S, FULL["R"]))
    alg = make_algorithm("15d_fusion2", S, FULL["R"],
                         kernel=BankedCudaKernel(variant, "f32", device=dev), device=dev)
    A = alg.dummy_initialize(MatMode.A)
    B = alg.like_b_matrix(0.01)
    s_vals = alg.like_s_values(1.0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    result = {"nnz": S.nnz, "M": S.M, "R": alg.R, "rmat_seconds": gen_s,
              "setup_seconds": setup_s}
    rng = np.random.default_rng(1)
    for prec in PRECISIONS:
        # The strategy's local kernel is a plain attribute: swapping it
        # reuses the tiles already on the card.
        alg.kernel = CudaTileKernel(prec, device=dev)

        def drive():
            for _ in range(WARMUP_PAIRS):
                alg.fused_spmm(A, B, s_vals, MatMode.A)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(TIMED_PAIRS):
                res = alg.fused_spmm(A, B, s_vals, MatMode.A)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t

        ((out, mid), elapsed), counts = run_counted(drive)
        require(counts["fused_tile"] == WARMUP_PAIRS + TIMED_PAIRS,
                f"full/{prec}: fused launches {counts}")
        add_launches(launches, counts, prec)
        require(tuple(out.shape) == (alg.M_pad, alg.R)
                and bool(torch.isfinite(out).all())
                and bool(torch.isfinite(mid).all()),
                f"full/{prec}: output not finite or of the wrong shape")
        err = sampled_reference(S, alg, out, mid, dev, rng)
        require(err <= VERIFY_RTOL[prec], f"full/{prec}: sampled rows off by {err:.3e}")
        gflops = 2.0 * S.nnz * 2.0 * alg.R * TIMED_PAIRS / elapsed / 1e9
        result[prec] = {"pairs": TIMED_PAIRS, "elapsed_s": elapsed,
                        "ms_per_pair": elapsed / TIMED_PAIRS * 1e3,
                        "gflops": gflops, "sampled_rel_err": err,
                        "launches": counts}
    result["peak_mem_main_path_bytes"] = torch.cuda.max_memory_allocated()
    compare_kernels(alg, dev, "full", entries, PLAIN_REPS)
    result["peak_mem_with_comparisons_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "full", **result})
    return S, alg


# ---------------------------------------------------------------- attention


def attention_inputs(alg, dev, gen):
    """The S tile's attention kernel inputs: standard-normal logits, 10% of
    the gates zeroed and row DEAD_ROW fully masked (0 at pads)."""
    tiles = alg.S_tiles
    tile = tiles.tile(0, 0)
    real = tiles.mask[0, 0]
    z = torch.randn(tile.cap, generator=gen, device=dev) * real
    keep = torch.rand(tile.cap, generator=gen, device=dev) >= 0.1
    gate = real * keep
    lo, hi = (int(x) for x in tile.row_ptr[DEAD_ROW: DEAD_ROW + 2])
    require(hi > lo, f"row {DEAD_ROW} of the attention tile is empty")
    gate[lo:hi] = 0
    return tile, gate.contiguous(), z.contiguous()


def library_softmax(tile, z, n_cols: int):
    """``torch.sparse.softmax`` over the tile's COO logits along dim 1:
    with an all-ones gate the same function as the stats and weights pair
    (a yardstick the port never calls); the COO is built and coalesced
    outside the timed region."""
    nnz = int(tile.row_ptr[-1])
    idx = torch.stack([tile.rows[:nnz].long(), tile.cols[:nnz].long()])
    return torch.sparse_coo_tensor(idx, z[:nnz], (tile.n_rows, n_cols),
                                   check_invariants=False).coalesce()


def compare_attn_kernels(alg, dev, label: str, entries: dict, reps_plain: int) -> None:
    """``attn_stats_tile`` and ``attn_norm_tile`` against their plain
    versions at ``alg``'s S tile; both weights runs take the plain row
    stats, so each kernel is held on its own. Launches here are not the
    main path's and are not counted."""
    gen = torch.Generator(device=dev).manual_seed(0)
    tile, gate, z = attention_inputs(alg, dev, gen)
    nnz = int(alg.S_tiles.nnz_per_tile[0, 0])
    masked = gate == 0
    k = CudaTileKernel("f32", device=dev)
    m, d = k.attn_stats_tile(tile, gate, z)
    m2, d2 = k.attn_stats_tile(tile, gate, z)
    wm, wd = cuda_kernels.attn_stats_tile_plain(tile, gate, z)
    p = k.attn_norm_tile(tile, gate, z, wm, wd)
    p2 = k.attn_norm_tile(tile, gate, z, wm, wd)
    wp = cuda_kernels.attn_norm_tile_plain(tile, gate, z, wm, wd)
    torch.cuda.synchronize()
    stats_abs = max(float((m - wm).abs().max()), float((d - wd).abs().max()))
    stats_rel = max(float(((m - wm).abs() / wm.abs().clamp_min(1e-30)).max()),
                    float(((d - wd).abs() / wd.abs().clamp_min(1e-30)).max()))
    p_abs = float((p - wp).abs().max())
    require(stats_rel <= ATTN_STATS_RTOL,
            f"attn_stats_tile at {label}: error {stats_rel:.3e} > {ATTN_STATS_RTOL}")
    require(p_abs <= ATTN_P_ATOL,
            f"attn_norm_tile at {label}: error {p_abs:.3e} > {ATTN_P_ATOL}")
    require(bool(m[DEAD_ROW] == ATTN_NEG) and float(d[DEAD_ROW]) == 0.0,
            f"attn_stats_tile at {label}: the fully masked row has stats")
    require(bool(torch.all(p[masked] == 0)),
            f"attn_norm_tile at {label}: nonzero weight at a masked or pad slot")
    require(torch.equal(m, m2) and torch.equal(d, d2) and torch.equal(p, p2),
            f"attention kernels at {label}: two launches differ")
    coo = library_softmax(tile, z, alg.N_pad)
    lib = time_ms(lambda: torch.sparse.softmax(coo, 1), reps_plain)
    del coo
    runs = {
        "attn_stats_tile": (lambda: k.attn_stats_tile(tile, gate, z),
                            lambda: cuda_kernels.attn_stats_tile_plain(tile, gate, z),
                            stats_abs, stats_rel, ATTN_STATS_RTOL),
        "attn_norm_tile": (lambda: k.attn_norm_tile(tile, gate, z, wm, wd),
                           lambda: cuda_kernels.attn_norm_tile_plain(tile, gate, z, wm, wd),
                           p_abs, p_abs, ATTN_P_ATOL),
    }
    for op, (kern, plain, abs_err, rel, tol) in runs.items():
        b = attn_bound(op, nnz, tile.n_rows)
        row = {"max_abs_err": abs_err, "max_rel_err": rel, "tol": tol,
               "ms": time_ms(kern, KERNEL_REPS), "plain_ms": time_ms(plain, reps_plain),
               "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
               "bound_gather_ms": b["bound_ms"], "library_ms": lib,
               "library_covers": "attn_stats_tile + attn_norm_tile", "nnz": nnz}
        entries.setdefault((op, "f32"), {})[label] = row
        emit({"phase": f"kernels_{label}", "kernel": op, "precision": "f32", **row})


def attention_breakdown(alg, A, B, reps: int, mode: MatMode = MatMode.A) -> dict:
    """Device ms of each kernel of one fused attention call, timed alone
    on the inputs the call gives it (CUDA events), the ``prep`` casts of
    the two dense operands, and their sum; the call's time less this sum
    is host work, allocation and the value copies. Not counted as main
    path launches."""
    use_st = mode == MatMode.B
    tiles = alg.ST_tiles if use_st else alg.S_tiles
    stat, mov = (B, A) if use_st else (A, B)
    tile, k = tiles.tile(0, 0), alg.kernel
    sv = tiles.like_values(1.0)[0, 0]
    at, bt = k.prep(stat), k.prep(mov)
    z = k.sddmm_tile(tile, sv, at, bt)
    m, d = k.attn_stats_tile(tile, sv, z)
    p = k.attn_norm_tile(tile, sv, z, m, d)
    out = {
        "prep_ms": 2 * time_ms(lambda: k.prep(mov), reps),
        "sddmm_tile_ms": time_ms(lambda: k.sddmm_tile(tile, sv, at, bt), reps),
        "attn_stats_tile_ms": time_ms(lambda: k.attn_stats_tile(tile, sv, z), reps),
        "attn_norm_tile_ms": time_ms(lambda: k.attn_norm_tile(tile, sv, z, m, d), reps),
        "spmm_tile_ms": time_ms(lambda: k.spmm_tile(tile, p, bt), reps),
    }
    out["sum_ms"] = sum(out.values())
    return out


def rel_to(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def phase_attention_verify(dev, launches: dict, entries: dict,
                           log_n: int = ATTN_HEADLINE["log_n"],
                           R: int = ATTN_HEADLINE["R"],
                           specs=ATTN_HEADLINE["masks"]) -> dict:
    n = 1 << log_n
    X = (np.random.default_rng(0).standard_normal((n, R)) / np.sqrt(R)).astype(np.float32)
    ms_per_call = {}
    for spec in specs:
        S = masks.from_spec(spec, n)
        t0 = time.perf_counter()
        want = {MatMode.A: oracle.fused_attention_a(S, X, X),
                MatMode.B: oracle.fused_attention_a(S.transpose(), X, X)}
        oracle_s = time.perf_counter() - t0
        alg = make_algorithm("15d_fusion2", S, R, kernel=CudaTileKernel("f32", device=dev),
                             device=dev, attention=True)
        if spec == specs[0]:
            compare_attn_kernels(alg, dev, "headline", entries, KERNEL_REPS)
        A, B = alg.put_a(X), alg.put_b(X)
        vals = {MatMode.A: alg.like_s_values(1.0), MatMode.B: alg.like_st_values(1.0)}
        deg = np.bincount(S.rows, minlength=n)
        for prec in PRECISIONS:
            alg.kernel = CudaTileKernel(prec, device=dev)
            for mode in (MatMode.A, MatMode.B):
                (out, probs), counts = run_counted(
                    lambda: alg.fused_attention(A, B, vals[mode], mode))
                require(counts == ATTN_CALL,
                        f"attention {spec}/{prec}/{mode.name}: launches {counts}")
                add_launches(launches, counts, prec)
                out_u, probs_u = alg.attention_unfused(A, B, vals[mode], mode)
                require(torch.equal(out, out_u) and torch.equal(probs, probs_u),
                        f"attention {spec}/{prec}/{mode.name}: fused != unfused")
                require(bool(torch.isfinite(out).all()),
                        f"attention {spec}/{prec}/{mode.name}: output not finite")
                if mode == MatMode.A:
                    got_out, got_p = alg.host_a(out), alg.gather_s_values(probs)
                else:
                    got_out, got_p = alg.host_b(out), alg.gather_st_values(probs)
                out_err = rel_to(got_out, want[mode][0])
                p_err = float(np.abs(got_p - want[mode][1]).max())
                ms = time_ms(lambda: alg.fused_attention(A, B, vals[mode], mode),
                             ATTN_CALL_REPS)
                ms_per_call[f"{spec}/{prec}/{mode.name}"] = ms
                emit({"phase": "attention_verify", "mask": spec, "precision": prec,
                      "mode": mode.name, "n": n, "R": R, "nnz": S.nnz,
                      "max_row_nnz": int(deg.max()), "out_rel_err": out_err,
                      "out_rtol": ATTN_OUT_RTOL[prec], "probs_abs_err": p_err,
                      "probs_atol": ATTN_PROBS_ATOL[prec], "ms_per_call": ms,
                      "breakdown": attention_breakdown(alg, A, B, ATTN_CALL_REPS, mode),
                      "launches": counts, "oracle_seconds": oracle_s})
                require(out_err <= ATTN_OUT_RTOL[prec] and p_err <= ATTN_PROBS_ATOL[prec],
                        f"attention {spec}/{prec}/{mode.name}: out {out_err:.3e}, "
                        f"probs {p_err:.3e} off the float64 oracle")
        del alg, A, B, vals
    return ms_per_call


def sampled_attention_reference(S: HostCOO, alg, X, out, probs, rows) -> tuple:
    """Max relative error of the sampled output rows and max absolute
    error of their weights against float64 on the host (A = B = X, unit
    mask, so the logits are the dot products)."""
    out_h = out[torch.as_tensor(rows, device=out.device)].double().cpu().numpy()
    flat = probs.reshape(-1)
    starts = np.searchsorted(S.rows, rows)  # the mask is row-sorted
    ends = np.searchsorted(S.rows, rows, side="right")
    want_out, p_err = [], 0.0
    for r, lo, hi in zip(rows, starts, ends):
        xc = X[S.cols[lo:hi]].astype(np.float64)
        z = xc @ X[r].astype(np.float64)
        e = np.exp(z - z.max())
        p = e / e.sum()
        want_out.append(p @ xc)
        slots = torch.as_tensor(alg.S_tiles.host_to_flat[lo:hi], device=flat.device)
        p_err = max(p_err, float(np.abs(flat[slots].double().cpu().numpy() - p).max()))
    return rel_to(out_h, np.stack(want_out)), p_err


def phase_attention_full(dev, launches: dict, entries: dict,
                         log_n: int = ATTN_FULL["log_n"], R: int = ATTN_FULL["R"],
                         spec: str = ATTN_FULL["mask"],
                         reps_plain: int = PLAIN_REPS) -> dict:
    n = 1 << log_n
    t0 = time.perf_counter()
    S = masks.from_spec(spec, n)
    mask_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    alg = make_algorithm("15d_fusion2", S, R, kernel=CudaTileKernel("f32", device=dev),
                         device=dev, attention=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((n, R)) / np.sqrt(R)).astype(np.float32)
    rows = np.sort(rng.choice(n, 64, replace=False))
    result = {"mask": spec, "n": n, "R": R, "nnz": S.nnz, "mask_seconds": mask_s,
              "tile_setup_seconds": setup_s}
    calls = ATTN_WARMUP + ATTN_TRIALS
    for prec in PRECISIONS:
        alg.kernel = CudaTileKernel(prec, device=dev)
        res = {}
        for fused in (True, False):
            (elapsed, stats), counts = run_counted(
                lambda: harness._run_attention(alg, fused, ATTN_TRIALS, ATTN_WARMUP))
            require(counts == {op: n_ * calls for op, n_ in ATTN_CALL.items()},
                    f"attention_full/{prec}/fused={fused}: launches {counts}")
            add_launches(launches, counts, prec)
            res["fused" if fused else "unfused"] = {
                "trials": ATTN_TRIALS, "elapsed_s": elapsed,
                "ms_per_call": elapsed / ATTN_TRIALS * 1e3,
                "gflops": 2.0 * S.nnz * 2.0 * R * ATTN_TRIALS / elapsed / 1e9,
                "launches": counts}
        res["attention_hbm"] = stats["attention_hbm"]
        res["breakdown"] = attention_breakdown(alg, alg.dummy_initialize(MatMode.A),
                                               alg.dummy_initialize(MatMode.B),
                                               KERNEL_REPS // 2)
        A, B = alg.put_a(X), alg.put_b(X)
        out, probs = alg.fused_attention(A, B, alg.like_s_values(1.0))
        require(tuple(out.shape) == (alg.M_pad, R) and bool(torch.isfinite(out).all())
                and bool(torch.isfinite(probs).all()),
                f"attention_full/{prec}: output not finite or of the wrong shape")
        out_err, p_err = sampled_attention_reference(S, alg, X, out, probs, rows)
        res.update({"sampled_out_rel_err": out_err, "sampled_probs_abs_err": p_err})
        require(out_err <= ATTN_OUT_RTOL[prec] and p_err <= ATTN_PROBS_ATOL[prec],
                f"attention_full/{prec}: sampled rows off by {out_err:.3e} / {p_err:.3e}")
        del A, B, out, probs
        result[prec] = res
    result["peak_mem_main_path_bytes"] = torch.cuda.max_memory_allocated()
    compare_attn_kernels(alg, dev, "full", entries, reps_plain)
    compare_kernels(alg, dev, "window64", entries, reps_plain)
    result["peak_mem_with_comparisons_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "attention_full", **result})
    return result


# ---------------------------------------------------------------- banked


def band_launches(bands, *ops) -> dict:
    """Launches of one banked call of each tile op in ``ops`` over
    ``bands``: a row-list band launches ``<op>_rows``; the heavy band
    ``<op>_split`` and, where an output row sums its segments,
    ``split_reduce`` (``attn_stats``: split and merge); ``attn_norm`` is one
    generic launch over the tile. Every counter is present."""
    counts = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    for op in ops:
        if op == "attn_norm":
            counts["attn_norm_tile"] += 1
            continue
        for b in bands:
            if not b.heavy:
                counts[f"{op}_rows"] += 1
            elif op == "attn_stats":
                counts["attn_stats_split"] += 1
                counts["attn_stats_merge"] += 1
            else:
                counts[f"{op}_split"] += 1
                counts["split_reduce"] += op != "sddmm"
    return counts


def added(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def scaled(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def band_info(tiles) -> list:
    """Rows, nonzeros, segments and heaviest row of each band of tile 0."""
    deg = np.diff(tiles.row_ptr[0, 0].cpu().numpy())
    return [{"npr_max": b.spec.npr_max, "heavy": b.heavy, "rows": b.n_rows,
             "nnz": b.n_slots, "segments": b.n_seg,
             "max_row": int(deg[b.rows.cpu().numpy()].max(initial=0))}
            for b in tiles.tile(0, 0).bands]


def graph500(log_m: int) -> HostCOO:
    """R-mat with the Graph500 initiator: skewed rows and columns."""
    return HostCOO.rmat(log_m, BANKED["edge_factor"], np.random.default_rng(0),
                        **GRAPH500)


def banked_verify(S, variant, dev, launches: dict) -> dict:
    """The verify protocol through ``BankedCudaKernel``, fusion 2 and 1,
    f32 and bf16; launch counts as the band structure predicts, and no
    generic launch."""
    R = BANKED["R"]
    want = verify.oracle_fingerprints(S, R)
    algs = {}
    for fusion in (2, 1):
        alg = make_algorithm(f"15d_fusion{fusion}", S, R,
                             kernel=BankedCudaKernel(variant, "f32", device=dev),
                             device=dev)
        s_b, st_b = alg.S_tiles.tile(0, 0).bands, alg.ST_tiles.tile(0, 0).bands
        pair = ("fused",) if fusion == 2 else ("sddmm", "spmm")
        expect = added(band_launches(s_b, "sddmm", "spmm", *pair),
                       band_launches(st_b, "spmm"))
        for prec in PRECISIONS:
            alg.kernel = BankedCudaKernel(variant, prec, device=dev)
            got, counts = run_counted(lambda: verify.fingerprint_algorithm(alg, S))
            rel = {op: abs(got[op] / want[op] - 1) for op in want}
            emit({"phase": "banked_verify", "algorithm": f"15d_fusion{fusion}",
                  "precision": prec, "variant": variant.variant_id,
                  "rtol": VERIFY_RTOL[prec], "rel_err": rel, "launches": counts,
                  "bands_S": band_info(alg.S_tiles), "bands_ST": band_info(alg.ST_tiles)})
            require(all(r <= VERIFY_RTOL[prec] for r in rel.values()),
                    f"banked verify 15d_fusion{fusion}/{prec}: {rel}")
            require(counts == expect,
                    f"banked verify 15d_fusion{fusion}/{prec}: launches {counts} != {expect}")
            add_launches(launches, counts, prec)
        algs[fusion] = alg
    return algs[2]


def banked_equals_generic(alg, variant, dev, phase: str = "banked_integer") -> dict:
    """Banked and generic agree bit for bit on operands in {-1, 0, 1}, where
    every sum is an integer below 2**24 (rows of up to 10**4 nonzeros, R =
    128), so the split's other summation order cannot show."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def ints(*shape):
        return torch.randint(-1, 2, shape, generator=gen, device=dev).float()

    A, B = ints(alg.M_pad, alg.R), ints(alg.N_pad, alg.R)
    sv = (alg.S_tiles.mask * ints(*alg.S_tiles.shape)).contiguous()
    st = (alg.ST_tiles.mask * ints(*alg.ST_tiles.shape)).contiguous()

    def ops():
        return [alg.sddmm_a(A, B, sv), alg.sddmm_b(A, B, st), alg.spmm_a(A, B, sv),
                alg.spmm_b(A, B, st), *alg.fused_spmm(A, B, sv, MatMode.A),
                *alg.fused_spmm(A, B, st, MatMode.B)]

    alg.kernel = CudaTileKernel("f32", device=dev)
    want = ops()
    alg.kernel = BankedCudaKernel(variant, "f32", device=dev)
    got = ops()
    names = ["sddmmA", "sddmmB", "spmmA", "spmmB", "fusedA", "fusedA_mid", "fusedB",
             "fusedB_mid"]
    equal = {n: torch.equal(g, w) for n, g, w in zip(names, got, want)}
    emit({"phase": phase, "variant": variant.variant_id, "equal": equal,
          "max_abs_out": float(got[4].abs().max())})
    require(all(equal.values()), f"{phase}: banked != generic on integer data: {equal}")
    return equal


def band_csr(tile, sv, bands, n_cols: int):
    """The tile restricted to the rows of ``bands`` as a PyTorch CSR matrix
    of as many rows, columns sorted (cuSPARSE's input); built outside any
    timed region."""
    rows = torch.cat([b.rows for b in bands]).long()
    slots, owner = cuda_kernels._ranges(tile.row_ptr[rows], tile.row_ptr[rows + 1])
    order = torch.argsort(owner * n_cols + tile.cols[slots].long())
    counts = torch.bincount(owner, minlength=rows.numel())
    crow = torch.zeros(rows.numel() + 1, dtype=torch.int64, device=sv.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(crow, tile.cols[slots][order].long(),
                                   sv[slots][order], size=(rows.numel(), n_cols),
                                   check_invariants=False)


def lib_or_reason(fn):
    """``(ms, None)``, or ``(None, reason)`` where PyTorch refuses the call."""
    try:
        return fn(), None
    except RuntimeError as e:
        return None, str(e).strip().splitlines()[0]


def banked_bound(name: str, nnz: int, n_rows: int, n_seg: int, N: int, R: int,
                 esize: int) -> dict:
    """Least time of one banked kernel over its bands: each input read
    once, each output written once, over HBM bandwidth, or its flops over
    the f32 rate. Row-list kernels move what ``bound`` counts for their
    rows; a split pass 1 also writes its workspace (n_seg * R f32) and
    reads its segment table; pass 2 reads the workspace and writes the
    heavy rows; the attention stats read 8 B a slot."""
    if name.endswith("_rows") and not name.startswith("attn"):
        return bound(name.replace("_rows", "_tile"), nnz, n_rows, N, R, esize)
    if name == "attn_stats_rows":
        b = attn_bound("attn_stats_tile", nnz, n_rows)
        return {**b, "gather_ms": b["bound_ms"]}
    op = name.split("_")[0]
    index = nnz * 8 + n_seg * 12
    if name.endswith("_split") and op in ("sddmm", "spmm", "fused"):
        moved = (index + N * R * esize
                 + (n_rows * R * esize + nnz * 4 if op != "spmm" else 0)
                 + (n_seg * R * 4 if op != "sddmm" else 0))
        flops = {"sddmm": 2 * nnz * R + nnz, "spmm": 2 * nnz * R,
                 "fused": 4 * nnz * R + nnz}[op]
    elif name == "split_reduce":
        moved, flops = n_seg * R * 4 + n_rows * (8 + R * 4), n_seg * R
    elif name == "attn_stats_split":
        moved, flops = 8 * nnz + 16 * n_seg, 4 * nnz
    else:  # attn_stats_merge
        moved, flops = 8 * n_seg + 16 * n_rows, 4 * n_seg
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    gathered = 0 if name.startswith("attn") or name == "split_reduce" else nnz * R * esize
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gather_ms": max((moved + gathered) / HBM_BYTES_PER_S * 1e3, t_ops)}


def graph_ms(fn, reps: int) -> float:
    """Device time per call without the host: ``reps`` calls captured in
    one CUDA graph (after a warmup call), the graph replayed and timed as
    time_ms times a call. Captured on a side stream without
    ``torch.cuda.graph``, which empties the allocator's cache and would
    leave the timings after it paying for fresh device allocations."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g.capture_begin()
        for _ in range(reps):
            fn()
        g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return time_ms(g.replay, 3) / reps


def launch_floors(dev) -> dict:
    """The timing methods' floors, for launch-bound kernels: one-element
    ``zero_()`` calls timed as time_ms times a kernel (CUDA events around
    KERNEL_REPS calls: below it a reading is host time) and as graph_ms."""
    one = torch.zeros(1, device=dev)
    return {"launch_floor_ms": time_ms(one.zero_, KERNEL_REPS),
            "graph_launch_floor_ms": graph_ms(one.zero_, KERNEL_REPS)}


def record_kernel(entries, name, prec, label, kern, plain, got, again, want, tol,
                  b, lib, lib_err, reps_plain, nnz, **extra) -> None:
    """Hold one kernel's outputs against its plain version's (max abs
    difference over the max abs plain value within ``tol``), two launches
    bit-equal; time both; file the row under ``entries``."""
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    require(rel <= tol, f"{name}/{prec} at {label}: error {rel:.3e} > {tol}")
    require(all(torch.equal(g, a) for g, a in zip(got, again)),
            f"{name}/{prec} at {label}: two launches differ")
    row = {"max_abs_err": abs_err, "max_rel_err": rel, "tol": tol,
           "ms": time_ms(kern, KERNEL_REPS), "plain_ms": time_ms(plain, reps_plain),
           "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "bound_gather_ms": b["gather_ms"], "library_ms": lib, "nnz": nnz, **extra}
    if lib_err:
        row["library_error"] = lib_err
    entries.setdefault((name, prec), {})[label] = row
    emit({"phase": f"kernels_{label}", "kernel": name, "precision": prec, **row})


def compare_banked_kernels(alg, variant, dev, label: str, entries: dict,
                           reps_plain: int) -> None:
    """Each new tile kernel against its plain version on standard-normal
    operands at ``alg``'s banded S tile, only on what it writes: the
    row-list kernels (all row-list bands, as one call launches them), the
    split's pass 1 (mid at the heavy slots, the workspace) and pass 2 (the
    heavy output rows, from one workspace). Pads must come out 0. Launches
    here are not the main path's."""
    tiles = alg.S_tiles
    tile = tiles.tile(0, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(alg.M_pad, alg.R, generator=gen, device=dev)
    B = torch.randn(alg.N_pad, alg.R, generator=gen, device=dev)
    sv = (tiles.mask * torch.randn(tiles.shape, generator=gen, device=dev))[0, 0]
    pads = tiles.mask[0, 0] == 0
    lists = [b for b in tile.bands if not b.heavy]
    heavy = [b for b in tile.bands if b.heavy]
    require(bool(lists) and len(heavy) == 1, f"banked {label}: bands {band_info(tiles)}")
    hb = heavy[0]
    list_rows = torch.cat([b.rows for b in lists]).long()
    list_slots = torch.cat([cuda_kernels._row_ranges(tile, b)[0] for b in lists])
    heavy_slots = cuda_kernels._row_ranges(tile, hb)[0]
    nnz_list, nnz_heavy = sum(b.n_slots for b in lists), hb.n_slots
    R = alg.R
    for prec in PRECISIONS:
        k = BankedCudaKernel(variant, prec, device=dev)
        at, bt = k.prep(A), k.prep(B)
        esize = at.element_size()
        # Pads: the whole banked op zeroes them in its first launch.
        for op in ("sddmm_tile", "fused_tile"):
            mid = as_tuple(call(k, op, tile, sv, at, bt))[-1]
            require(bool(torch.all(mid[pads] == 0)),
                    f"banked {op}/{prec} at {label}: nonzero mid at a pad slot")
        lib_sv = sv if prec == "f32" else sv.bfloat16()
        csr_l = band_csr(tile, lib_sv, lists, alg.N_pad)
        csr_h = band_csr(tile, lib_sv, heavy, alg.N_pad)
        Bt = k.prep(B.t().contiguous())
        at_l, at_h = at[list_rows], at[hb.rows.long()]
        libs = {
            "sddmm_rows": lambda: time_ms(lambda: torch.sparse.sampled_addmm(
                csr_l, at_l, Bt, beta=0.0), KERNEL_REPS),
            "sddmm_split": lambda: time_ms(lambda: torch.sparse.sampled_addmm(
                csr_h, at_h, Bt, beta=0.0), KERNEL_REPS),
            "spmm_rows": lambda: time_ms(lambda: torch.sparse.mm(csr_l, bt), KERNEL_REPS),
            "spmm_split": lambda: time_ms(lambda: torch.sparse.mm(csr_h, bt), KERNEL_REPS),
        }

        def rows_run(op, plain):
            fn = getattr(cuda_kernels, f"{op}_rows" + ("_plain" if plain else ""))
            out = torch.full((tile.n_rows, R), float("nan"), device=dev)
            mid = torch.full((tile.cap,), float("nan"), device=dev)
            for i, b in enumerate(lists):
                if op == "spmm":
                    fn(tile, b, sv, bt, out)
                elif op == "sddmm":
                    fn(tile, b, sv, at, bt, mid, i == 0)
                else:
                    fn(tile, b, sv, at, bt, out, mid, i == 0)
            return {"sddmm": (mid[list_slots],), "spmm": (out[list_rows],),
                    "fused": (out[list_rows], mid[list_slots])}[op]

        def split_run(op, plain):
            fn = getattr(cuda_kernels, f"{op}_split" + ("_plain" if plain else ""))
            mid = torch.full((tile.cap,), float("nan"), device=dev)
            if op == "spmm":
                return (fn(tile, hb, sv, bt),)
            if op == "sddmm":
                fn(tile, hb, sv, at, bt, mid, False)
                return (mid[heavy_slots],)
            return (fn(tile, hb, sv, at, bt, mid, False), mid[heavy_slots])

        out_t = torch.empty(tile.n_rows, R, device=dev)
        mid_t = torch.empty(tile.cap, device=dev)
        timed = {
            "sddmm_rows": lambda: [cuda_kernels.sddmm_rows(tile, b, sv, at, bt, mid_t, i == 0)
                                   for i, b in enumerate(lists)],
            "spmm_rows": lambda: [cuda_kernels.spmm_rows(tile, b, sv, bt, out_t)
                                  for b in lists],
            "fused_rows": lambda: [cuda_kernels.fused_rows(tile, b, sv, at, bt, out_t, mid_t,
                                                           i == 0)
                                   for i, b in enumerate(lists)],
            "sddmm_split": lambda: cuda_kernels.sddmm_split(tile, hb, sv, at, bt, mid_t, False),
            "spmm_split": lambda: cuda_kernels.spmm_split(tile, hb, sv, bt),
            "fused_split": lambda: cuda_kernels.fused_split(tile, hb, sv, at, bt, mid_t, False),
        }
        for op in ("sddmm", "spmm", "fused"):
            for kind, run, nnz, n_rows in (("rows", rows_run, nnz_list, len(list_rows)),
                                           ("split", split_run, nnz_heavy, hb.n_rows)):
                name = f"{op}_{kind}"
                got, again = run(op, False), run(op, False)
                want = run(op, True)
                torch.cuda.synchronize()
                lib, lib_err = (lib_or_reason(libs[name]) if name in libs
                                else (None, "no single PyTorch call: SDDMM and SpMM fused"))
                record_kernel(entries, name, prec, label, timed[name],
                              lambda: run(op, True), got, again, want, KERNEL_TOL[prec],
                              banked_bound(name, nnz, n_rows, hb.n_seg, alg.N_pad, R, esize),
                              lib, lib_err, reps_plain, nnz,
                              bands=len(lists) if kind == "rows" else 1,
                              segments=hb.n_seg if kind == "split" else 0)
        del csr_l, csr_h, at_l, at_h
    # Pass 2 on one workspace (float32 in both precision modes).
    work = cuda_kernels.spmm_split_plain(tile, hb, sv, B)
    hrows = hb.rows.long()

    def reduce_run(plain):
        out = torch.full((tile.n_rows, R), float("nan"), device=dev)
        (cuda_kernels.split_reduce_plain if plain else cuda_kernels.split_reduce)(hb, work, out)
        return (out[hrows],)

    lengths = torch.diff(hb.seg_ptr.long())
    lib, lib_err = lib_or_reason(lambda: time_ms(
        lambda: torch.segment_reduce(work, "sum", lengths=lengths, axis=0), KERNEL_REPS))
    got = check_pass2_twice(f"split_reduce at {label}", hb, lambda: reduce_run(False))
    record_kernel(entries, "split_reduce", "f32", label,
                  lambda: cuda_kernels.split_reduce(hb, work, out_t),
                  lambda: reduce_run(True), got, reduce_run(False),
                  reduce_run(True), KERNEL_TOL["f32"],
                  banked_bound("split_reduce", nnz_heavy, hb.n_rows, hb.n_seg, alg.N_pad,
                               R, 4),
                  lib, lib_err, reps_plain, nnz_heavy, segments=hb.n_seg,
                  units=hb.n_units, short_rows=hb.n_short, chunk=hb.chunk,
                  graph_ms=graph_ms(lambda: cuda_kernels.split_reduce(hb, work, out_t),
                                    KERNEL_REPS),
                  **launch_floors(dev),
                  library_covers="torch.segment_reduce: the segment sums, unscattered")


def compare_banked_attn_kernels(alg, dev, label: str, entries: dict) -> None:
    """The banked attention stats kernels against their plain versions at
    ``alg``'s banded S tile: standard-normal logits, 10% of the gates
    zeroed, row DEAD_ROW and heavy row 0 fully masked. m and d within
    1e-5 relative, the fully masked rows (ATTN_NEG, 0), two launches
    equal. Launches here are not the main path's."""
    gen = torch.Generator(device=dev).manual_seed(0)
    tile, gate, z = attention_inputs(alg, dev, gen)
    lists = [b for b in tile.bands if not b.heavy]
    hb = [b for b in tile.bands if b.heavy][0]
    require(0 in hb.rows.tolist(), f"banked attention: row 0 not heavy ({band_info(alg.S_tiles)})")
    lo, hi = (int(x) for x in tile.row_ptr[0:2])
    gate[lo:hi] = 0
    list_rows = torch.cat([b.rows for b in lists]).long()
    hrows = hb.rows.long()
    nnz_list = sum(b.n_slots for b in lists)

    def rows_run(plain):
        fn = cuda_kernels.attn_stats_rows_plain if plain else cuda_kernels.attn_stats_rows
        m = torch.full((tile.n_rows,), float("nan"), device=dev)
        d = torch.full_like(m, float("nan"))
        for b in lists:
            fn(tile, b, gate, z, m, d)
        return m[list_rows], d[list_rows]

    def split_run(plain):
        fn = cuda_kernels.attn_stats_split_plain if plain else cuda_kernels.attn_stats_split
        return fn(tile, hb, gate, z)

    wm, wd = split_run(True)

    def merge_run(plain):
        fn = cuda_kernels.attn_stats_merge_plain if plain else cuda_kernels.attn_stats_merge
        m = torch.full((tile.n_rows,), float("nan"), device=dev)
        d = torch.full_like(m, float("nan"))
        fn(hb, wm, wd, m, d)
        return m[hrows], d[hrows]

    m_t = torch.empty(tile.n_rows, device=dev)
    d_t = torch.empty_like(m_t)
    coo_l, coo_h = band_coo(tile, z, lists, alg.N_pad), band_coo(tile, z, [hb], alg.N_pad)
    lib_l = time_ms(lambda: torch.sparse.softmax(coo_l, 1), KERNEL_REPS)
    lib_h = time_ms(lambda: torch.sparse.softmax(coo_h, 1), KERNEL_REPS)
    del coo_l, coo_h
    covers = "torch.sparse.softmax of the same rows: stats and weights"
    runs = {
        "attn_stats_rows": (rows_run, lambda: [cuda_kernels.attn_stats_rows(tile, b, gate, z,
                                                                            m_t, d_t)
                                               for b in lists],
                            nnz_list, len(list_rows), lib_l, None),
        "attn_stats_split": (split_run, lambda: cuda_kernels.attn_stats_split(tile, hb, gate, z),
                             hb.n_slots, hb.n_rows, lib_h, None),
        "attn_stats_merge": (merge_run, lambda: cuda_kernels.attn_stats_merge(hb, wm, wd,
                                                                              m_t, d_t),
                             hb.n_slots, hb.n_rows, None,
                             "no single PyTorch call merges online-softmax pairs"),
    }
    for name, (run, kern, nnz, n_rows, lib, lib_err) in runs.items():
        got, again, want = run(False), run(False), run(True)
        torch.cuda.synchronize()
        pass2 = {}
        if name == "attn_stats_merge":
            got = check_pass2_twice(f"{name} at {label}", hb, lambda: run(False))
            pass2 = {"units": hb.n_units, "short_rows": hb.n_short, "chunk": hb.chunk,
                     "graph_ms": graph_ms(kern, KERNEL_REPS), **launch_floors(dev)}
        m, d = got
        wm_, wd_ = want
        rel = max(float(((m - wm_).abs() / wm_.abs().clamp_min(1e-30)).max()),
                  float(((d - wd_).abs() / wd_.abs().clamp_min(1e-30)).max()))
        require(rel <= ATTN_STATS_RTOL, f"{name} at {label}: error {rel:.3e}")
        extra = {"library_covers": covers} if lib is not None else {}
        record_kernel(entries, name, "f32", label, kern, lambda: run(True), got, again,
                      want, ATTN_STATS_RTOL,
                      banked_bound(name, nnz, n_rows, hb.n_seg, alg.N_pad, alg.R, 4),
                      lib, lib_err, KERNEL_REPS, nnz, segments=hb.n_seg,
                      max_stats_rel_err=rel, **pass2, **extra)
    m, d = merge_run(False)
    i0 = hb.rows.tolist().index(0)
    require(bool(m[i0] == ATTN_NEG) and float(d[i0]) == 0.0,
            f"banked attention at {label}: the fully masked heavy row has stats")


def banked_breakdown(alg, A, B, reps: int, mode: MatMode) -> dict:
    """Device ms of each launch kind of one banked fused attention call,
    timed alone on the inputs the call gives it (CUDA events), and their
    sum. Not counted as main path launches."""
    use_st = mode == MatMode.B
    tiles = alg.ST_tiles if use_st else alg.S_tiles
    stat, mov = (B, A) if use_st else (A, B)
    tile, k = tiles.tile(0, 0), alg.kernel
    sv = tiles.like_values(1.0)[0, 0]
    at, bt = k.prep(stat), k.prep(mov)
    lists = [b for b in tile.bands if not b.heavy]
    heavy = [b for b in tile.bands if b.heavy]
    z = k.sddmm_tile(tile, sv, at, bt)
    m, d = k.attn_stats_tile(tile, sv, z)
    p = k.attn_norm_tile(tile, sv, z, m, d)
    mid = torch.empty(tile.cap, device=sv.device)
    out = torch.empty(tile.n_rows, bt.shape[1], device=sv.device)
    mt, dt = torch.empty_like(m), torch.empty_like(d)
    ck = cuda_kernels
    parts = {
        "prep_ms": lambda: (k.prep(stat), k.prep(mov)),
        "sddmm_rows_ms": lambda: [ck.sddmm_rows(tile, b, sv, at, bt, mid, i == 0)
                                  for i, b in enumerate(lists)],
        "attn_stats_rows_ms": lambda: [ck.attn_stats_rows(tile, b, sv, z, mt, dt)
                                       for b in lists],
        "attn_norm_tile_ms": lambda: k.attn_norm_tile(tile, sv, z, m, d),
        "spmm_rows_ms": lambda: [ck.spmm_rows(tile, b, p, bt, out) for b in lists],
    }
    for hb in heavy:
        work = ck.spmm_split(tile, hb, p, bt)
        wm, wd = ck.attn_stats_split(tile, hb, sv, z)
        parts.update({
            "sddmm_split_ms": lambda: ck.sddmm_split(tile, hb, sv, at, bt, mid, False),
            "attn_stats_split_ms": lambda: ck.attn_stats_split(tile, hb, sv, z),
            "attn_stats_merge_ms": lambda: ck.attn_stats_merge(hb, wm, wd, mt, dt),
            "spmm_split_ms": lambda: ck.spmm_split(tile, hb, p, bt),
            "split_reduce_ms": lambda: ck.split_reduce(hb, work, out),
        })
    res = {name: time_ms(fn, reps) for name, fn in parts.items()}
    res["sum_ms"] = sum(res.values())
    return res


def banked_attention(dev, launches: dict, entries: dict,
                     log_n: int = BANKED["log_n"], R: int = BANKED["R"],
                     spec: str = BANKED["bigbird"]) -> tuple:
    """Bigbird at the attention headline through ``BankedCudaKernel``: A
    and B modes, f32 and bf16, the oracle tolerances of phase 6, fused ==
    unfused, launches as the bands predict, ms per call against the
    generic kernel in turns (generic, banked, banked, generic) and the
    banked call's breakdown."""
    n = 1 << log_n
    X = (np.random.default_rng(0).standard_normal((n, R)) / np.sqrt(R)).astype(np.float32)
    S = masks.from_spec(spec, n)
    want = {MatMode.A: oracle.fused_attention_a(S, X, X),
            MatMode.B: oracle.fused_attention_a(S.transpose(), X, X)}
    variant = select_variant(Problem.from_coo(S, R))
    alg = make_algorithm("15d_fusion2", S, R,
                         kernel=BankedCudaKernel(variant, "f32", device=dev),
                         device=dev, attention=True)
    A, B = alg.put_a(X), alg.put_b(X)
    vals = {MatMode.A: alg.like_s_values(1.0), MatMode.B: alg.like_st_values(1.0)}
    bands = {MatMode.A: alg.S_tiles.tile(0, 0).bands, MatMode.B: alg.ST_tiles.tile(0, 0).bands}
    result = {"mask": spec, "n": n, "R": R, "nnz": S.nnz, "variant": variant.variant_id,
              "bands_S": band_info(alg.S_tiles), "bands_ST": band_info(alg.ST_tiles)}
    for prec in PRECISIONS:
        kernels = {"generic": CudaTileKernel(prec, device=dev),
                   "banked": BankedCudaKernel(variant, prec, device=dev)}
        for mode in (MatMode.A, MatMode.B):
            tag = f"{prec}/{mode.name}"
            alg.kernel = kernels["banked"]
            (out, probs), counts = run_counted(
                lambda: alg.fused_attention(A, B, vals[mode], mode))
            expect = band_launches(bands[mode], "sddmm", "attn_stats", "attn_norm", "spmm")
            require(counts == expect, f"banked attention {tag}: launches {counts} != {expect}")
            add_launches(launches, counts, prec)
            out_u, probs_u = alg.attention_unfused(A, B, vals[mode], mode)
            require(torch.equal(out, out_u) and torch.equal(probs, probs_u),
                    f"banked attention {tag}: fused != unfused")
            require(bool(torch.isfinite(out).all()), f"banked attention {tag}: not finite")
            if mode == MatMode.A:
                got_out, got_p = alg.host_a(out), alg.gather_s_values(probs)
            else:
                got_out, got_p = alg.host_b(out), alg.gather_st_values(probs)
            out_err = rel_to(got_out, want[mode][0])
            p_err = float(np.abs(got_p - want[mode][1]).max())
            require(out_err <= ATTN_OUT_RTOL[prec] and p_err <= ATTN_PROBS_ATOL[prec],
                    f"banked attention {tag}: out {out_err:.3e}, probs {p_err:.3e}")
            ms = {"generic": [], "banked": []}
            for which in ("generic", "banked", "banked", "generic"):
                alg.kernel = kernels[which]
                ms[which].append(time_ms(lambda: alg.fused_attention(A, B, vals[mode], mode),
                                         ATTN_CALL_REPS))
            alg.kernel = kernels["banked"]
            result[tag] = {"out_rel_err": out_err, "probs_abs_err": p_err,
                           "ms_per_call": ms, "launches": counts,
                           "breakdown": banked_breakdown(alg, A, B, ATTN_CALL_REPS, mode)}
            emit({"phase": "banked_attention", "mode_precision": tag, **result[tag]})
    alg.kernel = BankedCudaKernel(variant, "f32", device=dev)
    compare_banked_attn_kernels(alg, dev, "headline", entries)
    return result, alg


def banked_pairs(S, alg, variant, dev, launches: dict, label: str) -> dict:
    """Fused pairs at log_m = 20 (A = the dummy fill, B = 0.01), generic and
    banked in turns (generic, banked, banked, generic), f32 and bf16:
    ms per pair by the host clock around synchronised pairs, banked
    launches as the bands predict, sampled rows (the 8 heaviest among
    them) against float64."""
    bands = alg.S_tiles.tile(0, 0).bands
    A = alg.dummy_initialize(MatMode.A)
    B = alg.like_b_matrix(0.01)
    s_vals = alg.like_s_values(1.0)
    rng = np.random.default_rng(2)
    res = {"nnz": S.nnz, "variant": variant.variant_id, "bands": band_info(alg.S_tiles)}
    warm = 2
    for prec in PRECISIONS:
        kernels = {"generic": CudaTileKernel(prec, device=dev),
                   "banked": BankedCudaKernel(variant, prec, device=dev)}
        ms, err = {"generic": [], "banked": []}, None
        for which in ("generic", "banked", "banked", "generic"):
            alg.kernel = kernels[which]

            def drive():
                for _ in range(warm):
                    alg.fused_spmm(A, B, s_vals, MatMode.A)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(BANKED_PAIRS):
                    r = alg.fused_spmm(A, B, s_vals, MatMode.A)
                torch.cuda.synchronize()
                return r, time.perf_counter() - t

            ((out, mid), elapsed), counts = run_counted(drive)
            expect = (scaled(band_launches(bands, "fused"), warm + BANKED_PAIRS)
                      if which == "banked" else
                      {**dict.fromkeys(counts, 0), "fused_tile": warm + BANKED_PAIRS})
            require(counts == expect, f"{label}/{prec}/{which}: launches {counts}")
            add_launches(launches, counts, prec)
            ms[which].append(elapsed / BANKED_PAIRS * 1e3)
            if which == "banked" and err is None:
                require(bool(torch.isfinite(out).all()) and bool(torch.isfinite(mid).all()),
                        f"{label}/{prec}: output not finite")
                err = sampled_reference(S, alg, out, mid, dev, rng, heaviest=8)
                require(err <= VERIFY_RTOL[prec], f"{label}/{prec}: sampled rows off by {err:.3e}")
        res[prec] = {"ms_per_pair": ms, "pairs": BANKED_PAIRS,
                     "banked_launches_per_pair": band_launches(bands, "fused"),
                     "sampled_rel_err": err}
    alg.kernel = CudaTileKernel("f32", device=dev)
    emit({"phase": "banked_pairs", "cell": label, **res})
    return res


def split_sweep(alg, variant, dev, label: str, attention: bool) -> dict:
    """ms of one banked call at other segment lengths, tile rebanded on the
    host: the fused tile kernel (R-mat) or SDDMM + stats + SpMM (attention),
    f32. Evidence for ``codegen.banded.SPLIT``."""
    tiles = alg.S_tiles
    tile = tiles.tile(0, 0)
    k = BankedCudaKernel(variant, "f32", device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    A = torch.randn(alg.M_pad, alg.R, generator=gen, device=dev)
    B = torch.randn(alg.N_pad, alg.R, generator=gen, device=dev)
    sv = tiles.like_values(1.0)[0, 0]
    res = {}
    for split in SPLITS:
        ban = build_banded(tiles.row_ptr.reshape(-1, tiles.tile_rows + 1), variant, split)
        t = BankedTileView(tile.row_ptr, tile.rows, tile.cols, tile.n_rows, tile.n_cols,
                           bands=tuple(b.to(dev) for b in ban.tiles[0]))

        def call_once():
            if not attention:
                return k.fused_tile(t, sv, A, B)
            z = k.sddmm_tile(t, sv, A, B)
            m, d = k.attn_stats_tile(t, sv, z)
            return k.spmm_tile(t, k.attn_norm_tile(t, sv, z, m, d), B)

        res[str(split)] = time_ms(call_once, ATTN_CALL_REPS)
    emit({"phase": "banked_split_sweep", "cell": label, "ms": res})
    return res


def phase_banked(dev, launches: dict, entries: dict, uniform) -> dict:
    """The banked launches: Graph500 R-mat at log_m 16 (verify, integer
    bit-equality, kernels against plain) and 20 (pairs, kernels against
    plain), bigbird attention at 2**16, and the uniform R-mat of phase
    full (one band after the guard)."""
    t0 = time.perf_counter()
    R = BANKED["R"]
    result = {}
    lo, hi = BANKED["log_ms"]
    S = graph500(lo)
    variant = select_variant(Problem.from_coo(S, R))
    result["graph500_16"] = {"nnz": S.nnz, "variant": variant.variant_id,
                             "host_seconds": time.perf_counter() - t0}
    alg = banked_verify(S, variant, dev, launches)
    banked_equals_generic(alg, variant, dev)
    compare_banked_kernels(alg, variant, dev, "headline", entries, KERNEL_REPS)
    del alg
    t1 = time.perf_counter()
    S = graph500(hi)
    variant = select_variant(Problem.from_coo(S, R))
    alg = make_algorithm("15d_fusion2", S, R,
                         kernel=BankedCudaKernel(variant, "f32", device=dev), device=dev)
    torch.cuda.synchronize()
    result["graph500_20"] = {"host_seconds": time.perf_counter() - t1,
                             **banked_pairs(S, alg, variant, dev, launches, "graph500_20")}
    compare_banked_kernels(alg, variant, dev, "full", entries, PLAIN_REPS)
    result["graph500_20"]["split_ms"] = split_sweep(alg, variant, dev, "graph500_20", False)
    del alg, S
    result["bigbird"], alg_bb = banked_attention(dev, launches, entries)
    result["bigbird"]["split_ms"] = split_sweep(
        alg_bb, alg_bb.kernel.variant, dev, "bigbird", True)
    del alg_bb
    S_u, alg_u = uniform
    v_u = select_variant(Problem.from_coo(S_u, R))
    require(len(alg_u.S_tiles.tile(0, 0).bands) == 1,
            f"uniform R-mat: {band_info(alg_u.S_tiles)} is not one band")
    result["uniform_20"] = banked_pairs(S_u, alg_u, v_u, dev, launches, "uniform_20")
    result["seconds"] = time.perf_counter() - t0
    emit({"phase": "banked", "seconds": result["seconds"],
          "graph500_16": result["graph500_16"],
          "graph500_20_ms_per_pair": {p: result["graph500_20"][p]["ms_per_pair"]
                                      for p in PRECISIONS},
          "uniform_20_ms_per_pair": {p: result["uniform_20"][p]["ms_per_pair"]
                                     for p in PRECISIONS},
          "bigbird_ms_per_call": {t: result["bigbird"][t]["ms_per_call"]
                                  for t in result["bigbird"] if "/" in t}})
    return result


def phase_cli(dev, launches: dict, log_m: int = 16, edge_factor: int = 32,
              R: int = 128, trials: int = 2) -> dict:
    """The ``er`` command in-process on the card (its default kernel,
    cuda-bf16), appending its record under the gitignored build directory."""
    path = _build.BUILD_DIR / "chip_smoke_cli.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    argv = ["er", str(log_m), str(edge_factor), "15d_fusion2", str(R), "1",
            "--app", "attention", "--mask", "window:16", "--trials", str(trials),
            "-o", str(path)]
    rc, counts = run_counted(lambda: cli.main(argv))
    rec = json.loads(path.read_text().splitlines()[-1])
    path.unlink()
    calls = trials + 1  # one warmup call
    require(rc == 0 and rec["app"] == "attention" and rec["mask"] == "window:16"
            and rec["device"] == torch.cuda.get_device_name(0)
            and rec["kernel"] == "cuda-bf16",
            f"cli: rc {rc}, record {rec['app']}/{rec['mask']}/{rec['device']}")
    require(counts == {op: n_ * calls for op, n_ in ATTN_CALL.items()},
            f"cli: launches {counts}")
    add_launches(launches, counts, "bf16")
    info = {k: rec[k] for k in ("app", "mask", "device", "kernel", "elapsed",
                                "overall_throughput", "attention_hbm")}
    emit({"phase": "cli", "argv": argv, "launches": counts, **info})

    # The banked kernel of the matrix's selected variant (vanilla app); the
    # CLI's R-mat row counts predict its launches.
    S = HostCOO.rmat(log_m, edge_factor, np.random.default_rng(0))
    vid = select_variant(Problem.from_coo(S, R)).variant_id
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(S.rows, minlength=S.M))])
    bands = build_banded(row_ptr[None], select_variant(Problem.from_coo(S, R))).tiles[0]
    argv = ["er", str(log_m), str(edge_factor), "15d_fusion2", str(R), "1",
            "--kernel-variant", vid, "--trials", str(trials), "-o", str(path)]
    rc, counts = run_counted(lambda: cli.main(argv))
    rec = json.loads(path.read_text().splitlines()[-1])
    path.unlink()
    require(rc == 0 and rec["kernel_variant"] == vid and rec["app"] == "vanilla"
            and rec["kernel"] == f"cuda-bf16:{vid}",
            f"cli --kernel-variant: rc {rc}, record {rec['kernel']}/{rec['kernel_variant']}")
    expect = scaled(band_launches(bands, "fused"), calls)
    require(counts == expect, f"cli --kernel-variant: launches {counts} != {expect}")
    add_launches(launches, counts, "bf16")
    emit({"phase": "cli", "argv": argv, "launches": counts,
          "bands": [{"rows": b.n_rows, "nnz": b.n_slots} for b in bands],
          "max_row": int(np.diff(row_ptr).max()),
          **{k: rec[k] for k in ("kernel", "kernel_variant", "elapsed",
                                 "overall_throughput")}})
    return info


# ---------------------------------------------------------------- ring


def int_operands(S: HostCOO, R: int):
    """Operands in {-1, 0, 1} (every sum of the ops an exact integer)."""
    rng = np.random.default_rng(5)
    return (rng.integers(-1, 2, (S.M, R)).astype(np.float32),
            rng.integers(-1, 2, (S.N, R)).astype(np.float32),
            rng.integers(-1, 2, S.nnz).astype(np.float32))


def int_outputs(alg, ops) -> dict:
    """Every op of the verify set and the fused pair in both modes, on
    ``ops``, in host order."""
    A_np, B_np, v = ops
    A, B = alg.put_a(A_np), alg.put_b(B_np)
    sv, st = alg.scatter_s_values(v), alg.scatter_st_values(v)
    fa, fa_mid = alg.fused_spmm(A, B, sv, MatMode.A)
    fb, fb_mid = alg.fused_spmm(A, B, st, MatMode.B)
    return {"sddmmA": alg.gather_s_values(alg.sddmm_a(A, B, sv)),
            "sddmmB": alg.gather_st_values(alg.sddmm_b(A, B, st)),
            "spmmA": alg.host_a(alg.spmm_a(A, B, sv)),
            "spmmB": alg.host_b(alg.spmm_b(A, B, st)),
            "fusedA": alg.host_a(fa), "fusedA_mid": alg.gather_s_values(fa_mid),
            "fusedB": alg.host_b(fb), "fusedB_mid": alg.gather_st_values(fb_mid)}


def ring_launches(alg, fusion: int, pair_only: bool = False) -> dict:
    """Launches of the verify protocol (or of one fused pair) at p ranks:
    every ring pass launches one tile kernel a rank a step, p * p/c."""
    n = alg.p * alg.nr
    counts = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    if fusion == 2:
        counts["fused_tile"] = n
        if not pair_only:
            counts.update(sddmm_tile=n, spmm_tile=2 * n)
    else:
        counts.update(sddmm_tile=n, spmm_tile=n)
        if not pair_only:
            counts.update(sddmm_tile=2 * n, spmm_tile=3 * n)
    return counts


def ring_verify(S, dev, launches: dict, card: str) -> None:
    R = HEADLINE["R"]
    want = verify.oracle_fingerprints(S, R)
    ops = int_operands(S, R)
    base = int_outputs(make_algorithm("15d_fusion2", S, R, world=LocalWorld(1),
                                      kernel=CudaTileKernel("f32", device=dev),
                                      device=dev), ops)
    for p, c in RING["verify"]:
        t0 = time.perf_counter()
        alg = make_algorithm("15d_fusion2", S, R, c=c, world=LocalWorld(p),
                             kernel=CudaTileKernel("f32", device=dev), device=dev)
        setup_s = time.perf_counter() - t0
        A, B = alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B)
        sv = alg.like_s_values(1.0)
        for prec in PRECISIONS:
            alg.kernel = CudaTileKernel(prec, device=dev)
            for fusion, overlap in RING_BUILDS:
                alg.fusion_approach, alg.overlap = fusion, overlap
                tag = f"ring verify ({p},{c}) fusion {fusion}{' overlap' if overlap else ''}/{prec}"
                got, counts = run_counted(lambda: verify.fingerprint_algorithm(alg, S))
                _, pair = run_counted(lambda: alg.fused_spmm(A, B, sv))
                rel = {op: abs(got[op] / want[op] - 1) for op in want}
                equal = None
                if prec == "f32":
                    out = int_outputs(alg, ops)
                    equal = {op: bool(np.array_equal(out[op], base[op])) for op in base}
                emit({"phase": "ring_verify", "card": card, "p": p, "c": c,
                      "fusion": fusion, "overlap": overlap, "precision": prec,
                      "setup_seconds": setup_s, "rtol": VERIFY_RTOL[prec],
                      "rel_err": rel, "launches": counts, "pair_launches": pair,
                      "int_equal_p1": equal})
                require(all(r <= VERIFY_RTOL[prec] for r in rel.values()), f"{tag}: {rel}")
                require(counts == ring_launches(alg, fusion), f"{tag}: launches {counts}")
                require(pair == ring_launches(alg, fusion, pair_only=True),
                        f"{tag}: pair launches {pair}")
                require(equal is None or all(equal.values()),
                        f"{tag}: integer outputs differ from p = 1: {equal}")
                add_launches(launches, counts, prec)
        del alg, A, B, sv


def ring_attention(dev, launches: dict, card: str) -> None:
    """``window:16`` at 2**16 tokens, (p, c) = RING["attention"], f32,
    against p = 1."""
    n, R, spec = 1 << ATTN_HEADLINE["log_n"], ATTN_HEADLINE["R"], "window:16"
    p, c = RING["attention"]
    X = (np.random.default_rng(0).standard_normal((n, R)) / np.sqrt(R)).astype(np.float32)
    S = masks.from_spec(spec, n)
    res = {}
    for world in (LocalWorld(1), LocalWorld(p)):
        alg = make_algorithm("15d_fusion2", S, R, c=c if world.p > 1 else 1, world=world,
                             kernel=CudaTileKernel("f32", device=dev), device=dev,
                             attention=True)
        A, B = alg.put_a(X), alg.put_b(X)
        for mode, vals in ((MatMode.A, alg.like_s_values(1.0)),
                           (MatMode.B, alg.like_st_values(1.0))):
            alg.comm.reset_counts()
            (out, probs), counts = run_counted(lambda: alg.fused_attention(A, B, vals, mode))
            host = alg.host_a(out) if mode == MatMode.A else alg.host_b(out)
            pr = (alg.gather_s_values if mode == MatMode.A else alg.gather_st_values)(probs)
            res[(world.p, mode)] = (host, pr, counts, dict(alg.comm.counts),
                                    time_ms(lambda: alg.fused_attention(A, B, vals, mode),
                                            ATTN_CALL_REPS))
            if world.p > 1:
                add_launches(launches, counts, "f32")
        del alg, A, B
    for mode in (MatMode.A, MatMode.B):
        out1, p1, _, _, ms1 = res[(1, mode)]
        out, pr, counts, comm, ms = res[(p, mode)]
        out_err, p_err = rel_to(out, out1), float(np.abs(pr - p1).max())
        n_t = p * (p // c)
        expect = {**dict.fromkeys(cuda_kernels.LAUNCHES, 0), "sddmm_tile": n_t,
                  "spmm_tile": n_t, "attn_stats_tile": n_t, "attn_norm_tile": n_t}
        emit({"phase": "ring_attention", "card": card, "mask": spec, "n": n, "R": R,
              "p": p, "c": c, "mode": mode.name, "out_rel_err_vs_p1": out_err,
              "probs_abs_err_vs_p1": p_err, "launches": counts, "collectives": comm,
              "ms_per_call": ms, "ms_per_call_p1": ms1})
        tag = f"ring attention ({p},{c})/{mode.name}"
        require(np.isfinite(out).all() and out_err <= RING_OUT_RTOL and p_err <= RING_P_ATOL,
                f"{tag}: out {out_err:.3e}, probs {p_err:.3e} off p = 1")
        require(counts == expect, f"{tag}: launches {counts}")
        require(comm["all_reduce"] == 2, f"{tag}: c-axis merge all-reduces {comm}")


def ring_banked(dev, launches: dict, card: str) -> None:
    """Graph500 log_m=16 with its selected variant at RING["banked"]:
    banked == generic on integer data; banked launches as every rank's
    bands predict."""
    R = BANKED["R"]
    p, c = RING["banked"]
    S = graph500(BANKED["log_ms"][0])
    variant = select_variant(Problem.from_coo(S, R))
    alg = make_algorithm("15d_fusion2", S, R, c=c, world=LocalWorld(p),
                         kernel=BankedCudaKernel(variant, "f32", device=dev), device=dev)
    banked_equals_generic(alg, variant, dev, phase="ring_banked_integer")
    A, B = alg.dummy_initialize(MatMode.A), alg.like_b_matrix(0.01)
    sv = alg.like_s_values(1.0)
    alg.kernel = BankedCudaKernel(variant, "f32", device=dev)
    (out, mid), counts = run_counted(lambda: alg.fused_spmm(A, B, sv))
    tiles = alg.S_tiles
    expect = added(*(band_launches(tiles.tile(h, s).bands, "fused")
                     for h in range(p) for s in range(alg.nr)))
    err = sampled_reference(S, alg, out, mid, dev, np.random.default_rng(3), heaviest=8)
    emit({"phase": "ring_banked", "card": card, "p": p, "c": c, "nnz": S.nnz,
          "variant": variant.variant_id, "launches": counts, "sampled_rel_err": err})
    require(counts == expect, f"ring banked: launches {counts} != {expect}")
    require(err <= VERIFY_RTOL["f32"], f"ring banked: sampled rows off by {err:.3e}")
    add_launches(launches, counts, "f32")


def ring_scaling(uniform, dev, launches: dict, card: str) -> dict:
    """The full cell at logical p on this card: the harness's own loop,
    launches a pair, peak memory, the breakdown, and one pair's sampled
    rows against float64."""
    S, alg1 = uniform
    R = FULL["R"]
    rng = np.random.default_rng(4)
    result = {}
    for p, c in RING["scaling"]:
        t0 = time.perf_counter()
        alg = alg1 if p == 1 else make_algorithm(
            "15d_fusion2", S, R, c=c, world=LocalWorld(p),
            kernel=CudaTileKernel("f32", device=dev), device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for prec in PRECISIONS:
            alg.kernel = CudaTileKernel(prec, device=dev)
            torch.cuda.reset_peak_memory_stats()
            elapsed, counts = run_counted(
                lambda: harness._run_vanilla(alg, True, RING_TRIALS, RING_WARMUP))
            peak = torch.cuda.max_memory_allocated()
            pairs = RING_WARMUP + RING_TRIALS
            per_pair = {k: v / pairs for k, v in counts.items() if v}
            require(counts == scaled(ring_launches(alg, 2, pair_only=True), pairs),
                    f"ring scaling ({p},{c})/{prec}: launches {counts}")
            add_launches(launches, counts, prec)
            A, B = alg.dummy_initialize(MatMode.A), alg.dummy_initialize(MatMode.B)
            sv = alg.like_s_values(1.0)
            breakdown = alg.measure_breakdown(A, B, sv, trials=RING_BREAKDOWN_TRIALS)
            # The fused kernel alone on rank 0's first tile, as the ring
            # gives it: its frame of A and the B block of one ring step.
            k, n = alg.kernel, alg.nr * p
            at = k.prep(A[: alg.S_tiles.tile_rows])
            bt = k.prep(B[: alg.localBrows])
            fused_ms = time_ms(lambda: k.fused_tile(alg.S_tiles.tile(0, 0), sv[0, 0], at, bt),
                               KERNEL_REPS)
            del at, bt
            out, mid = alg.fused_spmm(A, alg.like_b_matrix(0.01), sv)
            require(tuple(out.shape) == (alg.M_pad, R) and bool(torch.isfinite(out).all()),
                    f"ring scaling ({p},{c})/{prec}: output not finite or misshapen")
            err = sampled_reference(S, alg, out, mid, dev, rng)
            require(err <= VERIFY_RTOL[prec],
                    f"ring scaling ({p},{c})/{prec}: sampled rows off by {err:.3e}")
            row = {"ms_per_pair": elapsed / RING_TRIALS * 1e3,
                   "gflops": 2.0 * S.nnz * 2.0 * R * RING_TRIALS / elapsed / 1e9,
                   "launches_per_pair": per_pair, "peak_mem_bytes": peak,
                   "breakdown_ms_per_pair": {key: v / RING_BREAKDOWN_TRIALS * 1e3
                                             for key, v in breakdown.items()},
                   "fused_ms_per_launch": fused_ms, "fused_launches_per_pair": n,
                   "fused_nnz_tile00": int(alg.S_tiles.nnz_per_tile[0, 0]),
                   "sampled_rel_err": err}
            result[f"({p},{c})/{prec}"] = row
            emit({"phase": "ring_scaling", "card": card, "p": p, "c": c, "precision": prec,
                  "nnz": S.nnz, "R": R, "setup_seconds": setup_s, "warmup": RING_WARMUP,
                  "pairs": RING_TRIALS, "tile_nnz_max": alg.S_tiles.max_nnz,
                  "comm_profile": alg.comm_profile("fusedSpMM"), **row})
            del out, mid, A, B, sv
        if alg is not alg1:
            del alg
    return result


def ring_nccl(S, dev, launches: dict, card: str) -> None:
    """One process over NCCL (world size 1): the grid self test through
    NCCL collectives, and the headline verify through a ``DistWorld``
    equal to ``LocalWorld``'s bit for bit."""
    path = _build.BUILD_DIR / "nccl_init"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    R = HEADLINE["R"]
    local = make_algorithm("15d_fusion2", S, R, world=LocalWorld(1),
                           kernel=CudaTileKernel("f32", device=dev), device=dev)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0, world_size=1)
    try:
        world = DistWorld()
        grid = make_grid(1, 1, 1, adjacency=1)
        comm = world.comm(grid, dev)
        ok = grid.self_test(comm)
        require(ok, "ring nccl: GridSpec.self_test through NCCL failed")
        alg = make_algorithm("15d_fusion2", S, R, world=world,
                             kernel=CudaTileKernel("f32", device=dev), device=dev)
        require(type(alg.comm).__name__ == "DistComm", "ring nccl: not a DistWorld comm")
        for prec in PRECISIONS:
            for fusion in (2, 1):
                local.kernel = alg.kernel = CudaTileKernel(prec, device=dev)
                local.fusion_approach = alg.fusion_approach = fusion
                want = verify.fingerprint_algorithm(local, S)
                alg.comm.reset_counts()
                got, counts = run_counted(lambda: verify.fingerprint_algorithm(alg, S))
                emit({"phase": "ring_nccl", "card": card, "backend": dist.get_backend(),
                      "world_size": dist.get_world_size(), "self_test": ok,
                      "precision": prec, "fusion": fusion, "equal_local": got == want,
                      "collectives": dict(alg.comm.counts), "launches": counts})
                require(got == want, f"ring nccl {prec}/fusion {fusion}: {got} != {want}")
                require(alg.comm.counts["all_gather"] > 0,
                        "ring nccl: no NCCL collective ran")
                add_launches(launches, counts, prec)
    finally:
        dist.destroy_process_group()
        path.unlink(missing_ok=True)


def phase_ring(S16, uniform, dev, launches: dict, card: str) -> dict:
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    timed("verify", ring_verify, S16, dev, launches, card)
    timed("attention", ring_attention, dev, launches, card)
    timed("banked", ring_banked, dev, launches, card)
    scaling = timed("scaling", ring_scaling, uniform, dev, launches, card)
    timed("nccl", ring_nccl, S16, dev, launches, card)
    emit({"phase": "ring", "card": card, "seconds": time.perf_counter() - t0,
          "seconds_by_part": seconds,
          "scaling_ms_per_pair": {k: v["ms_per_pair"] for k, v in scaling.items()}})
    return scaling


# ---------------------------------------------------------------- apps


def als_launches(steps: int, cg_iters: int, truth: bool = True, residuals: int = 1) -> dict:
    """Generic launches of ``DistributedALS`` at p = 1: the artificial
    ground truth (an SDDMM in each mode), each half-step's right-hand side
    (an SpMM) and its ``cg_iters + 1`` fused pairs, an SDDMM a residual."""
    counts = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    counts.update(sddmm_tile=2 * truth + residuals, spmm_tile=2 * steps,
                  fused_tile=2 * steps * (cg_iters + 1))
    return counts


def gat_launches(forwards: int, heads: int) -> dict:
    counts = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    counts.update(sddmm_tile=forwards * heads, spmm_tile=forwards * heads)
    return counts


def cg_split(als, iters: int) -> dict:
    """An A half-step's CG iterations through the model's own ``cgStep``
    (the code the solver runs), timed in parts by CUDA events (its
    ``mark`` hook): the fused pair and the rest (``+ lambda * p`` and the
    vector algebra), beside the rest's byte bound. Not counted as
    main-path launches."""
    alg = als.d_ops
    lam = als.ridge_lambda
    r = als.compute_rhs(MatMode.A) - als.compute_queries(als.A, als.B, MatMode.A)
    rsold = alg.batch_dot(r, r, MatMode.A)
    X, p = als.A.clone(), r.clone()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters + 1)]
    torch.cuda.synchronize()
    ev[0].record()
    for i in range(iters):
        X, r, p, rsold = als._cg_step(MatMode.A, lam, X, r, p, rsold,
                                      mark=lambda *_, e=ev[2 * i + 1]: e.record())
        ev[2 * i + 2].record()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(X).all()), "als cg split: non-finite factors")
    pair = sum(ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(iters)) / iters
    rest = sum(ev[2 * i + 1].elapsed_time(ev[2 * i + 2]) for i in range(iters)) / iters
    return {"pair_ms": pair, "rest_ms": rest, "iteration_ms": pair + rest,
            "rest_share": rest / (pair + rest), "rest_frames_bound": CG_FRAMES,
            "rest_bound_ms": CG_FRAMES * alg.M_pad * alg.R * 4 / HBM_BYTES_PER_S * 1e3}


def als_full(uniform, dev, launches: dict, card: str) -> dict:
    """ALS at the full cell through the harness's ``_run_als`` (one warmup
    step, timed steps), f32 and bf16; the residual trajectory a step at a
    time from fresh embeddings; a CG iteration split into pair and rest."""
    S, alg = uniform
    it, steps = ALS["cg_iters"], ALS["steps"]
    t0 = time.perf_counter()
    shape_ratio = serial_first_step_ratio(ALS_SHAPE_LOG_M, alg.R, it)
    result = {"float64_first_step_ratio": shape_ratio, "float64_log_m": ALS_SHAPE_LOG_M,
              "float64_seconds": time.perf_counter() - t0}
    for prec in PRECISIONS:
        alg.kernel = CudaTileKernel(prec, device=dev)
        torch.cuda.reset_peak_memory_stats()
        (elapsed, stats), counts = run_counted(
            lambda: harness._run_als(alg, steps, ALS["warmup"], cg_iters=it, S=S))
        peak = torch.cuda.max_memory_allocated()
        expect = als_launches(ALS["warmup"] + steps, it)
        require(counts == expect, f"als full/{prec}: launches {counts} != {expect}")
        add_launches(launches, counts, prec)
        cg = alg.metrics["cgStep"]
        als = als_mod.DistributedALS(alg, S_host=S)
        als.initialize_embeddings()
        traj = [als.compute_residual()]
        for _ in range(steps):
            als.run_cg(1, cg_iters=it)
            traj.append(als.compute_residual())
        split = cg_split(als, it)
        row = {"ms_per_step": elapsed / steps * 1e3, "steps": steps, "cg_iters": it,
               "residual": stats["als_residual"], "trajectory": traj,
               "cg_step_host_ms": cg["seconds"] / cg["calls"] * 1e3,
               "cg_iteration": split, "peak_mem_bytes": peak, "launches": counts,
               "gflops": 2.0 * S.nnz * 2.0 * alg.R * steps / elapsed / 1e9}
        ratio = traj[1] / traj[0]
        row["first_step_ratio"] = ratio
        row["ratio_gap"] = abs(ratio - shape_ratio)
        if prec == "f32":
            row["controls"] = {k: first_step_ratio_with_dropped_slots(S, alg, k, it)
                               for k in ALS_CONTROLS}
            for c in row["controls"].values():
                c["ratio_gap"] = abs(c["first_step_ratio"] - shape_ratio)
        emit({"phase": "apps_als_full", "card": card, "precision": prec, "nnz": S.nnz,
              "R": alg.R, "float64_first_step_ratio": shape_ratio,
              "ratio_tol": ALS_RATIO_TOL, **row})
        require(all(np.isfinite(traj)) and np.isfinite(stats["als_residual"])
                and "als_degraded" not in stats, f"als full/{prec}: {traj}")
        require(ratio < 1 and row["ratio_gap"] <= ALS_RATIO_TOL,
                f"als full/{prec}: trajectory {traj}, first-step ratio {ratio:.6f} against "
                f"float64's {shape_ratio:.6f} at log_m {ALS_SHAPE_LOG_M} "
                f"(tolerance {ALS_RATIO_TOL})")
        if prec == "f32":
            require(all(b < 1.01 * a for a, b in zip(traj[1:], traj[2:])),
                    f"als full/f32: a step raised the residual: {traj}")
            gap = row["controls"][ALS_CONTROL_GATED]["ratio_gap"]
            require(gap > ALS_RATIO_TOL,
                    f"als full: the ratio gate is blind: the control dropping 1 in "
                    f"{ALS_CONTROL_GATED} Gram slots is off by {gap:.3e} only "
                    f"(tolerance {ALS_RATIO_TOL})")
        result[prec] = row
        del als
    return result


def first_step_ratio_with_dropped_slots(S, alg, every: int, cg_iters: int) -> dict:
    """A control for the ratio gate: ``r1 / r0`` of one step whose Gram
    operator (every fused pair of the step: each half-step's initial
    residual and its CG iterations) drops one nonzero slot in ``every`` (a
    partly wrong operator; the right-hand side and the residual see every
    observation)."""
    real = alg.fused_spmm

    def dropped(A, B, s_vals, mode=MatMode.A):
        vals = s_vals.clone()
        vals.view(-1)[::every] = 0
        return real(A, B, vals, mode)

    als = als_mod.DistributedALS(alg, S_host=S)
    als.initialize_embeddings()
    r0 = als.compute_residual()
    alg.fused_spmm = dropped
    try:
        als.run_cg(1, cg_iters=cg_iters)
    finally:
        del alg.fused_spmm
    r1 = als.compute_residual()
    require(np.isfinite(r1), f"als control 1/{every}: residual {r1}")
    return {"every": every, "trajectory": [r0, r1], "first_step_ratio": r1 / r0}


def serial_first_step_ratio(log_m: int, R: int, cg_iters: int) -> float:
    """``r1 / r0`` of the float64 serial solver on a uniform R-mat with the
    full cell's edge factor and R."""
    serial = SerialALS(HostCOO.rmat(log_m, FULL["edge_factor"], np.random.default_rng(0)), R)
    r0 = serial.compute_residual()
    serial.run_cg(1, cg_iters=cg_iters)
    return serial.compute_residual() / r0


def als_protocol(dev, launches: dict, card: str) -> dict:
    """The JAX package's ALS protocol on the card: its problem, its strategy
    (``DenseShift15D``, fusion 2, c = 2 at p = 8, here a ``LocalWorld``),
    its gates, f32."""
    cfg = ALS_PROTOCOL
    S = HostCOO.erdos_renyi(cfg["M"], cfg["N"], cfg["nnz_per_row"], np.random.default_rng(0))
    alg = make_algorithm("15d_fusion2", S, cfg["R"], c=cfg["c"], world=LocalWorld(cfg["p"]),
                         kernel=CudaTileKernel("f32", device=dev), device=dev)
    als = als_mod.DistributedALS(alg, seed=0)
    als.initialize_embeddings()
    traj = [als.compute_residual()]
    for _ in range(2):
        _, counts = run_counted(lambda: als.run_cg(1, cg_iters=cfg["cg_iters"]))
        add_launches(launches, counts, "f32")
        traj.append(als.compute_residual())
    r0, r1, r2 = traj
    rung = als_card_rung(S, alg, cfg["cg_iters"])
    emit({"phase": "apps_als_protocol", "card": card, "nnz": S.nnz, **cfg, "trajectory": traj,
          "card_rung": rung})
    require(r1 < 0.5 * r0 and r2 < 1.01 * r1, f"als protocol: {traj}")
    require(rung["raised"] and "no host fallback" in rung["message"]
            and rung["degraded"] is None and rung["factors_kept"],
            f"als protocol: the ladder's last rung on the card: {rung}")
    return {"trajectory": traj, "card_rung": rung}


def als_card_rung(S, alg, cg_iters: int) -> dict:
    """The ladder on the card: guards on, ``S_host`` given, the public fused
    pair returns NaN for its first two calls outside a ``cgStep`` (each
    half-step's initial residual on the dense shift). The
    damped restart fails as well, and ``run_cg`` must raise
    ``NumericalFault`` rather than continue on the host's serial solver,
    with the factors left as they were."""
    als = als_mod.DistributedALS(alg, seed=0, S_host=S, guard=True)
    als.initialize_embeddings()
    A0, B0 = als.A.clone(), als.B.clone()
    real, hits = alg.fused_spmm, []

    def poisoned(*args, **kw):
        out, mid = real(*args, **kw)
        if not alg._timing and len(hits) < 2:
            hits.append(1)
            out = torch.full_like(out, float("nan"))
        return out, mid

    alg.fused_spmm = poisoned
    message = None
    try:
        als.run_cg(1, cg_iters=cg_iters)
    except NumericalFault as e:
        message = str(e)
    finally:
        del alg.fused_spmm
    return {"raised": message is not None, "message": message, "poisoned_calls": len(hits),
            "degraded": als.degraded,
            "factors_kept": bool(torch.equal(als.A, A0) and torch.equal(als.B, B0))}


def als_oracle(dev, launches: dict, card: str) -> dict:
    """The port's f32 ALS and the float64 serial solver from the same host
    factors and observations."""
    cfg = ALS_ORACLE
    S = HostCOO.rmat(cfg["log_m"], cfg["edge_factor"], np.random.default_rng(0))
    serial = SerialALS(S, cfg["R"], seed=1)
    alg = make_algorithm("15d_fusion2", S, cfg["R"], kernel=CudaTileKernel("f32", device=dev),
                         device=dev)
    als = als_mod.DistributedALS(
        alg, artificial_groundtruth=False, ground_truth_vals=serial.ground_truth,
        ground_truth_vals_transpose=S.with_values(serial.ground_truth).transpose().vals)
    als.A = alg.put_a(serial.A.astype(np.float32))
    als.B = alg.put_b(serial.B.astype(np.float32))
    r0 = (serial.compute_residual(), als.compute_residual())
    serial.run_cg(cfg["steps"], cg_iters=ALS["cg_iters"])
    _, counts = run_counted(lambda: als.run_cg(cfg["steps"], cg_iters=ALS["cg_iters"]))
    expect = als_launches(cfg["steps"], ALS["cg_iters"], truth=False, residuals=0)
    rs, rp = serial.compute_residual(), als.compute_residual()
    rel = {"A": float(np.abs(alg.host_a(als.A) - serial.A).max() / np.abs(serial.A).max()),
           "B": float(np.abs(alg.host_b(als.B) - serial.B).max() / np.abs(serial.B).max())}
    row = {"nnz": S.nnz, "R": cfg["R"], "steps": cfg["steps"], "residual_start": r0,
           "residual_serial": rs, "residual_port": rp, "factor_rel_diff": rel,
           "launches": counts}
    emit({"phase": "apps_als_oracle", "card": card, **row})
    require(counts == expect, f"als oracle: launches {counts} != {expect}")
    require(rs / cfg["slack"] <= rp <= cfg["slack"] * rs,
            f"als oracle: residual {rp} not within {cfg['slack']} x of {rs}")
    require(max(rel.values()) <= cfg["factor_tol"],
            f"als oracle: factors off the float64 ones by {rel} > {cfg['factor_tol']}")
    add_launches(launches, counts, "f32")
    return row


def als_ring(S16, dev, launches: dict, card: str) -> dict:
    """One step at (p, c) on a ``LocalWorld`` against p = 1; two steps of
    the banked kernel (Graph500 16, its variant) against the generic one,
    the banked launches as the bands predict, ``split_reduce`` in B mode."""
    R, it = HEADLINE["R"], ALS["cg_iters"]
    p, c = ALS_RING["grid"]
    factors = {}
    for grid in ((1, 1), (p, c)):
        alg = make_algorithm("15d_fusion2", S16, R, c=grid[1], world=LocalWorld(grid[0]),
                             kernel=CudaTileKernel("f32", device=dev), device=dev)
        als = als_mod.DistributedALS(alg, seed=0)
        _, counts = run_counted(lambda: als.run_cg(1, cg_iters=it))
        add_launches(launches, counts, "f32")
        factors[grid] = (alg.host_a(als.A), alg.host_b(als.B), als.compute_residual(), counts)
        del als, alg
    (a1, b1, r1, _), (ap, bp, rp, cp) = factors[(1, 1)], factors[(p, c)]
    rel = {"A": float(np.abs(ap - a1).max() / np.abs(a1).max()),
           "B": float(np.abs(bp - b1).max() / np.abs(b1).max())}
    result = {"ring": {"p": p, "c": c, "factor_rel_diff": rel, "residual": [r1, rp],
                       "launches": cp}}
    emit({"phase": "apps_als_ring", "card": card, **result["ring"]})
    require(max(rel.values()) <= ALS_RING["tol"], f"als ring ({p},{c}): {rel}")

    S = graph500(HEADLINE["log_m"])
    variant = select_variant(Problem.from_coo(S, R))
    alg = make_algorithm("15d_fusion2", S, R, kernel=BankedCudaKernel(variant, "f32", device=dev),
                         device=dev)
    s_b, st_b = alg.S_tiles.tile(0, 0).bands, alg.ST_tiles.tile(0, 0).bands
    half = {MatMode.A: added(band_launches(s_b, "spmm"), scaled(band_launches(s_b, "fused"), it + 1)),
            MatMode.B: added(band_launches(st_b, "spmm"), scaled(band_launches(st_b, "fused"), it + 1))}
    res = {}
    for name, kernel in (("banked", BankedCudaKernel(variant, "f32", device=dev)),
                         ("generic", CudaTileKernel("f32", device=dev))):
        alg.kernel = kernel
        als = als_mod.DistributedALS(alg, seed=0)
        als.initialize_embeddings()
        counts = {}
        for mode in (MatMode.A, MatMode.B):
            _, counts[mode] = run_counted(lambda: als.cg_optimizer(mode, it))
        _, rest = run_counted(lambda: als.run_cg(ALS_RING["banked_steps"] - 1, cg_iters=it))
        res[name] = als.compute_residual()
        if name == "banked":
            for mode in (MatMode.A, MatMode.B):
                require(counts[mode] == half[mode],
                        f"als banked {mode.name}: launches {counts[mode]} != {half[mode]}")
            require(counts[MatMode.B]["split_reduce"] > 0, "als banked: no split_reduce in B mode")
        add_launches(launches, added(counts[MatMode.A], counts[MatMode.B], rest), "f32")
        del als
    rel_res = abs(res["banked"] / res["generic"] - 1)
    result["banked"] = {"variant": variant.variant_id, "nnz": S.nnz, "residual": res,
                        "rel_diff": rel_res, "launches_A": half[MatMode.A],
                        "launches_B": half[MatMode.B],
                        "bands_S": band_info(alg.S_tiles), "bands_ST": band_info(alg.ST_tiles)}
    emit({"phase": "apps_als_banked", "card": card, **result["banked"]})
    require(rel_res <= ALS_RING["banked_rtol"], f"als banked: residuals {res}")
    return result


def gat_headline(S16, ref, dev, launches: dict, card: str) -> dict:
    """The harness's GAT at the headline size, f32 and bf16, against a
    float64 host forward pass with the same weights (``HostReference``:
    ``oracle.gat_forward`` of the default input, weights drawn on the
    host)."""
    R = HEADLINE["R"]
    alg = make_algorithm("15d_fusion2", S16, R, kernel=CudaTileKernel("f32", device=dev),
                         device=dev)
    gat = gat_mod.GAT(harness._gat_layers(R), alg)
    for layer, ws in zip(gat.layers, gat_host_weights(R, GAT_REF["forward_seed"])):
        layer.weights = [w.float().to(dev) for w in ws]
    heads = sum(layer.num_heads for layer in gat.layers)
    want = ref.forward()
    oracle_s, wait_s = float(want["seconds"]), want["wait_seconds"]
    want = want["forward"][: alg.M]
    scale = float(np.abs(want).max())
    result = {"oracle_seconds": oracle_s, "oracle_wait_seconds": wait_s, "max_abs": scale}
    for prec in PRECISIONS:
        alg.kernel = CudaTileKernel(prec, device=dev)
        out, counts = run_counted(gat.forward)
        got = alg.host_a(out)
        err = float(np.abs(got - want).max()) / scale
        result[prec] = {"rel_err": err, "tol": GAT_TOL[prec], "launches": counts}
        emit({"phase": "apps_gat_headline", "card": card, "precision": prec,
              "shape": list(got.shape), "oracle_seconds": oracle_s,
              "oracle_wait_seconds": wait_s, **result[prec]})
        require(got.shape == want.shape and np.isfinite(got).all(),
                f"gat headline/{prec}: output {got.shape} not finite or misshapen")
        require(err <= GAT_TOL[prec], f"gat headline/{prec}: {err:.3e} > {GAT_TOL[prec]}")
        require(counts == gat_launches(1, heads), f"gat headline/{prec}: launches {counts}")
        add_launches(launches, counts, prec)
    return result


def gat_breakdown(gat) -> list:
    """One forward pass through ``GAT.layer_forward``, the code that
    ``forward`` times, with a CUDA event after each part of each head (its
    ``mark`` hook): the projection, the SDDMM, the SpMM and the elementwise
    work (LeakyReLU, ReLU, the head concat); ms a layer."""
    X = gat.default_input()
    rows = []
    for i, layer in enumerate(gat.layers):
        marks = []

        def mark(part, value=None, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((part, ev))

        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        X = gat.layer_forward(i, X, mark=mark)
        torch.cuda.synchronize()
        parts = dict.fromkeys(("projection", "sddmm", "spmm", "elementwise"), 0.0)
        prev = start
        for part, ev in marks:
            parts[part if part in parts else "elementwise"] += prev.elapsed_time(ev)
            prev = ev
        rows.append({"in": layer.input_features, "heads": layer.num_heads,
                     "out": layer.output_features, **parts, "total_ms": sum(parts.values())})
    require(bool(torch.isfinite(X).all()), "gat breakdown: output not finite")
    return rows


def gat_full(uniform, dev, launches: dict, card: str) -> dict:
    """The harness's ``_run_gat`` at the full cell (1 warmup, 3 timed
    forwards), f32 and bf16, a forward's breakdown per layer, peak
    memory."""
    S, alg = uniform
    R = FULL["R"]
    result = {}
    for prec in PRECISIONS:
        alg.set_r_value(R)
        alg.kernel = CudaTileKernel(prec, device=dev)
        torch.cuda.reset_peak_memory_stats()
        (elapsed, stats), counts = run_counted(
            lambda: harness._run_gat(alg, GAT["forwards"], GAT["warmup"]))
        peak = torch.cuda.max_memory_allocated()
        heads = sum(stats["gat_heads"])
        expect = gat_launches(GAT["warmup"] + GAT["forwards"], heads)
        require(counts == expect, f"gat full/{prec}: launches {counts} != {expect}")
        add_launches(launches, counts, prec)
        alg.set_r_value(R)
        layers = gat_breakdown(gat_mod.GAT(harness._gat_layers(R), alg, seed=0))
        row = {"ms_per_forward": elapsed / GAT["forwards"] * 1e3, "forwards": GAT["forwards"],
               "heads": stats["gat_heads"], "peak_mem_bytes": peak, "launches": counts,
               "layers": layers, "breakdown_total_ms": sum(r["total_ms"] for r in layers)}
        emit({"phase": "apps_gat_full", "card": card, "precision": prec, "nnz": S.nnz,
              "R": R, **row})
        result[prec] = row
    alg.set_r_value(R)
    return result


def cli_apps(dev, launches: dict, card: str) -> dict:
    """``er --app als`` with a checkpoint store, the same resumed from it,
    and ``er --app gat``, in-process on the card (the CLI's default kernel,
    cuda-bf16), under the gitignored build directory."""
    path = _build.BUILD_DIR / "chip_smoke_cli_apps.jsonl"
    ckpt = _build.BUILD_DIR / "chip_smoke_checkpoints"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    it = ALS["cg_iters"]
    R = HEADLINE["R"]
    base = ["er", str(HEADLINE["log_m"]), str(HEADLINE["edge_factor"]), "15d_fusion2",
            str(R), "1", "-o", str(path)]
    runs = (
        ("als", ["--app", "als", "--trials", "2", "--checkpoint-dir", str(ckpt)],
         als_launches(1 + 2, it), [1, 2], 2),
        ("als_resume", ["--app", "als", "--trials", "3", "--checkpoint-dir", str(ckpt),
                        "--resume"], als_launches(1 + 1, it), [1, 2, 3], 1),
        ("gat", ["--app", "gat", "--trials", "2"], gat_launches(3, 14), None, None),
    )
    result = {}
    for name, extra, expect, steps, spmm_a in runs:
        rc, counts = run_counted(lambda: cli.main(base + extra))
        rec = json.loads(path.read_text().splitlines()[-1])
        info = {k: rec.get(k) for k in ("app", "kernel", "device", "elapsed",
                                        "overall_throughput", "als_residual", "cg_iters",
                                        "gat_heads")}
        info["metrics_calls"] = {k: v["calls"] for k, v in rec["metrics"].items()}
        emit({"phase": "apps_cli", "card": card, "run": name, "argv": base + extra,
              "launches": counts, **info})
        require(rc == 0 and rec["kernel"] == "cuda-bf16"
                and rec["device"] == torch.cuda.get_device_name(0), f"cli {name}: {info}")
        require(counts == expect, f"cli {name}: launches {counts} != {expect}")
        if steps is None:
            require(rec["gat_heads"] == [4, 4, 6] and rec["R"] == 6 * R, f"cli {name}: {info}")
        else:
            require(np.isfinite(rec["als_residual"]) and rec["cg_iters"] == it
                    and CheckpointStore(ckpt).steps() == steps
                    and info["metrics_calls"]["spmmA"] == spmm_a, f"cli {name}: {info}")
        add_launches(launches, counts, "bf16")
        result[name] = info
    path.unlink()
    shutil.rmtree(ckpt, ignore_errors=True)
    return result


def phase_apps(S16, uniform, ref, dev, launches: dict, card: str) -> dict:
    t0 = time.perf_counter()
    seconds, out = {}, {}
    for name, fn, args in (("als_protocol", als_protocol, ()), ("als_full", als_full, (uniform,)),
                           ("als_oracle", als_oracle, ()),
                           ("als_ring", als_ring, (S16,)),
                           ("gat_headline", gat_headline, (S16, ref)),
                           ("gat_full", gat_full, (uniform,)), ("cli", cli_apps, ())):
        t = time.perf_counter()
        out[name] = fn(*args, dev, launches, card)
        seconds[name] = time.perf_counter() - t
    emit({"phase": "apps", "card": card, "seconds": time.perf_counter() - t0,
          "seconds_by_part": seconds,
          "als_ms_per_step": {p: out["als_full"][p]["ms_per_step"] for p in PRECISIONS},
          "als_cg_iteration": {p: out["als_full"][p]["cg_iteration"] for p in PRECISIONS},
          "gat_ms_per_forward": {p: out["gat_full"][p]["ms_per_forward"] for p in PRECISIONS}})
    return out


# ---------------------------------------------------------------- strategies


def ring_steps(alg) -> int:
    """Steps of one ring pass: p/c for the 1.5D strategies, sqrt(p/c) for
    the Cannon ones."""
    return getattr(alg, "sqrtpc", None) or alg.nr


def strategy_launches(alg, pair_only: bool = False) -> dict:
    """Generic launches of the verify protocol (or of one fused pair): one
    tile kernel a rank a ring step, ``p * steps`` a pass. The R-split
    strategies' pair is an SDDMM pass and an SpMM pass (their dots are
    complete only after a ring trip, so no fused kernel); the protocol is
    sddmmA, spmmA, spmmB and a pair."""
    if alg.algorithm_name == DenseShift15D.algorithm_name:
        return ring_launches(alg, alg.fusion_approach, pair_only)
    n = alg.p * ring_steps(alg)
    counts = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    counts.update(sddmm_tile=n, spmm_tile=n) if pair_only else counts.update(
        sddmm_tile=2 * n, spmm_tile=3 * n)
    return counts


def strategy_band_launches(alg, pair_only: bool = False) -> dict:
    """Banked launches of the verify protocol (or one pair): each tile is
    held by ``steps`` ranks in a pass, each launching its bands. The A-ops
    of the Cannon dense strategy walk the S^T tiles."""
    a, b = ((alg.ST_tiles, alg.S_tiles) if alg.algorithm_name == CannonDense25D.algorithm_name
            else (alg.S_tiles, alg.ST_tiles))
    n = ring_steps(alg)

    def one(tiles, op):
        return scaled(added(*(band_launches(tiles.tile(h, 0).bands, op)
                              for h in range(alg.p))), n)

    sdd, spa = one(a, "sddmm"), one(a, "spmm")
    return added(sdd, spa) if pair_only else added(sdd, sdd, spa, spa, one(b, "spmm"))


def sampled_ops(S: HostCOO, ops, out: dict, rng) -> float:
    """Relative error (of the sampled values' max abs) of 64 sampled rows of
    spmmA and fusedA, their sddmmA and fused values, and 64 sampled rows of
    spmmB, against float64 on the host."""
    A, B, v = (x.astype(np.float64) for x in ops)
    err = 0.0
    for side, (rows, cols, X, Y, a_op, s_op, f_op, m_op) in (
            ("A", (S.rows, S.cols, A, B, "spmmA", "sddmmA", "fusedA", "fusedA_mid")),
            ("B", (S.cols, S.rows, B, A, "spmmB", "sddmmB", "fusedB", "fusedB_mid"))):
        pick = rng.choice(np.unique(rows), 64, replace=False)
        slots = np.flatnonzero(np.isin(rows, pick))
        r, c = rows[slots], cols[slots]
        mid = v[slots] * np.einsum("kr,kr->k", X[r], Y[c])
        lut = np.full(X.shape[0], -1)
        lut[pick] = np.arange(pick.size)
        spmm = np.zeros((pick.size, Y.shape[1]))
        np.add.at(spmm, lut[r], v[slots, None] * Y[c])
        fused = np.zeros_like(spmm)
        np.add.at(fused, lut[r], mid[:, None] * Y[c])
        for got, want in ((out[a_op][pick], spmm), (out[s_op][slots], mid),
                          (out[f_op][pick], fused), (out[m_op][slots], mid)):
            err = max(err, float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)))
    return err


def strategies_verify(S, dev, launches: dict, card: str) -> dict:
    """The four strategies at STRATEGIES["grids"] on the headline R-mat:
    the verify protocol (fingerprints against float64, launches as the
    ring structure predicts), every op on operands in {-1, 0, 1} equal to
    p = 1's bit for bit (f32), sampled rows of every op on N(0, 1)
    operands against float64; the spmmA fingerprints of the four agree."""
    R = HEADLINE["R"]
    want = verify.oracle_fingerprints(S, R)
    ints = int_operands(S, R)
    rng = np.random.default_rng(6)
    normal = (rng.standard_normal((S.M, R)).astype(np.float32),
              rng.standard_normal((S.N, R)).astype(np.float32),
              rng.standard_normal(S.nnz).astype(np.float32))
    base = verify.op_outputs(make_algorithm("15d_fusion2", S, R, world=LocalWorld(1),
                                            kernel=CudaTileKernel("f32", device=dev),
                                            device=dev), *ints)
    spmm_fps = {}
    for p, c in STRATEGIES["grids"]:
        for name in STRATEGIES["names"]:
            t0 = time.perf_counter()
            alg = make_algorithm(name, S, R, c=c, world=LocalWorld(p),
                                 kernel=CudaTileKernel("f32", device=dev), device=dev)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            for prec in PRECISIONS:
                alg.kernel = CudaTileKernel(prec, device=dev)
                tag = f"strategies verify {name} ({p},{c})/{prec}"
                got, counts = run_counted(lambda: verify.fingerprint_algorithm(alg, S))
                rel = {op: abs(got[op] / want[op] - 1) for op in want}
                equal = None
                if prec == "f32":
                    out, ops_counts = run_counted(lambda: verify.op_outputs(alg, *ints))
                    equal = {op: bool(np.array_equal(out[op], base[op])) for op in base}
                    add_launches(launches, ops_counts, prec)
                out, ops_counts = run_counted(lambda: verify.op_outputs(alg, *normal))
                add_launches(launches, ops_counts, prec)
                normal_err = sampled_ops(S, normal, out, np.random.default_rng(p + c))
                spmm_fps[(name, p, c, prec)] = got["spmmA"]
                emit({"phase": "strategies_verify", "card": card, "algorithm": name,
                      "p": p, "c": c, "precision": prec, "setup_seconds": setup_s,
                      "widths": alg.R // (alg._n_slices()), "rtol": VERIFY_RTOL[prec],
                      "rel_err": rel, "launches": counts, "int_equal_p1": equal,
                      "normal_sampled_rel_err": normal_err})
                require(all(r <= VERIFY_RTOL[prec] for r in rel.values()), f"{tag}: {rel}")
                require(counts == strategy_launches(alg), f"{tag}: launches {counts}")
                require(equal is None or all(equal.values()),
                        f"{tag}: integer outputs differ from p = 1: {equal}")
                require(normal_err <= VERIFY_RTOL[prec], f"{tag}: normal data {normal_err:.3e}")
                add_launches(launches, counts, prec)
            del alg
    fps = np.array([v for (_, _, _, prec), v in spmm_fps.items() if prec == "f32"])
    spread = float(np.abs(fps / fps[0] - 1).max())
    emit({"phase": "strategies_fingerprints", "card": card, "spmmA_f32": {
        f"{n} ({p},{c})": v for (n, p, c, prec), v in spmm_fps.items() if prec == "f32"},
        "oracle": want["spmmA"], "max_rel_spread": spread, "rtol": STRAT_FP_RTOL})
    require(spread <= STRAT_FP_RTOL, f"strategies: spmmA fingerprints spread {spread:.3e}")
    return {"spmmA_max_rel_spread": spread}


def strategies_banked(dev, launches: dict, card: str) -> dict:
    """Graph500 16 with its variant at STRATEGIES["banked"]: the sparse
    shift and the Cannon dense strategy banked equal to generic bit for
    bit on integer data, launches as every tile's bands predict; the
    Cannon sparse strategy builds generic (its realized variant None, one
    ``codegen_generic_fallbacks`` a tile set) and launches the generic
    kernel."""
    R = BANKED["R"]
    p, c = STRATEGIES["banked"]
    S = graph500(BANKED["log_ms"][0])
    variant = select_variant(Problem.from_coo(S, R))
    ints = int_operands(S, R)
    result = {}
    for name in STRATEGIES["r_split"]:
        before = sharding.COUNTERS["codegen_generic_fallbacks"]
        alg = make_algorithm(name, S, R, c=c, world=LocalWorld(p),
                             kernel=BankedCudaKernel(variant, "f32", device=dev), device=dev)
        fallbacks = sharding.COUNTERS["codegen_generic_fallbacks"] - before
        banked = alg.kernel_variant_realized is not None
        got, counts = run_counted(lambda: verify.op_outputs(alg, *ints))
        _, proto = run_counted(lambda: verify.fingerprint_algorithm(alg, S))
        alg.kernel = CudaTileKernel("f32", device=dev)
        want = verify.op_outputs(alg, *ints)
        equal = {op: bool(np.array_equal(got[op], want[op])) for op in want}
        expect = strategy_band_launches(alg) if banked else strategy_launches(alg)
        row = {"variant": variant.variant_id, "realized": alg.kernel_variant_realized,
               "generic_fallbacks": fallbacks, "equal_generic": equal,
               "launches": proto, "ops_launches": counts}
        emit({"phase": "strategies_banked", "card": card, "algorithm": name, "p": p, "c": c,
              "nnz": S.nnz, **row})
        tag = f"strategies banked {name}"
        require(all(equal.values()), f"{tag}: banked != generic on integer data: {equal}")
        require(proto == expect, f"{tag}: launches {proto} != {expect}")
        if name == "25d_sparse_replicate":
            require(not banked and fallbacks == 2, f"{tag}: realized {row['realized']}, "
                    f"{fallbacks} fallbacks")
        else:
            require(banked and fallbacks == 0, f"{tag}: not banked")
        add_launches(launches, counts, "f32")
        add_launches(launches, proto, "f32")
        result[name] = row
        del alg
    return result


def strategy_kernels(alg, name: str, dev, entries: dict) -> None:
    """The SDDMM and SpMM kernels at the shapes the strategy gives them at
    the full cell: rank 0's own tile with R-split operands of its frames,
    standard-normal, against their plain versions; timed with their bounds
    and library calls."""
    label = f"{STRATEGY_LABELS[name]}_full"
    tiles = alg.ST_tiles if name == "25d_dense_replicate" else alg.S_tiles
    tile = tiles.tile(0) if name == "25d_sparse_replicate" else tiles.tile(0, 0)
    mask = (tiles.mask[tiles.floor_slot[0]] if name == "25d_sparse_replicate"
            else tiles.mask[0, 0])
    w = alg.R // alg._n_slices()
    gen = torch.Generator(device=dev).manual_seed(2)
    A = torch.randn(tile.n_rows, w, generator=gen, device=dev)
    B = torch.randn(tile.n_cols, w, generator=gen, device=dev)
    sv = (mask * torch.randn(mask.shape, generator=gen, device=dev)).contiguous()
    nnz = int(tile.row_ptr[-1])
    for prec in PRECISIONS:
        k = CudaTileKernel(prec, device=dev)
        at, bt = k.prep(A), k.prep(B)
        csr = library_csr(tile, sv if prec == "f32" else sv.bfloat16(), tile.n_cols)
        for op in ("sddmm_tile", "spmm_tile"):
            try:
                lib, lib_err = library_ms(op, csr, at, bt, k.prep(B.t().contiguous())), None
            except RuntimeError as e:  # PyTorch refuses the type: say why
                if prec == "f32":
                    raise
                lib, lib_err = None, str(e).strip().splitlines()[0]
            got = as_tuple(call(k, op, tile, sv, at, bt))
            again = as_tuple(call(k, op, tile, sv, at, bt))
            want = as_tuple(call_plain(op, tile, sv, at, bt))
            record_kernel(entries, op, prec, label, lambda: call(k, op, tile, sv, at, bt),
                          lambda: call_plain(op, tile, sv, at, bt), got, again, want,
                          KERNEL_TOL[prec],
                          bound(op, nnz, tile.n_rows, tile.n_cols, w, at.element_size()),
                          lib, lib_err, PLAIN_REPS, nnz, R=w, n_rows=tile.n_rows,
                          n_cols=tile.n_cols)
        del csr


def strategies_full(uniform, dev, launches: dict, entries: dict, card: str,
                    keep: dict | None = None) -> dict:
    """The full cell at STRATEGIES["full"], the four strategies in turn:
    the harness's own loop (STRAT_WARMUP, then STRAT_TRIALS timed pairs),
    launches a pair against the ring structure, peak memory, the tile
    sets' set-up seconds, the breakdown, one pair's sampled rows against
    float64, and the R-split strategies' kernels at their shapes."""
    S = uniform[0]
    R = FULL["R"]
    p, c = STRATEGIES["full"]
    rng = np.random.default_rng(7)
    result = {}
    for name in STRATEGIES["names"]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        alg = make_algorithm(name, S, R, c=c, world=LocalWorld(p),
                             kernel=CudaTileKernel("f32", device=dev), device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for prec in PRECISIONS:
            alg.kernel = CudaTileKernel(prec, device=dev)
            tag = f"strategies full {name} ({p},{c})/{prec}"
            torch.cuda.reset_peak_memory_stats()
            elapsed, counts = run_counted(
                lambda: harness._run_vanilla(alg, True, STRAT_TRIALS, STRAT_WARMUP))
            peak = torch.cuda.max_memory_allocated()
            pairs = STRAT_WARMUP + STRAT_TRIALS
            require(counts == scaled(strategy_launches(alg, pair_only=True), pairs),
                    f"{tag}: launches {counts}")
            add_launches(launches, counts, prec)
            A, B = alg.dummy_initialize(MatMode.A), alg.like_b_matrix(0.01)
            sv = alg.like_s_values(1.0)
            breakdown = alg.measure_breakdown(A, B, sv, trials=STRAT_BREAKDOWN_TRIALS)
            a, b = alg.initial_shift(A, B, KernelMode.SDDMM_A)
            out, mid = alg.fused_spmm(a, b, sv)
            out = alg._to_global(alg.de_shift(out, None, KernelMode.SPMM_A)[0], MatMode.A)
            require(tuple(out.shape) == (alg.M_pad, R) and bool(torch.isfinite(out).all()),
                    f"{tag}: output not finite or misshapen")
            err = sampled_reference(S, alg, out, mid, dev, rng)
            require(err <= VERIFY_RTOL[prec], f"{tag}: sampled rows off by {err:.3e}")
            row = {"ms_per_pair": elapsed / STRAT_TRIALS * 1e3,
                   "gflops": 2.0 * S.nnz * 2.0 * R * STRAT_TRIALS / elapsed / 1e9,
                   "launches_per_pair": {k: v / pairs for k, v in counts.items() if v},
                   "peak_mem_bytes": peak, "setup_seconds": setup_s,
                   "breakdown_ms_per_pair": {key: v / STRAT_BREAKDOWN_TRIALS * 1e3
                                             for key, v in breakdown.items()},
                   "sampled_rel_err": err}
            result[f"{name}/{prec}"] = row
            emit({"phase": "strategies_full", "card": card, "algorithm": name, "p": p,
                  "c": c, "precision": prec, "nnz": S.nnz, "R": R, "warmup": STRAT_WARMUP,
                  "pairs": STRAT_TRIALS, "width": R // alg._n_slices(),
                  "tile_nnz_max": alg.S_tiles.max_nnz, "comm_profile":
                  alg.comm_profile("fusedSpMM"), **row})
            del out, mid, A, B, sv, a, b
        if name in STRATEGIES["r_split"]:
            strategy_kernels(alg, name, dev, entries)
            if keep is not None:  # phase apps_strategies runs on these tiles
                keep[name] = alg
        del alg
    return result


def strategies_nccl(S, dev, launches: dict, card: str) -> None:
    """STRATEGIES["nccl"] over NCCL at world size 1 (its moving tiles take
    the packed path of a world of processes): every op on integer operands
    equal to ``LocalWorld``'s bit for bit, f32 and bf16."""
    path = _build.BUILD_DIR / "nccl_init_strategies"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    R, name = HEADLINE["R"], STRATEGIES["nccl"]
    ints = int_operands(S, R)
    local = make_algorithm(name, S, R, world=LocalWorld(1), device=dev)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0, world_size=1)
    try:
        alg = make_algorithm(name, S, R, world=DistWorld(), device=dev)
        require(not alg.comm.in_process, "strategies nccl: not a DistWorld comm")
        for prec in PRECISIONS:
            local.kernel = alg.kernel = CudaTileKernel(prec, device=dev)
            want = verify.op_outputs(local, *ints)
            alg.comm.reset_counts()
            got, counts = run_counted(lambda: verify.op_outputs(alg, *ints))
            equal = {op: bool(np.array_equal(got[op], want[op])) for op in want}
            emit({"phase": "strategies_nccl", "card": card, "algorithm": name,
                  "backend": dist.get_backend(), "world_size": dist.get_world_size(),
                  "precision": prec, "equal_local": equal,
                  "collectives": dict(alg.comm.counts), "launches": counts})
            require(all(equal.values()), f"strategies nccl {prec}: {equal}")
            require(alg.comm.counts["all_gather"] > 0, "strategies nccl: no NCCL collective")
            add_launches(launches, counts, prec)
    finally:
        dist.destroy_process_group()
        path.unlink(missing_ok=True)


def strategies_cli(dev, launches: dict, card: str) -> dict:
    """``er 12 8 15d|25d|all`` in-process on the card (cuda-bf16) over four
    logical ranks: one record a member that runs; ``all`` with ``--fusion
    overlap``, which the Cannon members refuse, reports them skipped."""
    path = _build.BUILD_DIR / "chip_smoke_cli_strategies.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    p, trials = 4, 2
    every = list(cli.ALG_GROUPS["all"])
    runs = (("15d", [], every[:3], []), ("25d", [], every[3:], []),
            ("all", ["--fusion", "overlap"], every[:3], every[3:]))
    prev = os.environ.get(comm_mod.LOCAL_RANKS_ENV)
    os.environ[comm_mod.LOCAL_RANKS_ENV] = str(p)
    result = {}
    try:
        for group, extra, ran, skipped in runs:
            argv = ["er", "12", "8", group, "128", "1", "--trials", str(trials), "-o",
                    str(path), *extra]
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, counts = run_counted(lambda: cli.main(argv))
            recs = [json.loads(line) for line in path.read_text().splitlines()]
            path.unlink()
            said = [line.split()[1] for line in err.getvalue().splitlines()
                    if line.startswith("skip ")]
            expect = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
            for name in ran:
                steps = p if name.startswith("15d") else math.isqrt(p)
                per = {"fused_tile": p * steps} if name.startswith("15d_fusion2") else {
                    "sddmm_tile": p * steps, "spmm_tile": p * steps}
                for k, v in per.items():
                    expect[k] += v * (trials + 1)
            emit({"phase": "strategies_cli", "card": card, "argv": argv, "ran": [
                r["algorithm"] for r in recs], "skipped": said, "launches": counts,
                "ms_per_pair": {r["algorithm"]: r["elapsed"] / trials * 1e3 for r in recs}})
            require(rc == 0 and [r["algorithm"] for r in recs] == ran and said == skipped,
                    f"strategies cli {group}: ran {[r['algorithm'] for r in recs]}, "
                    f"skipped {said}")
            require(all(r["kernel"] == "cuda-bf16"
                        and r["device"] == torch.cuda.get_device_name(0) for r in recs),
                    f"strategies cli {group}: kernel or device of a record")
            require(counts == expect, f"strategies cli {group}: launches {counts} != {expect}")
            add_launches(launches, counts, "bf16")
            result[group] = {"ran": ran, "skipped": said}
    finally:
        if prev is None:
            os.environ.pop(comm_mod.LOCAL_RANKS_ENV, None)
        else:
            os.environ[comm_mod.LOCAL_RANKS_ENV] = prev
    return result


def phase_strategies(S16, uniform, dev, launches: dict, entries: dict, card: str) -> dict:
    t0 = time.perf_counter()
    seconds, out = {}, {}
    for part, fn, args in (("verify", strategies_verify, (S16,)),
                           ("banked", strategies_banked, ()),
                           ("full", strategies_full, (uniform,)),
                           ("nccl", strategies_nccl, (S16,)),
                           ("cli", strategies_cli, ())):
        t = time.perf_counter()
        if part == "full":
            out["algs"] = {}
            out[part] = fn(*args, dev, launches, entries, card, keep=out["algs"])
        else:
            out[part] = fn(*args, dev, launches, card)
        seconds[part] = time.perf_counter() - t
    emit({"phase": "strategies", "card": card, "seconds": time.perf_counter() - t0,
          "seconds_by_part": seconds,
          "full_ms_per_pair": {k: v["ms_per_pair"] for k, v in out["full"].items()}})
    return out


# ---------------------------------------------------------------- training
# Gradients through the strategies (``ops/autograd.py``): the tile ops'
# backward runs the SDDMM and SpMM tile kernels in new roles, and the
# column scatters are ``index_add_`` on the card.


@contextlib.contextmanager
def plain_calls():
    """Count every call of a plain version of ``ops/cuda_kernels.py`` while
    the ``with`` block runs (a CUDA tensor must never reach one); yields
    the list of the names called."""
    saved = {n: getattr(cuda_kernels, n) for n in dir(cuda_kernels) if n.endswith("_plain")}
    calls: list = []

    def spy(name, fn):
        def run(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return run

    for n, fn in saved.items():
        setattr(cuda_kernels, n, spy(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(cuda_kernels, n, fn)


def grad_operands(S: HostCOO, R: int, seed: int) -> dict:
    """N(0, 1) operands, values and cotangents of the output and the values
    in host order, float32."""
    rng = np.random.default_rng(seed)
    return {"A": rng.standard_normal((S.M, R)).astype(np.float32),
            "B": rng.standard_normal((S.N, R)).astype(np.float32),
            "v": rng.standard_normal(S.nnz).astype(np.float32),
            "g_out": rng.standard_normal((S.M, R)).astype(np.float32),
            "g_mid": rng.standard_normal(S.nnz).astype(np.float32)}


def op_grads(alg, op: str, ops: dict, counts: dict | None = None) -> dict:
    """``(gA, gB, g_sv)`` in host order of one op through the strategy's
    public ops (with its shifts), the cotangents ``g_out`` / ``g_mid`` put
    in its layouts. With ``counts`` the forward's and the backward's launch
    counts land there, each read from zeroed counters, and beside them the
    same split by the type of the operands each launch read."""
    A = alg.put_a(ops["A"]).requires_grad_()
    B = alg.put_b(ops["B"]).requires_grad_()
    sv = alg.scatter_s_values(ops["v"]).requires_grad_()
    g_out, g_mid = alg.put_a(ops["g_out"]), alg.scatter_s_values(ops["g_mid"])
    cuda_kernels.reset_launch_counts()
    if op == "spmm":
        z, b = alg.initial_shift(alg.like_a_matrix(0.0), B, KernelMode.SPMM_A)
        outs, cots = (alg.de_shift(alg.spmm_a(z, b, sv), None, KernelMode.SPMM_A)[0],), (g_out,)
    else:
        a, b = alg.initial_shift(A, B, KernelMode.SDDMM_A)
        if op == "sddmm":
            outs, cots = (alg.sddmm_a(a, b, sv),), (g_mid,)
        else:
            out, mid = alg.fused_spmm(a, b, sv, MatMode.A)
            outs = (alg.de_shift(out, None, KernelMode.SPMM_A)[0], mid)
            cots = (g_out, g_mid)
    if counts is not None:
        torch.cuda.synchronize()
        counts["forward"], counts["forward_by_type"] = cuda_kernels.launch_counts(), by_type()
        cuda_kernels.reset_launch_counts()
    grads = torch.autograd.grad(outs, (A, B, sv), cots, allow_unused=True)
    torch.cuda.synchronize()
    if counts is not None:
        counts["backward"], counts["backward_by_type"] = cuda_kernels.launch_counts(), by_type()
    gA, gB, gv = (torch.zeros_like(x) if g is None else g for g, x in zip(grads, (A, B, sv)))
    return {"gA": alg.host_a(gA), "gB": alg.host_b(gB), "g_sv": alg.gather_s_values(gv)}


def grad_reference(S: HostCOO, op: str, ops: dict, rows, cols) -> dict:
    """The grads of ``op`` in float64 on the host, the JAX package's
    formulas: ``gA`` at the rows ``rows`` and ``g_sv`` at their nonzeros
    (in host order), ``gB`` at the columns ``cols``."""
    A, B, v, Go, Gm = (ops[k].astype(np.float64) for k in ("A", "B", "v", "g_out", "g_mid"))
    out: dict = {}
    k = np.flatnonzero(np.isin(S.rows, rows))
    r, c = S.rows[k], S.cols[k]
    dots = np.einsum("kr,kr->k", A[r], B[c])
    lut = np.full(S.M, -1)
    lut[rows] = np.arange(len(rows))
    gA = np.zeros((len(rows), A.shape[1]))
    if op == "spmm":
        out["g_sv"] = np.einsum("kr,kr->k", Go[r], B[c])
    else:
        g = Gm[k] if op == "sddmm" else Gm[k] + np.einsum("kr,kr->k", Go[r], B[c])
        out["g_sv"] = g * dots
        np.add.at(gA, lut[r], (g * v[k])[:, None] * B[c])
    out["gA"], out["slots"] = gA, k
    k = np.flatnonzero(np.isin(S.cols, cols))
    r, c = S.rows[k], S.cols[k]
    lut = np.full(S.N, -1)
    lut[cols] = np.arange(len(cols))
    gB = np.zeros((len(cols), B.shape[1]))
    if op == "spmm":
        np.add.at(gB, lut[c], v[k, None] * Go[r])
    else:
        dots = np.einsum("kr,kr->k", A[r], B[c])
        g = Gm[k] if op == "sddmm" else Gm[k] + np.einsum("kr,kr->k", Go[r], B[c])
        contrib = (g * v[k])[:, None] * A[r]
        if op == "fused":
            contrib += (v[k] * dots)[:, None] * Go[r]
        np.add.at(gB, lut[c], contrib)
    out["gB"] = gB
    return out


def max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def grads_rel(got: dict, want: dict) -> float:
    return max(max_rel(got[k], want[k]) for k in ("gA", "gB", "g_sv"))


def training_headline(S16, dev, launches: dict, card: str) -> dict:
    """The sddmm, spmm and fused grads at the headline R-mat, p = 1, f32 and
    bf16, against float64 on 64 sampled rows and their nonzeros (and 64
    sampled columns for ``gB``); each backward's launches as the design
    says, and no plain version called."""
    R = HEADLINE["R"]
    alg = make_algorithm("15d_fusion2", S16, R, kernel=CudaTileKernel("f32", device=dev),
                         device=dev)
    ops = grad_operands(S16, R, seed=11)
    rng = np.random.default_rng(12)
    rows = rng.choice(np.unique(S16.rows), TRAINING["sample"], replace=False)
    cols = rng.choice(np.unique(S16.cols), TRAINING["sample"], replace=False)
    result = {}
    for prec in PRECISIONS:
        alg.kernel = CudaTileKernel(prec, device=dev)
        # The forward reads bf16 operands: so does the reference.
        ref_ops = dict(ops)
        if prec == "bf16":
            for key in ("A", "B"):
                ref_ops[key] = torch.from_numpy(ops[key]).bfloat16().float().numpy()
        for op in ("sddmm", "spmm", "fused"):
            counts: dict = {}
            with plain_calls() as plain:
                got = op_grads(alg, op, ops, counts)
            want = grad_reference(S16, op, ref_ops, rows, cols)
            err = {"gA": max_rel(got["gA"][rows], want["gA"]),
                   "gB": max_rel(got["gB"][cols], want["gB"]),
                   "g_sv": max_rel(got["g_sv"][want["slots"]], want["g_sv"])}
            tag = f"training grads {op}/{prec}"
            emit({"phase": "training_grads", "card": card, "op": op, "precision": prec,
                  "nnz": S16.nnz, "R": R, "rel_err": err, "tol": TRAINING["grad_tol"][prec],
                  "launches_forward": counts["forward"],
                  "launches_backward": counts["backward"],
                  "launches_bf16": {k: counts[f"{k}_by_type"]["bf16"]
                                    for k in ("forward", "backward")},
                  "plain_calls": len(plain)})
            require(max(err.values()) <= TRAINING["grad_tol"][prec], f"{tag}: {err}")
            want_bwd = {**dict.fromkeys(cuda_kernels.LAUNCHES, 0), **BACKWARD_LAUNCHES[op]}
            require(counts["backward"] == want_bwd,
                    f"{tag}: backward launches {counts['backward']} != {want_bwd}")
            require(not plain, f"{tag}: plain versions ran on the card: {sorted(set(plain))}")
            # The forward's kernels read the drive's type; the backward's
            # read float32 operands in both modes.
            fwd = counts["forward_by_type"]
            require(fwd[prec] == counts["forward"],
                    f"{tag}: forward launches on other operands than {prec}: {fwd}")
            bwd_bf16 = counts["backward_by_type"]["bf16"]
            require(not any(bwd_bf16.values()),
                    f"{tag}: the backward launched on bf16 operands: {bwd_bf16}")
            add_by_type(launches, fwd)
            add_by_type(launches, counts["backward_by_type"])
            result[f"{op}/{prec}"] = err
    return result


def training_banked(dev, launches: dict, card: str) -> dict:
    """Graph500 16 with its variant, fusion 2, f32: the fused pair's grads
    through the banked kernel equal the generic kernel's; the backward
    launches the bands' SDDMM twice and their SpMM once, no generic
    launch."""
    R = BANKED["R"]
    S = graph500(BANKED["log_ms"][0])
    variant = select_variant(Problem.from_coo(S, R))
    alg = make_algorithm("15d_fusion2", S, R, kernel=BankedCudaKernel(variant, "f32", device=dev),
                         device=dev)
    ops = grad_operands(S, R, seed=13)
    counts: dict = {}
    with plain_calls() as plain:
        banked = op_grads(alg, "fused", ops, counts)
    bands = alg.S_tiles.tile(0, 0).bands
    expect = added(band_launches(bands, "sddmm"), band_launches(bands, "sddmm"),
                   band_launches(bands, "spmm"))
    alg.kernel = CudaTileKernel("f32", device=dev)
    generic = op_grads(alg, "fused", ops)
    err = grads_rel(banked, generic)
    row = {"variant": variant.variant_id, "nnz": S.nnz, "rel_diff_generic": err,
           "launches_forward": counts["forward"], "launches_backward": counts["backward"],
           "bands": band_info(alg.S_tiles)}
    emit({"phase": "training_banked", "card": card, **row})
    require(err <= TRAINING["strategy_tol"], f"training banked: {err:.3e} from generic")
    require(counts["backward"] == expect,
            f"training banked: backward launches {counts['backward']} != {expect}")
    require(not plain, f"training banked: plain versions ran: {sorted(set(plain))}")
    add_by_type(launches, counts["forward_by_type"])
    add_by_type(launches, counts["backward_by_type"])
    return row


def training_strategies(S16, dev, launches: dict, card: str) -> dict:
    """The four strategies at TRAINING["grid"], f32: the grads of each op
    within ``strategy_tol`` of p = 1's."""
    R = HEADLINE["R"]
    p, c = TRAINING["grid"]
    ops = grad_operands(S16, R, seed=14)
    base = make_algorithm("15d_fusion2", S16, R, world=LocalWorld(1),
                          kernel=CudaTileKernel("f32", device=dev), device=dev)
    want = {op: op_grads(base, op, ops) for op in ("sddmm", "spmm", "fused")}
    del base
    result = {}
    for name in STRATEGIES["names"]:
        alg = make_algorithm(name, S16, R, c=c, world=LocalWorld(p),
                             kernel=CudaTileKernel("f32", device=dev), device=dev)
        err = {}
        for op in want:
            cuda_kernels.reset_launch_counts()
            with plain_calls() as plain:
                err[op] = grads_rel(op_grads(alg, op, ops), want[op])
            add_by_type(launches, by_type())
            require(not plain, f"training {name}: plain versions ran: {sorted(set(plain))}")
        emit({"phase": "training_strategies", "card": card, "algorithm": name, "p": p,
              "c": c, "rel_diff_p1": err, "tol": TRAINING["strategy_tol"]})
        require(max(err.values()) <= TRAINING["strategy_tol"],
                f"training {name} ({p},{c}): grads off p = 1's by {err}")
        result[name] = err
        del alg
    return result


def scatter_timing(alg, A, B, g_out, g_mid, sv) -> dict:
    """The fused backward's column scatter alone (``dB[c] += gs * A[r] +
    mid * G[r]``, ``ops/autograd.py``) on the full cell's tile, in float32
    (CUDA events), beside its bound (every input read once, ``dB`` written
    once; 4 operations a nonzero and feature at the float32 rate) and its
    gather floor (an A and a G row read a nonzero): the yardstick of a
    hand-written scatter kernel (ROADMAP queue B)."""
    tile = alg.S_tiles.tile(0, 0)
    A32, G = A.detach().float(), g_out.float()
    mid = alg.kernel.sddmm_tile(tile, sv.detach()[0, 0], A32, B.detach().float())
    gs = (g_mid[0, 0] * sv.detach()[0, 0]).contiguous()
    nnz, R = int(tile.row_ptr[-1]), A32.shape[1]

    def run():
        return tile_autograd._cols_grad(tile, lambda sl: gs[sl, None] * A32[tile.rows[sl]]
                                        + mid[sl, None] * G[tile.rows[sl]], B)

    ms = time_ms(run, 3)
    moved = 2 * A32.numel() * 4 + 4 * 4 * nnz + B.numel() * 4
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * nnz * R / F32_FLOP_PER_S * 1e3
    return {"ms": ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gather_ms": max((moved + 2 * nnz * R * 4) / HBM_BYTES_PER_S * 1e3, t_ops)}


def training_timing(uniform, dev, launches: dict, card: str) -> dict:
    """The full cell's fused pair with grads, f32 and bf16: ms of the
    forward and of forward + backward (CUDA events, TRAINING["reps"] after
    one untimed), peak memory of forward + backward."""
    S, alg = uniform
    gen = torch.Generator(device=dev).manual_seed(3)
    A = alg.dummy_initialize(MatMode.A).requires_grad_()
    B = alg.like_b_matrix(0.01).requires_grad_()
    sv = alg.like_s_values(1.0).requires_grad_()
    g_out = torch.randn(A.shape, generator=gen, device=dev)
    g_mid = alg.like_s_values(1.0) * torch.randn(sv.shape, generator=gen, device=dev)
    result = {}
    for prec in PRECISIONS:
        alg.kernel = CudaTileKernel(prec, device=dev)

        def forward():
            return alg.fused_spmm(A, B, sv, MatMode.A)

        def step():
            out, mid = forward()
            torch.autograd.backward((out, mid), (g_out, g_mid))

        fwd_ms = time_ms(forward, TRAINING["reps"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, counts = run_counted(step)
        typed = by_type()
        peak = torch.cuda.max_memory_allocated()
        step_ms = time_ms(step, TRAINING["reps"])
        A.grad = B.grad = sv.grad = None
        expect = {**dict.fromkeys(cuda_kernels.LAUNCHES, 0), "fused_tile": 1,
                  **BACKWARD_LAUNCHES["fused"]}
        row = {"forward_ms": fwd_ms, "forward_backward_ms": step_ms,
               "backward_ms": step_ms - fwd_ms, "backward_over_forward": (step_ms - fwd_ms) / fwd_ms,
               "peak_mem_bytes": peak, "launches": counts, "launches_bf16": typed["bf16"],
               "dB_scatter": scatter_timing(alg, A, B, g_out, g_mid, sv)}
        emit({"phase": "training_timing", "card": card, "precision": prec, "nnz": S.nnz,
              "R": alg.R, "reps": TRAINING["reps"], **row})
        require(counts == expect, f"training timing/{prec}: launches {counts} != {expect}")
        # Only the forward's fused launch reads the drive's type; the
        # backward's read float32.
        want_bf16 = {**dict.fromkeys(cuda_kernels.LAUNCHES, 0),
                     **({"fused_tile": 1} if prec == "bf16" else {})}
        require(typed["bf16"] == want_bf16,
                f"training timing/{prec}: bf16 launches {typed['bf16']} != {want_bf16}")
        add_by_type(launches, typed)
        result[prec] = row
    return result


def gat_host_weights(R: int, seed: int) -> list:
    """Weights of the harness's GAT (one list a layer), U(-1, 1)/sqrt(in)
    in float64 from a CPU ``torch.Generator``: the card and a float64 host
    network take the same values."""
    gen = torch.Generator().manual_seed(seed)
    return [[(torch.rand(l.input_features, l.features_per_head, generator=gen,
                         dtype=torch.float64) * 2 - 1) / math.sqrt(l.input_features)
             for _ in range(l.num_heads)] for l in harness._gat_layers(R)]


def gat_train_data(M: int, R: int, seed: int, device, dtype) -> tuple:
    """The training input's N(0, 1) draw ``[M, R]`` and the N(0,
    target_std) target ``[M, heads * R]`` of the last layer's width."""
    gen = torch.Generator(device=device).manual_seed(seed)
    width = harness._gat_layers(R)[-1].output_features
    Z = torch.randn(M, R, generator=gen, dtype=dtype, device=device)
    return Z, torch.randn(M, width, generator=gen, dtype=dtype, device=device) * GAT_TRAIN[
        "target_std"]


def input_scale(rms: float) -> float:
    """The input scale at which the output's RMS is the target's, from the
    RMS at ``probe_scale`` (the network is homogeneous of degree 27)."""
    require(math.isfinite(rms) and rms > 0, f"gat training: probe output RMS {rms}")
    return GAT_TRAIN["probe_scale"] * (GAT_TRAIN["target_std"] / rms) ** (1 / 27)


def gat_plain_head(S: HostCOO, alpha: float):
    """One GAT head in plain PyTorch, on its inputs' device and type: the
    projection, the logits by gathers, LeakyReLU, the aggregation by
    ``index_add``, ReLU. Given a ``pattern`` (where the logits and where
    the aggregation are positive), the two kinks take those branches
    instead of their own input's: the same function on the other side of
    a kink only, so its grads are the float64 grads at that pattern. With
    ``parts`` it also returns the logits and the aggregates."""
    rows = torch.from_numpy(S.rows).long()
    cols = torch.from_numpy(S.cols).long()

    def head(X, W, pattern=None, parts: bool = False):
        nonlocal rows, cols
        rows, cols = rows.to(X.device), cols.to(X.device)
        A = X @ W
        logits = (A.index_select(0, rows) * A.index_select(0, cols)).sum(-1)
        if pattern is None:
            att = logits.clamp(min=0) + logits.clamp(max=0) * alpha
        else:
            att = torch.where(pattern[0], logits, logits * alpha)
        h = torch.zeros_like(A).index_add(0, rows, att[:, None] * A.index_select(0, cols))
        out = torch.relu(h) if pattern is None else torch.where(pattern[1], h, 0.0)
        return (out, (logits, h)) if parts else out

    return head


def gat_plain_grads(S: HostCOO, weights: list, X, T, alpha: float, patterns=None) -> tuple:
    """Autograd of the GAT in plain PyTorch, in the inputs' type and on
    their device, one head recomputed in the backward at a time so that
    its ``[nnz, R]`` intermediates are not all held (at the ``patterns`` of
    each layer's heads, when given): the MSE loss and the grads of every
    weight."""
    head = gat_plain_head(S, alpha)
    ws = [[w.clone().requires_grad_() for w in layer] for layer in weights]
    Y = X
    for i, layer in enumerate(ws):
        Y = torch.cat([torch.utils.checkpoint.checkpoint(
            head, Y, w, None if patterns is None else patterns[i][j], use_reentrant=False)
            for j, w in enumerate(layer)], dim=-1)
    loss = torch.mean((Y - T) ** 2)
    grads = torch.autograd.grad(loss, [w for layer in ws for w in layer])
    return float(loss.detach()), grads


def rounding_factor(n):
    """``gamma(n) = n u / (1 - n u)``: the relative error bound of a chain
    of ``n`` float32 operations (u = 2^-24, float32's unit roundoff)."""
    u = 2.0 ** -24
    return n * u / (1 - n * u)


@torch.no_grad()
def gat_kinks(S: HostCOO, weights: list, X, alpha: float) -> list:
    """Float64's pattern of the forward from ``X`` (``gat_plain_head``'s
    expressions) and, for each layer and head, the logits and aggregates
    that lie within float32 rounding of their kink at 0: ``|v| <= E_v``, a
    first-order bound of a float32 evaluation's error in any order of
    summation (fused multiply-adds included). ``E_v`` is carried forward
    from the input's rounding: each operation adds its inputs' bounds
    through its absolute partial derivatives and its own rounding,
    ``gamma(n)`` of the sum of its terms' absolute values, ``n`` the terms
    summed (``R_in`` and the weight's rounding a projection, ``R`` a
    logit, the row's degree an aggregate); LeakyReLU and ReLU pass the
    bound on. Only these values can take the other side of a kink in a
    float32 forward. Returns ``{"own": (logits > 0, h > 0), "near":
    (logits, aggregates within their bound)}`` a head."""
    u = rounding_factor(1)
    rows = torch.from_numpy(S.rows).long()
    cols = torch.from_numpy(S.cols).long()
    # An aggregate's own rounding, by the row of each of its terms.
    g_row = rounding_factor(torch.bincount(rows, minlength=S.M).to(X.dtype))[rows]
    E = u * X.abs()
    kinks = []
    for layer in weights:
        outs, errs, heads = [], [], []
        for W in layer:
            A = X @ W
            EA = E @ W.abs() + rounding_factor(W.shape[0] + 2) * (X.abs() @ W.abs())
            Ar, Ac = A.index_select(0, rows), A.index_select(0, cols)
            prod = Ar * Ac
            logits = prod.sum(-1)
            El = rounding_factor(W.shape[1]) * prod.abs_().sum(-1)
            EAc = EA.index_select(0, cols)
            El += (EA.index_select(0, rows) * Ac.abs() + Ar.abs_() * EAc).sum(-1)
            del prod, Ar
            att = logits.clamp(min=0) + logits.clamp(max=0) * alpha
            h = torch.zeros_like(A).index_add(0, rows, att[:, None] * Ac)
            a = att.abs()
            Eh = torch.zeros_like(A).index_add(
                0, rows, (El + (u + g_row) * a)[:, None] * Ac.abs_() + a[:, None] * EAc)
            del Ac, EAc
            heads.append({"own": (logits > 0, h > 0),
                          "near": (logits.abs() <= El, (h.abs() <= Eh) & (Eh > 0))})
            outs.append(torch.relu(h))
            errs.append(Eh)
        X, E = torch.cat(outs, -1), torch.cat(errs, -1)
        kinks.append(heads)
    return kinks


def gat_port_pattern(gat, X) -> list:
    """The port's own pattern in its forward from ``X`` (numpy, host order):
    for each layer and head, where its logits and its aggregation (before
    ReLU) are positive, read through ``GAT.layer_forward``'s hook from the
    code that ``forward`` runs and phase training times."""
    d = gat.d_ops
    patterns = []

    def mark(part, value):
        if part == "sddmm":
            pats.append([d.gather_s_values(value) > 0])
        elif part == "spmm":
            pats[-1].append(d.host_a(value) > 0)

    with torch.no_grad():
        for i in range(len(gat.layers)):
            pats: list = []
            X = gat.layer_forward(i, X, mark=mark)
            patterns.append([tuple(p) for p in pats])
    return patterns


def gat_reference_job(paths: dict, log_m: int, edge_factor: int, R: int, scale: float,
                      alpha: float, seed: int, threads: int, drift: bool) -> None:
    """The host references of the headline GAT, in a process of its own
    (``HostReference``), on the R-mat ``log_m``, ``edge_factor`` (seed 0)
    at ``R``. Unless ``drift``: first the float64 forward pass of phase
    apps' gat_headline on the default input (``oracle.gat_forward``) to
    ``paths["forward"]``. Then, for the training network of ``seed`` at
    input scale ``scale``: float64's own pattern and the logits and
    aggregates within float32 rounding of a kink (``gat_kinks``), and a
    head's flips (where the port's pattern, ``paths["pattern"]``, differs
    from float64's): ``[logits, aggregates]`` flipped, near a kink, and
    flipped but not near; the MSE loss and weight grads by float64 CPU
    autograd at float64's own pattern, and at the port's (or, with
    ``drift``, by plain float32 CPU autograd from the float32-rounded
    weights and input), to ``paths["grads"]``. Each file is written
    atomically."""
    torch.set_num_threads(threads)
    os.nice(10)  # the card's phases' host work comes first
    S = HostCOO.rmat(log_m, edge_factor, np.random.default_rng(0))

    def save(path, **arrays):
        np.savez(f"{path}.tmp.npz", **arrays)
        os.replace(f"{path}.tmp.npz", path)

    t0 = time.perf_counter()
    if not drift:
        forward = oracle.gat_forward(
            S, oracle.dummy_dense(S.M, R) / (S.M * R),
            [[w.numpy() for w in layer] for layer in gat_host_weights(R, GAT_REF["forward_seed"])],
            alpha)
        save(paths["forward"], forward=forward, seconds=time.perf_counter() - t0)
    t1 = time.perf_counter()
    weights = gat_host_weights(R, seed)
    Z, T = gat_train_data(S.M, R, seed, "cpu", torch.float64)
    X = Z * scale
    kinks = gat_kinks(S, weights, X, alpha)
    with np.load(paths["pattern"]) as z:
        port = [[(torch.from_numpy(z[f"l{i}_{j}"]), torch.from_numpy(z[f"h{i}_{j}"]))
                 for j in range(len(layer))] for i, layer in enumerate(weights)]
    flips = []
    for layer_kinks, layer_port in zip(kinks, port):
        for k, got in zip(layer_kinks, layer_port):
            flip = [a != b for a, b in zip(k["own"], got)]
            flips.append([int(f.sum()) for f in flip] + [int(n.sum()) for n in k["near"]]
                         + [int((f & ~n).sum()) for f, n in zip(flip, k["near"])])
    del kinks
    loss, grads = gat_plain_grads(S, weights, X, T, alpha)
    if drift:
        name, (loss_other, grads_other) = "loss32", gat_plain_grads(
            S, [[w.float() for w in layer] for layer in weights], X.float(), T.float(), alpha)
    else:
        name, (loss_other, grads_other) = "loss_at_port_pattern", gat_plain_grads(
            S, weights, X, T, alpha, port)
    save(paths["grads"], loss=loss, flips=np.array(flips), seconds=time.perf_counter() - t1,
         **{name: loss_other},
         **{f"g{i}": g.numpy() for i, g in enumerate(grads)},
         **{f"m{i}": g.double().numpy() for i, g in enumerate(grads_other)})


class HostReference:
    """The host references of the headline GAT (``gat_reference_job``) in
    a spawned process of ``threads`` CPU threads, started before the
    card's phases so that its minutes of host work overlap them. On
    construction the card runs the training network of ``seed`` once, to
    fix its input scale and the port's pattern (through
    ``gat_port_pattern``), which the process takes. ``forward()`` and
    ``grads()`` wait for their files; ``stop()`` ends the process."""

    def __init__(self, dev, seed: int = GAT_TRAIN["seed"], drift: bool = False,
                 threads: int = GAT_REF["threads"]):
        R = HEADLINE["R"]
        S = HostCOO.rmat(HEADLINE["log_m"], HEADLINE["edge_factor"], np.random.default_rng(0))
        alg = make_algorithm("15d_fusion2", S, R, kernel=CudaTileKernel("f32", device=dev),
                             device=dev)
        gat = gat_mod.GAT(harness._gat_layers(R), alg)
        for layer, ws in zip(gat.layers, gat_host_weights(R, seed)):
            layer.weights = [w.float().to(dev) for w in ws]
        Z, _ = gat_train_data(S.M, R, seed, "cpu", torch.float64)
        with torch.no_grad():
            out = alg._to_global(gat.forward(put_wide(alg, Z * GAT_TRAIN["probe_scale"])),
                                 MatMode.A)
            self.scale = input_scale(float(out[: S.M].double().pow(2).mean().sqrt()))
        pattern = gat_port_pattern(gat, put_wide(alg, Z * self.scale))
        base = _build.BUILD_DIR / "chip_smoke_gat_reference" / f"seed{seed}"
        base.mkdir(parents=True, exist_ok=True)
        self.seed = seed
        self.paths = {k: str(base / f"{k}.npz") for k in ("pattern", "forward", "grads")}
        for path in self.paths.values():
            pathlib.Path(path).unlink(missing_ok=True)
        np.savez(self.paths["pattern"], **{f"{kind}{i}_{j}": p[n]
                                           for i, layer in enumerate(pattern)
                                           for j, p in enumerate(layer)
                                           for n, kind in enumerate("lh")})
        del gat, alg, out, pattern
        self.proc = multiprocessing.get_context("spawn").Process(
            target=gat_reference_job, daemon=True,
            args=(self.paths, HEADLINE["log_m"], HEADLINE["edge_factor"], R, self.scale,
                  inspect.signature(gat_mod.GAT).parameters["leaky_relu_alpha"].default,
                  seed, threads, drift))
        self.proc.start()
        self._loaded: dict = {}

    def _wait(self, name: str) -> dict:
        if name not in self._loaded:
            t = time.perf_counter()
            path = pathlib.Path(self.paths[name])
            while not path.exists() and self.proc.is_alive():
                require(time.perf_counter() - t < GAT_REF["timeout"],
                        f"GAT reference: no {name} in {GAT_REF['timeout']} s")
                time.sleep(0.5)
            require(path.exists(), f"GAT reference: exit code {self.proc.exitcode} "
                    f"before its {name}")
            with np.load(path) as z:
                self._loaded[name] = {k: z[k] for k in z.files}
            self._loaded[name]["wait_seconds"] = time.perf_counter() - t
        return self._loaded[name]

    def forward(self) -> dict:
        return self._wait("forward")

    def grads(self) -> dict:
        return self._wait("grads")

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(30)
        shutil.rmtree(pathlib.Path(self.paths["grads"]).parent, ignore_errors=True)


def gat_train_steps(gat, weights, X, T, steps: int, lr: float, marks=None) -> list:
    """``steps`` plain SGD steps of the MSE loss (CUDA events in ``marks``
    around each, when given); returns the loss at each step and leaves the
    trained weights in the layers."""
    losses = []
    flat = [w for layer in weights for w in layer]
    for _ in range(steps):
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        k = 0
        for layer in gat.layers:
            layer.weights = flat[k:k + layer.num_heads]
            k += layer.num_heads
        loss = torch.mean((gat.forward(X) - T) ** 2)
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            flat = [(w - lr * g).requires_grad_() for w, g in zip(flat, grads)]
        losses.append(loss.detach())
    if marks is not None:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    torch.cuda.synchronize()
    return [float(x) for x in losses]


def gat_headline_grads(S16, ref: HostReference, dev) -> dict:
    """One step's weight grads of the headline GAT of ``ref.seed`` on the
    card (f32) against the host references (``ref.grads()``), each as the
    max abs difference over the reference's max abs value, a layer:
    ``own`` to float64 at float64's own pattern, ``other`` to the
    reference's other grads (float64 at the port's pattern; with drift,
    plain float32), ``other_own`` between the two references; the flip
    table (``gat_reference_job``), the launches by operand type."""
    R = HEADLINE["R"]
    alg = make_algorithm("15d_fusion2", S16, R, kernel=CudaTileKernel("f32", device=dev),
                         device=dev)
    gat = gat_mod.GAT(harness._gat_layers(R), alg)
    flat = [w.float().to(dev).requires_grad_() for layer in gat_host_weights(R, ref.seed)
            for w in layer]
    k = 0
    for layer in gat.layers:
        layer.weights = flat[k:k + layer.num_heads]
        k += layer.num_heads
    Z, T = gat_train_data(S16.M, R, ref.seed, "cpu", torch.float64)
    Xd, Td = put_wide(alg, Z * ref.scale), put_wide(alg, T)
    (loss, grads), counts = run_counted(lambda: _loss_and_grads(gat, Xd, Td, flat))
    typed = by_type()
    want = ref.grads()

    def by_layer(got, ref) -> list:
        """Max abs difference over the reference's max abs value, a layer."""
        errs, k = [], 0
        for layer in gat.layers:
            a = torch.cat([torch.as_tensor(got[i]).reshape(-1).double()
                           for i in range(k, k + layer.num_heads)])
            b = torch.cat([torch.as_tensor(ref[i]).reshape(-1).double()
                           for i in range(k, k + layer.num_heads)])
            errs.append(float((a - b).abs().max() / b.abs().max()))
            k += layer.num_heads
        return errs

    port = [g.cpu() for g in grads]
    own = [want[f"g{i}"] for i in range(len(flat))]
    other = [want[f"m{i}"] for i in range(len(flat))]
    return {"nnz": S16.nnz, "seed": ref.seed, "input_scale": ref.scale, "loss": loss,
            "loss64": float(want["loss"]),
            **{key: float(want[key]) for key in ("loss_at_port_pattern", "loss32")
               if key in want},
            "own": by_layer(port, own), "other": by_layer(port, other),
            "other_own": by_layer(other, own), "flips": want["flips"].tolist(),
            "reference_seconds": float(want["seconds"]),
            "reference_wait_seconds": want["wait_seconds"], "launches": counts,
            "by_type": typed}


def training_gat(S16, uniform, ref: HostReference, dev, launches: dict, card: str) -> dict:
    """GAT training. At the headline R-mat, f32: one step's weight grads
    against a float64 CPU autograd of the same network from the same
    weights, input and target (``HostReference``), within ``grad_tol`` at
    the port's own pattern (the sides of LeakyReLU's and ReLU's kinks its
    forward took); every logit and aggregate on which that pattern differs
    from float64's must lie within float32 rounding of its kink
    (``gat_kinks``), and the distance to float64 at float64's own pattern
    within ``own_cap``. At the full cell, f32 and bf16:
    GAT_TRAIN["warmup"] step and GAT_TRAIN["steps"] timed steps of plain
    SGD on the MSE against the target; ms a step, the losses (they must
    fall), peak memory."""
    R = HEADLINE["R"]
    g = gat_headline_grads(S16, ref, dev)
    add_by_type(launches, g.pop("by_type"))
    err_at, err_own, branch = g["other"], g["own"], g["other_own"]
    flips = np.array(g.pop("flips"))
    loss, loss64 = g["loss"], g["loss64"]
    tol, cap = GAT_TRAIN["grad_tol"], GAT_TRAIN["own_cap"]
    head = {**{k: g[k] for k in ("nnz", "seed", "input_scale", "loss", "loss64",
                                 "reference_seconds", "reference_wait_seconds", "launches")},
            "loss64_at_port_pattern": g["loss_at_port_pattern"],
            "grad_rel_err_float64_at_port_pattern_by_layer": err_at,
            "grad_rel_err_float64_by_layer": err_own,
            "float64_pattern_change_by_layer": branch, "tol": tol, "own_cap": cap,
            "flips_logits_aggregates_by_head": flips[:, :2].tolist(),
            "near_kink_logits_aggregates_by_head": flips[:, 2:4].tolist(),
            "flips_not_near_a_kink": int(flips[:, 4:].sum())}
    emit({"phase": "training_gat_headline", "card": card, **head})
    require(abs(loss / loss64 - 1) <= tol and max(err_at) <= tol,
            f"training gat headline: grads off float64 at the port's pattern by {err_at} "
            f"(at float64's own: {err_own}); loss {loss} against {loss64}")
    require(not flips[:, 4:].any(),
            f"training gat headline: the port's pattern leaves float64's where float32 "
            f"rounding cannot reach (flips not near a kink by head: {flips[:, 4:].tolist()})")
    require(max(err_own) <= cap,
            f"training gat headline: grads off float64 at its own pattern by {err_own} "
            f"> {cap:.3e}")

    S, alg = uniform
    result = {"headline": head}
    for prec in PRECISIONS:
        alg.kernel = CudaTileKernel(prec, device=dev)
        gat = gat_mod.GAT(harness._gat_layers(R), alg)
        weights = [[w.float().to(dev) for w in layer]
                   for layer in gat_host_weights(R, GAT_TRAIN["seed"])]
        for layer, ws in zip(gat.layers, weights):
            layer.weights = ws
        Z, T = gat_train_data(alg.M_pad, R, GAT_TRAIN["seed"], dev, torch.float32)
        Td = put_wide(alg, T)
        with torch.no_grad():
            out = alg._to_global(gat.forward(put_wide(alg, Z * GAT_TRAIN["probe_scale"])),
                                 MatMode.A)
            scale = input_scale(float(out[: S.M].double().pow(2).mean().sqrt()))
            del out
        Xd = put_wide(alg, Z * scale)
        weights = [[w.requires_grad_() for w in layer] for layer in weights]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks: list = []
        losses, counts = run_counted(lambda: gat_train_steps(
            gat, weights, Xd, Td, GAT_TRAIN["warmup"] + GAT_TRAIN["steps"], GAT_TRAIN["lr"],
            marks))
        typed = by_type()
        peak = torch.cuda.max_memory_allocated()
        step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(len(marks) - 1)]
        timed = step_ms[GAT_TRAIN["warmup"]:]
        heads = sum(layer.num_heads for layer in gat.layers)
        steps = GAT_TRAIN["warmup"] + GAT_TRAIN["steps"]
        # A head's forward: an SDDMM and an SpMM; its backward: the SpMM's
        # value grad (an SDDMM) and the SDDMM's dA (an SpMM).
        expect = {**dict.fromkeys(cuda_kernels.LAUNCHES, 0), "sddmm_tile": 2 * heads * steps,
                  "spmm_tile": 2 * heads * steps}
        row = {"ms_per_step": sum(timed) / len(timed), "step_ms": step_ms, "losses": losses,
               "peak_mem_bytes": peak, "launches": counts, "launches_bf16": typed["bf16"],
               "lr": GAT_TRAIN["lr"],
               "input_scale": scale}
        emit({"phase": "training_gat_full", "card": card, "precision": prec, "nnz": S.nnz,
              "R": R, "heads": [layer.num_heads for layer in gat.layers], **row})
        require(all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:])),
                f"training gat full/{prec}: the loss did not fall: {losses}")
        require(counts == expect, f"training gat full/{prec}: launches {counts} != {expect}")
        # The forward's launches read the drive's type, the backward's
        # float32.
        want_bf16 = {**dict.fromkeys(cuda_kernels.LAUNCHES, 0),
                     **({"sddmm_tile": heads * steps, "spmm_tile": heads * steps}
                        if prec == "bf16" else {})}
        require(typed["bf16"] == want_bf16,
                f"training gat full/{prec}: bf16 launches {typed['bf16']} != {want_bf16}")
        add_by_type(launches, typed)
        result[prec] = row
        del gat, weights, Xd, Td, Z, T
    alg.set_r_value(R)
    return result


def put_wide(alg, X):
    """A host ``(M, width)`` tensor in A's layout at its own width."""
    alg.set_r_value(X.shape[1])
    return alg.put_a(X.float())


def _loss_and_grads(gat, X, T, flat) -> tuple:
    loss = torch.mean((gat.forward(X) - T) ** 2)
    grads = torch.autograd.grad(loss, flat)
    return float(loss.detach()), grads


def phase_training(S16, uniform, ref: HostReference, dev, launches: dict,
                   card: str) -> dict:
    t0 = time.perf_counter()
    seconds, out = {}, {}
    for part, fn, args in (("headline", training_headline, (S16,)),
                           ("banked", training_banked, ()),
                           ("strategies", training_strategies, (S16,)),
                           ("timing", training_timing, (uniform,)),
                           ("gat", training_gat, (S16, uniform, ref))):
        t = time.perf_counter()
        out[part] = fn(*args, dev, launches, card)
        seconds[part] = time.perf_counter() - t
    emit({"phase": "training", "card": card, "seconds": time.perf_counter() - t0,
          "seconds_by_part": seconds,
          "fused_pair_ms": {p: {k: out["timing"][p][k] for k in
                                ("forward_ms", "forward_backward_ms", "backward_ms")}
                            for p in PRECISIONS},
          "gat_ms_per_step": {p: out["gat"][p]["ms_per_step"] for p in PRECISIONS}})
    return out


# ------------------------------------------------ apps on the R-split strategies


def pass_launches(alg, op: str) -> dict:
    """Generic launches of one SDDMM or SpMM op: a kernel a rank a ring
    step."""
    counts = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    counts[f"{op}_tile"] = alg.p * ring_steps(alg)
    return counts


def strategy_als_launches(alg, steps: int, cg_iters: int, truth: bool = True,
                          residuals: int = 1) -> dict:
    """``DistributedALS`` on an R-split strategy (the per-op path): the
    ground truth (an SDDMM in each mode), each half-step's right-hand side
    (an SpMM) and its ``cg_iters + 1`` Gram products (an SDDMM and an SpMM
    each), an SDDMM a residual."""
    sddmm, spmm = pass_launches(alg, "sddmm"), pass_launches(alg, "spmm")
    pairs = 2 * steps * (cg_iters + 1)
    return added(scaled(sddmm, 2 * truth + residuals + pairs), scaled(spmm, 2 * steps + pairs))


def apps_strategies_protocol(dev, launches: dict, card: str) -> dict:
    """The JAX package's ALS protocol (``tests/test_als.py``) on each R-split
    strategy on the card, f32."""
    cfg = ALS_PROTOCOL
    S = HostCOO.erdos_renyi(cfg["M"], cfg["N"], cfg["nnz_per_row"], np.random.default_rng(0))
    result = {}
    for name in STRATEGIES["r_split"]:
        alg = make_algorithm(name, S, cfg["R"], c=cfg["c"], world=LocalWorld(cfg["p"]),
                             kernel=CudaTileKernel("f32", device=dev), device=dev)
        als = als_mod.DistributedALS(alg, seed=0)
        als.initialize_embeddings()
        traj = [als.compute_residual()]
        for _ in range(2):
            _, counts = run_counted(lambda: als.run_cg(1, cg_iters=cfg["cg_iters"]))
            add_launches(launches, counts, "f32")
            traj.append(als.compute_residual())
        r0, r1, r2 = traj
        emit({"phase": "apps_strategies_als_protocol", "card": card, "algorithm": name,
              "nnz": S.nnz, **cfg, "trajectory": traj, "cg_step_unit": als._unit})
        require(not als._unit and r1 < 0.5 * r0 and r2 < 1.01 * r1,
                f"apps strategies protocol {name}: {traj}")
        result[name] = traj
    return result


def apps_strategies_full(uniform, algs: dict, shape_ratio: float, dev, launches: dict,
                         card: str) -> dict:
    """Phase 5's cell at STRATEGIES["full"] on the R-split strategies (the
    tile sets phase strategies built), f32: ALS through the harness's
    ``_run_als`` (ms a step) and the first step's ratio against the float64
    solver's; the GAT forward (ms a forward) against the dense shift's at
    p = 1 from the same weights."""
    S, base = uniform
    R, it = FULL["R"], ALS["cg_iters"]
    base.kernel = CudaTileKernel("f32", device=dev)
    base.set_r_value(R)
    ref_gat = gat_mod.GAT(harness._gat_layers(R), base, seed=0)
    with torch.no_grad():
        want = ref_gat.forward()
    scale = float(want.abs().max())
    heads = sum(layer.num_heads for layer in ref_gat.layers)
    result = {}
    for name, alg in algs.items():
        alg.kernel = CudaTileKernel("f32", device=dev)
        alg.set_r_value(R)
        tag = f"apps strategies full {name}"
        torch.cuda.reset_peak_memory_stats()
        (elapsed, stats), counts = run_counted(
            lambda: harness._run_als(alg, ALS_STRAT["steps"], ALS["warmup"], cg_iters=it, S=S))
        expect = strategy_als_launches(alg, ALS["warmup"] + ALS_STRAT["steps"], it)
        require(counts == expect, f"{tag}: ALS launches {counts} != {expect}")
        add_launches(launches, counts, "f32")
        als = als_mod.DistributedALS(alg, S_host=S)
        als.initialize_embeddings()
        r0 = als.compute_residual()
        _, counts1 = run_counted(lambda: als.run_cg(1, cg_iters=it))
        add_launches(launches, counts1, "f32")
        ratio = als.compute_residual() / r0
        als_peak = torch.cuda.max_memory_allocated()
        del als

        gat = gat_mod.GAT(harness._gat_layers(R), alg, seed=0)
        for layer, ref in zip(gat.layers, ref_gat.layers):
            layer.weights = ref.weights
        with torch.no_grad():
            gat.forward()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(GAT["forwards"]):
                out, counts2 = run_counted(gat.forward)
            gat_ms = (time.perf_counter() - t0) / GAT["forwards"] * 1e3
            gat_peak = torch.cuda.max_memory_allocated()
            err = float((alg._to_global(out, MatMode.A) - want).abs().max()) / scale
        expect = added(scaled(pass_launches(alg, "sddmm"), heads),
                       scaled(pass_launches(alg, "spmm"), heads))
        require(counts2 == expect, f"{tag}: GAT launches {counts2} != {expect}")
        add_launches(launches, scaled(counts2, GAT["forwards"]), "f32")
        row = {"als_ms_per_step": elapsed / ALS_STRAT["steps"] * 1e3,
               "als_steps": ALS_STRAT["steps"], "als_residual": stats["als_residual"],
               "first_step_ratio": ratio, "float64_first_step_ratio": shape_ratio,
               "ratio_gap": abs(ratio - shape_ratio), "ratio_tol": ALS_RATIO_TOL,
               "als_peak_mem_bytes": als_peak, "gat_ms_per_forward": gat_ms,
               "gat_rel_err_dense_shift": err, "gat_tol": GAT_TOL["f32"],
               "gat_peak_mem_bytes": gat_peak, "width": R // alg._n_slices()}
        emit({"phase": "apps_strategies_full", "card": card, "algorithm": name,
              "p": alg.p, "c": alg.c, "nnz": S.nnz, "R": R, **row})
        require(np.isfinite(stats["als_residual"]) and "als_degraded" not in stats,
                f"{tag}: ALS {stats}")
        require(row["ratio_gap"] <= ALS_RATIO_TOL,
                f"{tag}: first-step ratio {ratio:.6f} against float64's {shape_ratio:.6f}")
        require(err <= GAT_TOL["f32"], f"{tag}: GAT output off the dense shift's by {err:.3e}")
        result[name] = row
        del gat, out
    del ref_gat, want
    return result


def apps_strategies_cli(dev, launches: dict, card: str) -> dict:
    """``er 12 8 all ... 128 1 --app als`` and ``--app gat`` over four
    logical ranks (cuda-bf16): a record a member, none skipped."""
    path = _build.BUILD_DIR / "chip_smoke_cli_apps_strategies.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    every = list(cli.ALG_GROUPS["all"])
    prev = os.environ.get(comm_mod.LOCAL_RANKS_ENV)
    os.environ[comm_mod.LOCAL_RANKS_ENV] = "4"
    result = {}
    try:
        for app in ("als", "gat"):
            argv = ["er", "12", "8", "all", "128", "1", "--app", app, "--trials", "1",
                    "-o", str(path)]
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, counts = run_counted(lambda: cli.main(argv))
            recs = [json.loads(line) for line in path.read_text().splitlines()]
            path.unlink()
            said = [line.split()[1] for line in err.getvalue().splitlines()
                    if line.startswith("skip ")]
            ran = [r["algorithm"] for r in recs]
            emit({"phase": "apps_strategies_cli", "card": card, "argv": argv, "ran": ran,
                  "skipped": said, "launches": counts,
                  "ms_per_trial": {r["algorithm"]: r["elapsed"] * 1e3 for r in recs}})
            require(rc == 0 and ran == every and not said,
                    f"apps strategies cli {app}: ran {ran}, skipped {said}")
            require(all(r["kernel"] == "cuda-bf16" and r["app"] == app for r in recs),
                    f"apps strategies cli {app}: kernel or app of a record")
            require(sum(counts.values()) > 0, f"apps strategies cli {app}: no launch")
            add_launches(launches, counts, "bf16")
            result[app] = ran
    finally:
        if prev is None:
            os.environ.pop(comm_mod.LOCAL_RANKS_ENV, None)
        else:
            os.environ[comm_mod.LOCAL_RANKS_ENV] = prev
    return result


def phase_apps_strategies(uniform, algs: dict, shape_ratio: float, dev, launches: dict,
                          card: str) -> dict:
    t0 = time.perf_counter()
    seconds, out = {}, {}
    for part, fn, args in (("protocol", apps_strategies_protocol, ()),
                           ("full", apps_strategies_full, (uniform, algs, shape_ratio)),
                           ("cli", apps_strategies_cli, ())):
        t = time.perf_counter()
        out[part] = fn(*args, dev, launches, card)
        seconds[part] = time.perf_counter() - t
    emit({"phase": "apps_strategies", "card": card, "seconds": time.perf_counter() - t0,
          "seconds_by_part": seconds,
          "als_ms_per_step": {k: v["als_ms_per_step"] for k, v in out["full"].items()},
          "gat_ms_per_forward": {k: v["gat_ms_per_forward"] for k, v in out["full"].items()}})
    return out


def gat_grad_drift(seeds: list) -> int:
    """``python3 chip_smoke.py --gat-grad-drift [SEED ...]`` (by default
    GAT_DRIFT["seeds"]): for each seed, one step's weight grads of the
    headline GAT of phase training on the card (f32) and by plain PyTorch
    float32 autograd on the host, each against float64 at float64's own
    pattern (the readings behind GAT_DRIFT["plain"]), with the port's
    flips. The seeds' host references run at once, each in a process of
    its own."""
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    S16 = HostCOO.rmat(HEADLINE["log_m"], HEADLINE["edge_factor"], np.random.default_rng(0))
    threads = max(1, len(os.sched_getaffinity(0)) // len(seeds))
    refs = []
    try:
        for seed in seeds:
            refs.append(HostReference(dev, seed, drift=True, threads=threads))
        for ref in refs:
            g = gat_headline_grads(S16, ref, dev)
            flips = np.array(g["flips"])
            emit({"phase": "gat_grad_drift", "card": info["nvidia_smi"],
                  **{k: g[k] for k in ("seed", "nnz", "input_scale", "loss", "loss64", "loss32",
                                       "reference_seconds")},
                  "port_from_float64_by_layer": g["own"],
                  "plain_float32_from_float64_by_layer": g["other_own"],
                  "port_from_plain_float32_by_layer": g["other"],
                  "flips_logits_aggregates_by_head": flips[:, :2].tolist(),
                  "near_kink_logits_aggregates_by_head": flips[:, 2:4].tolist(),
                  "flips_not_near_a_kink": int(flips[:, 4:].sum())})
    finally:
        for ref in refs:
            ref.stop()
    return 0


def main() -> int:
    if "--gat-grad-drift" in sys.argv:
        seeds = [int(a) for a in sys.argv[sys.argv.index("--gat-grad-drift") + 1:]]
        return gat_grad_drift(seeds or list(GAT_DRIFT["seeds"]))
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    ref = HostReference(dev)
    try:
        return drive(info, dev, ref)
    finally:
        ref.stop()


def drive(info: dict, dev, ref: HostReference) -> int:
    card = info["nvidia_smi"]
    phase_edges(dev)
    S16 = HostCOO.rmat(HEADLINE["log_m"], HEADLINE["edge_factor"],
                       np.random.default_rng(0))
    alg16 = make_algorithm("15d_fusion2", S16, HEADLINE["R"],
                           kernel=CudaTileKernel("f32", device=dev), device=dev)
    entries: dict = {}
    compare_kernels(alg16, dev, "headline", entries, KERNEL_REPS)
    del alg16
    launches: dict = {}
    phase_verify(S16, dev, launches)
    uniform = phase_full(dev, launches, entries)
    phase_attention_verify(dev, launches, entries)
    phase_attention_full(dev, launches, entries)
    phase_banked(dev, launches, entries, uniform)
    phase_cli(dev, launches)
    ring: dict = {}
    phase_ring(S16, uniform, dev, ring, card)
    apps: dict = {}
    apps_out = phase_apps(S16, uniform, ref, dev, apps, card)
    strategies: dict = {}
    algs = phase_strategies(S16, uniform, dev, strategies, entries, card).pop("algs")
    training: dict = {}
    phase_training(S16, uniform, ref, dev, training, card)
    apps_strategies: dict = {}
    phase_apps_strategies(uniform, algs, apps_out["als_full"]["float64_first_step_ratio"],
                          dev, apps_strategies, card)
    del uniform, algs
    for key, n in (*ring.items(), *apps.items(), *strategies.items(), *training.items(),
                   *apps_strategies.items()):
        launches[key] = launches.get(key, 0) + n

    kernels = []
    for (op, prec), shapes in entries.items():
        n = launches.get((op, prec), 0)
        require(n > 0, f"{op}/{prec} never launched on the main path")
        main_ = shapes.get("full") or shapes["headline"]
        head = shapes.get("headline", main_)
        kernels.append({
            "name": f"{op}[{prec}]", "route": "cuda", "source": SOURCES[op],
            "replaces": REPLACES[op], "launches": n,
            "ring_launches": ring.get((op, prec), 0),
            "apps_launches": apps.get((op, prec), 0),
            "strategies_launches": strategies.get((op, prec), 0),
            "training_launches": training.get((op, prec), 0),
            "apps_strategies_launches": apps_strategies.get((op, prec), 0),
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "max_rel_err": max(r["max_rel_err"] for r in shapes.values()),
            "tol": main_["tol"],
            "ms": main_["ms"], "plain_ms": main_["plain_ms"],
            "bound_ms": main_["bound_ms"], "bound_by": main_["bound_by"],
            "bound_gather_ms": main_["bound_gather_ms"],
            "library_ms": main_["library_ms"],
            **{k: main_[k] for k in ("library_error", "library_covers", "graph_ms",
                                     "launch_floor_ms", "graph_launch_floor_ms")
               if k in main_},
            "at": "full" if "full" in shapes else "headline",
            "headline": {k: head[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bound_gather_ms",
                "library_ms", "max_abs_err")},
            # At the R-split strategies' shapes of the full cell.
            "strategies": {label: {k: row[k] for k in (
                "R", "n_rows", "n_cols", "nnz", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_gather_ms", "library_ms", "max_abs_err")}
                for label, row in shapes.items() if label.endswith("_full") and "R" in row},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
