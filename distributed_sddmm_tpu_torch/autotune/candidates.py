"""Candidate-plan enumeration, cost-model ranking and the memory guard
(counterpart of ``autotune/candidates.py``).

A candidate names everything the harness needs to build a strategy: the
algorithm (which fixes the fusion approach and the R split), the
replication factor c, the kernel family (``cuda-bf16``, ``cuda-f32`` or,
on the CPU only, ``torch``), a banked codegen variant of the CUDA family,
the wire policy's comm dtype, and for the ``torch`` family a segment
budget that bounds its gathered intermediates. Enumeration applies the
strategy constructors' own checks (c | p; p/c square and R divisibility
for the 2.5D grids; (p/c) | R for the sparse shift), so every candidate
builds.

Two pruning layers follow:

* **Memory guard** (:func:`hbm_guard`): the per-rank bytes that stay
  allocated (both dense operands, the stationary one replicated, and the
  tiles). A candidate whose resident state does not fit the budget is
  pruned. The budget is the card's (:func:`memory_budget`); on a
  ``LocalWorld`` every logical rank shares that one card, so a rank's
  budget is the card's divided by p. The ``torch`` family materialises
  ``[nnz, R]`` gathers, so there the guard routes a candidate whose
  gathers do not fit onto a segment budget (``TorchKernel(gather_budget
  =...)``) instead; the CUDA walks materialise no such intermediate, so
  for them the guard only prunes.
* **Cost model** (:func:`rank_candidates`): survivors ordered by the
  analytic pair time of ``tools/costmodel.py``. First-order: it picks what
  to measure first, and decides alone only when nothing is measured.
"""

from __future__ import annotations

import dataclasses
import math
import os

from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.codegen.variants import (
    variant_cost_factor, variant_from_id, variant_ids_for,
)
from distributed_sddmm_tpu_torch.tools import costmodel

#: The five algorithm configurations (``bench/harness.py`` names) and
#: their cost models. fusion 2 leads: the sort is stable, so on a modeled
#: tie the single-pass dense shift wins.
ALGORITHM_MODELS = {
    "15d_fusion2": "15d_fusion2",
    "15d_fusion1": "15d_fusion1",
    "15d_sparse": "15d_sparse",
    "25d_dense_replicate": "25d_dense",
    "25d_sparse_replicate": "25d_sparse",
}

#: The share of the device's memory the guard keeps back for the caching
#: allocator's slack, the CUDA context and the kernels' workspaces.
MEMORY_HEADROOM = 0.15

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One plan shape that builds (before selection)."""

    algorithm: str
    c: int
    kernel: str = "cuda-bf16"        # "cuda-bf16" | "cuda-f32" | "torch"
    gather_budget: int | None = None  # torch family: the segment budget
    variant: str | None = None       # codegen variant id (CUDA family)
    #: Wire-precision comm dtype (``parallel/wire.py``): None/f32 the
    #: identity wire, "bf16" bf16 gather and ring payloads.
    wire: str | None = None

    @property
    def chunked(self) -> bool:
        return self.gather_budget is not None

    @property
    def r_split(self) -> bool:
        return self.algorithm in ("15d_sparse", "25d_dense_replicate",
                                  "25d_sparse_replicate")


def memory_budget(device, ranks_sharing: int = 1) -> int:
    """Per-rank memory budget in bytes: the device's total (the card's
    ``torch.cuda.mem_get_info`` total, the host's physical memory on the
    CPU) less :data:`MEMORY_HEADROOM`, split over the ``ranks_sharing``
    ranks that live on it (p on a ``LocalWorld``)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        total = torch.cuda.mem_get_info(dev)[1]
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(total * (1.0 - MEMORY_HEADROOM) / max(ranks_sharing, 1))


def legal_c_values(algorithm: str, p: int, R: int) -> list[int]:
    """The replication factors the named algorithm's constructor accepts
    at (p, R)."""
    out = []
    for c in range(1, p + 1):
        if p % c:
            continue
        if algorithm in ("15d_fusion1", "15d_fusion2"):
            out.append(c)
        elif algorithm == "15d_sparse":
            if R % (p // c) == 0:
                out.append(c)
        else:  # 2.5D grids
            s = math.isqrt(p // c)
            if s * s * c != p:
                continue
            if algorithm == "25d_dense_replicate" and R % s == 0:
                out.append(c)
            elif algorithm == "25d_sparse_replicate" and R % (s * c) == 0:
                out.append(c)
    return out


def _resident_bytes(problem: Problem, cand: Candidate, p: int) -> float:
    """Per-rank bytes allocated for the strategy's life: both dense
    operands (the stationary one replicated c-fold where the strategy
    replicates it) and the tiles (about four words a nonzero, S and S^T)."""
    b = _DTYPE_BYTES.get(problem.dtype, 4)
    dense = (problem.M + problem.N) * problem.R * b / p
    if cand.algorithm in ("15d_fusion1", "15d_fusion2"):
        dense += (problem.M * problem.R * b / p) * (cand.c - 1)
    elif cand.algorithm == "25d_dense_replicate":
        dense *= cand.c
    tiles = 2 * problem.nnz * 4 * 4 / p
    if cand.algorithm == "25d_sparse_replicate":
        tiles *= cand.c
    return dense + tiles


def _gather_intermediate_elems(problem: Problem, cand: Candidate, p: int) -> float:
    """Elements of the largest ``[local nnz, local R]`` gather the
    ``torch`` family materialises a ring step: nnz/p scaled by the
    stationary replication, R divided as the strategy splits it."""
    local_nnz = problem.nnz / p
    r_div = 1
    if cand.algorithm in ("15d_fusion1", "15d_fusion2"):
        local_nnz *= cand.c
    elif cand.algorithm == "15d_sparse":
        r_div = max(p // cand.c, 1)
    elif cand.algorithm == "25d_dense_replicate":
        local_nnz *= cand.c
        r_div = max(math.isqrt(p // cand.c), 1)
    elif cand.algorithm == "25d_sparse_replicate":
        local_nnz *= cand.c
        r_div = max(math.isqrt(p // cand.c) * cand.c, 1)
    return local_nnz * max(problem.R / r_div, 1)


def hbm_guard(problem: Problem, cand: Candidate, p: int,
              budget_bytes: float) -> Candidate | None:
    """Route or prune one candidate against the per-rank memory budget:
    None when its resident state cannot fit; a ``torch`` candidate whose
    gathers do not fit the headroom comes back with a segment budget (or
    None when not even one nonzero's row fits). Never returns a candidate
    whose unsegmented gathers pass the budget."""
    b = _DTYPE_BYTES.get(problem.dtype, 4)
    resident = _resident_bytes(problem, cand, p)
    if resident > budget_bytes:
        return None
    if cand.kernel != "torch":
        return cand
    headroom = budget_bytes - resident
    inter = _gather_intermediate_elems(problem, cand, p)
    # The gather and the scatter contributions live at once.
    if 2 * inter * b <= headroom:
        return cand
    seg_budget = int(headroom / (4 * b))
    if seg_budget < problem.R:
        return None
    return dataclasses.replace(cand, gather_budget=seg_budget)


def enumerate_candidates(problem: Problem, p: int,
                         kernels: tuple = ("cuda-f32", "torch"),
                         budget_bytes: float | None = None) -> list[Candidate]:
    """Every candidate that builds and fits for (problem, machine);
    ``budget_bytes`` None guards nothing."""
    budget = float("inf") if budget_bytes is None else budget_bytes
    out = []
    for algorithm in ALGORITHM_MODELS:
        for c in legal_c_values(algorithm, p, problem.R):
            for kernel in kernels:
                shapes = [Candidate(algorithm=algorithm, c=c, kernel=kernel)]
                if kernel.startswith("cuda"):
                    # Banked variants of the CUDA family, under the same
                    # guard and model. The replicated 2.5D tiles do not
                    # bank (the generic walk runs), so a banked candidate
                    # there would win on a discount it never realizes.
                    shapes += [Candidate(algorithm=algorithm, c=c, kernel=kernel, variant=vid)
                               for vid in variant_ids_for(problem)
                               if not (algorithm == "25d_sparse_replicate"
                                       and variant_from_id(vid).banked)]
                for cand in shapes:
                    cand = hbm_guard(problem, cand, p, budget)
                    if cand is not None:
                        out.append(cand)
    # Every survivor's bf16-wire twin, for float32 problems only: the
    # casts touch float32 payloads alone.
    if problem.dtype == "float32":
        out.extend(dataclasses.replace(cand, wire="bf16") for cand in list(out))
    return out


def model_cost(problem: Problem, cand: Candidate, p: int,
               machine: costmodel.Machine | None = None) -> float:
    """Analytic seconds a fused pair for one candidate. The kernel family
    sets the flops rate (its measured rate, else ``machine``'s, else the
    family's fallback literal); the segmented ``torch`` kernel is charged
    1.1x so an unsegmented sibling of equal volume outranks it, and a
    banked variant its :func:`variant_cost_factor`."""
    if machine is None:
        machine = costmodel.Machine(flops_rate=costmodel.family_flops_rate(cand.kernel))
    else:
        measured = (costmodel.measured_flops_rate(cand.kernel,
                                                  config=costmodel.HEADLINE_CONFIG)
                    or costmodel.measured_flops_rate(cand.kernel))
        if measured:
            machine = dataclasses.replace(machine, flops_rate=measured)
    t = costmodel.pair_time(
        ALGORITHM_MODELS[cand.algorithm],
        problem.M, problem.N, problem.R, problem.nnz, p, cand.c, machine,
        wire=cand.wire,
    )
    if cand.chunked:
        t *= 1.1
    return t * variant_cost_factor_of(problem, cand)


def rank_candidates(problem: Problem, cands: list[Candidate], p: int,
                    machine: costmodel.Machine | None = None) -> list[tuple]:
    """``(candidate, modeled seconds)`` fastest first."""
    scored = [(cand, model_cost(problem, cand, p, machine)) for cand in cands]
    scored.sort(key=lambda cs: cs[1])
    return scored


def variant_cost_factor_of(problem: Problem, cand: Candidate) -> float:
    """The variant factor :func:`model_cost` charges a candidate (1.0
    without a variant)."""
    return variant_cost_factor(problem, cand.variant) if cand.variant else 1.0
