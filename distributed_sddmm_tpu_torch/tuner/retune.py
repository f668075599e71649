"""Off-request-path re-measurement: from trigger signals to a challenger
(counterpart of ``tuner/retune.py``).

The tuner never takes a batch slot from the runner: every trial runs on
the tuner's thread (and, on the card, its own CUDA stream) through the
machinery offline autotuning uses (``autotune/measure.measure_candidates``:
a timeout a trial, retries with jittered backoff, an elapsed cap), under
the tuner's tighter budget. Two trial modes:

* ``wall`` (the default on CUDA) -- ``autotune/measure.py::default_trial``,
  the trial offline autotuning measures with: the candidate's strategy
  built from the host matrix and a short run of fused pairs on dummy
  operands, each pair timed between CUDA events on the trial's stream (on
  the CPU, the host clock), the fastest pair counted.
* ``counted`` (the default elsewhere) -- :func:`counted_trial`: the
  analytic pair time charged with the candidate's counted walk idle share
  (:func:`counted_pad_frac`) instead of the model's estimate.
  Deterministic, so the CPU tests arbitrate on structure rather than on
  the plain kernels' host speed; it still runs through
  ``measure_candidates``, so budget, backoff, tracing and drops behave as
  in ``wall``.

:func:`retune` is the whole stage: re-rank with the incumbent's realized
data (``rank_candidates_realized``), measure the short list and the
incumbent, and return a challenger :class:`Plan` (source ``"tuned"``)
only when it beats the incumbent's own measured number by the margin.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np

from distributed_sddmm_tpu_torch.autotune import candidates as cand_mod
from distributed_sddmm_tpu_torch.autotune import measure as measure_mod
from distributed_sddmm_tpu_torch.autotune.candidates import Candidate
from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.autotune.plan import Plan
from distributed_sddmm_tpu_torch.obs import log as obs_log

TRIAL_MODES = ("auto", "counted", "wall")


def counted_pad_frac(S, cand: Candidate, p: int = 1) -> float:
    """The counted idle share of the candidate's walk over the 1.5D
    block-row layout (one ``(M/p) x N`` tile a rank, whole rows): for the
    generic walk ``codegen/variants.py::walk_idle_frac`` of those tiles,
    for a banked variant ``estimated_pad_frac(banked=True)`` of that
    variant at each tile's real heaviest row and mean, weighted by the
    tiles' nonzeros. The ``torch`` family walks nothing and counts 0. A
    variant id this code cannot rebuild raises ``ValueError`` (the
    candidate is dropped, not counted as generic)."""
    import torch

    from distributed_sddmm_tpu_torch.codegen.variants import (
        estimated_pad_frac, variant_from_id, walk_idle_frac,
    )

    if cand.kernel == "torch" or not S.nnz:
        return 0.0
    p = max(int(p), 1)
    tile_rows = -(-int(S.M) // p)
    deg = np.bincount(np.asarray(S.rows, dtype=np.int64),
                      minlength=p * tile_rows).reshape(p, tile_rows)
    if not cand.variant:
        row_ptr = np.zeros((p, tile_rows + 1), dtype=np.int64)
        np.cumsum(deg, axis=1, out=row_ptr[:, 1:])
        return walk_idle_frac(torch.from_numpy(row_ptr))
    heaviest, nnz = deg.max(axis=1), deg.sum(axis=1)
    variant = variant_from_id(cand.variant)
    idle = sum(estimated_pad_frac(Problem(M=tile_rows, N=int(S.N), nnz=int(n), R=1,
                                          row_max=int(h)), banked=True, variant=variant) * n
               for h, n in zip(heaviest, nnz) if n)
    return float(idle / nnz.sum())


def counted_trial(S, problem: Problem, cand: Candidate, trials: int, warmup: int,
                  p: int = 1) -> dict:
    """A deterministic trial: the cost model's pair time without its
    variant estimate, charged ``1 + counted_pad_frac`` instead. Returns a
    harness-shaped record."""
    del trials, warmup  # a count does not average
    t = cand_mod.model_cost(problem, cand, p) / cand_mod.variant_cost_factor_of(problem, cand)
    frac = counted_pad_frac(S, cand, p)
    t *= 1.0 + frac
    return {"overall_throughput": 4.0 * problem.nnz * problem.R / t / 1e9,
            "counted_walk_idle_frac": round(frac, 6), "trial": "counted"}


def default_trial_mode(device=None) -> str:
    """``wall`` on a CUDA device, ``counted`` elsewhere (``device`` None:
    whether a card is there)."""
    import torch

    if device is None:
        return "wall" if torch.cuda.is_available() else "counted"
    return "wall" if torch.device(device).type == "cuda" else "counted"


def select_trial_fn(mode: str = "auto", device=None, world=None) -> Callable:
    """The trial-mode rule (``TunerConfig`` and ``bench tune`` both use
    it): ``counted`` and ``wall`` force their trial, ``auto`` follows
    :func:`default_trial_mode`. The result takes ``(S, problem, candidate,
    trials, warmup)``, as ``measure_candidates`` calls it."""
    if mode not in TRIAL_MODES:
        raise ValueError(f"trial mode must be one of {TRIAL_MODES}, got {mode!r}")
    if mode == "auto":
        mode = default_trial_mode(device)
    if mode == "counted":
        return functools.partial(counted_trial, p=world.p if world is not None else 1)
    return functools.partial(measure_mod.default_trial, device=device, world=world)


def retune(problem: Problem, incumbent: Optional[Plan], S, *, realized: Optional[dict] = None,
           top_k: int = 3, trials: int = 1, warmup: int = 1, timeout_s: float = 60.0,
           max_elapsed_s: float = 120.0, margin: float = 0.05, hot_swappable: bool = False,
           trial_fn: Optional[Callable] = None, world=None, device=None,
           measured_out: Optional[list] = None) -> Optional[Plan]:
    """Re-measure and return a challenger plan, or None when the incumbent
    stands.

    The short list is the realized re-ranking of every candidate
    (``rank_candidates_realized``); the incumbent's own candidate is
    always measured with it, so the verdict is measured against measured.
    A challenger must beat the incumbent's trial by ``margin``
    (relative). ``hot_swappable=True`` (the live tuner) keeps the
    incumbent's algorithm, c, kernel family and wire: a running replica
    can swap its kernel variant, while another algorithm or c means other
    tiles and rings (a re-warm, for the next replica through the plan
    cache), and another wire other numerics, which the bit-equal shadow
    compare could never pass. The plan's ``fingerprint_key`` is the
    machine's, the key ``get_plan`` and the next replica compute.
    ``measured_out`` (a list) receives each measured candidate's
    ``(candidate, record)``, fastest first."""
    from distributed_sddmm_tpu_torch.autotune.fingerprint import (
        machine_signature, make_fingerprint,
    )
    from distributed_sddmm_tpu_torch.device import resolve_device
    from distributed_sddmm_tpu_torch.parallel.comm import world_from_env

    device = resolve_device(device)
    world = world_from_env(device) if world is None else world
    p, backend, kernels = machine_signature(world, device)
    fp = make_fingerprint(problem, p, backend, kernels)
    if incumbent is not None and incumbent.kernel not in kernels:
        # A replica running a family searches within it, offered cold or not.
        kernels = tuple(kernels) + (incumbent.kernel,)
    cands = cand_mod.enumerate_candidates(problem, p, kernels)
    if hot_swappable and incumbent is not None:
        cands = [c for c in cands
                 if (c.algorithm, c.c, c.kernel, c.wire)
                 == (incumbent.algorithm, incumbent.c, incumbent.kernel, incumbent.wire)]
    if not cands:
        return None
    ranked = cand_mod.rank_candidates_realized(problem, cands, p, realized=realized)
    short = [cand for cand, _ in ranked[:top_k]]
    inc_cand = incumbent.candidate() if incumbent is not None else None
    if inc_cand is not None and inc_cand not in short:
        short.append(inc_cand)
    run = trial_fn if trial_fn is not None else select_trial_fn("auto", device, world)
    measured = measure_mod.measure_candidates(
        S, problem, short, trials=trials, warmup=warmup, timeout_s=timeout_s,
        max_elapsed_s=max_elapsed_s, trial_fn=run, device=device, world=world)
    if measured_out is not None:
        measured_out.extend(measured)
    if not measured:
        return None
    by_cand = dict(measured)
    best_cand, best_rec = measured[0]
    inc_rec = by_cand.get(inc_cand) if inc_cand is not None else None
    best_g = best_rec.get("overall_throughput") or 0.0
    inc_g = (inc_rec or {}).get("overall_throughput") or 0.0
    if inc_cand is not None and best_cand == inc_cand:
        return None
    if inc_cand is not None and inc_rec is None:
        # Without a measured incumbent the verdict would be one-sided.
        obs_log.warn("tuner", "incumbent trial dropped; standing pat",
                     incumbent=f"{inc_cand.algorithm}/{inc_cand.kernel}/{inc_cand.variant}")
        return None
    if inc_g and best_g < inc_g * (1.0 + margin):
        obs_log.info("tuner", "challenger within margin of incumbent; standing pat",
                     challenger=best_g, incumbent=inc_g, margin=margin)
        return None
    return Plan(algorithm=best_cand.algorithm, c=best_cand.c, kernel=best_cand.kernel,
                gather_budget=best_cand.gather_budget, variant=best_cand.variant,
                wire=best_cand.wire, source="tuned",
                predicted_ms=cand_mod.model_cost(problem, best_cand, p) * 1e3,
                measured_gflops=best_g, fingerprint_key=fp.key)
