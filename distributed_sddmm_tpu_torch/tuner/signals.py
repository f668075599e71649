"""Trigger-signal mining: when is a serving replica worth re-tuning?
(counterpart of ``tuner/signals.py``)

Every cycle starts by mining what the obs layer already keeps for
evidence that realized performance trails the model, so the tuner burns
no measurement and mirrors no traffic on a replica that is well planned:

* ``walk_idle`` -- the strategy's per-op ``walk_idle_frac`` structure
  gauge (``codegen/variants.py::walk_idle_frac``, noted at tile build,
  scraped as ``dsddmm_op_walk_idle_frac``): the counted idle share of the
  generic CSR walk, whose lane groups wait on the heaviest row. It stands
  where the JAX package mines its chunk encoding's ``padded_lane_frac``
  (the port's walks have no pad lanes). A generic walk idling on a
  problem whose fingerprint selects a banked variant is the population
  the banked kernels exist for.
* ``xla_waste`` -- the watchdog's ``xla_flop_mismatch`` anomalies in the
  waste direction (:func:`mine_watchdog`). The port compiles no XLA
  program and its watchdog never records that kind, so this family never
  fires here; the filter is kept so that both packages read one anomaly
  stream alike. The JAX package's live read of XLA's cost analysis
  (``mine_xla``) has no counterpart, as ``xla_cost`` has none.
* ``runstore_gap`` -- stored runs of this fingerprint whose realized
  GFLOP/s trail what the plan's ``predicted_ms`` implies by more than the
  gap factor.

Mining is read-only and cheap (dict snapshots, no dispatch, no device
read): it runs on the tuner's thread every poll.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Optional

from distributed_sddmm_tpu_torch.obs import watchdog as obs_watchdog


@dataclasses.dataclass(frozen=True)
class TuneSignal:
    """One piece of evidence that realized performance trails the model.
    ``severity`` orders them (bigger is worse): the idle share for
    ``walk_idle``, the compiled/counted FLOP ratio for ``xla_waste``, the
    modeled/realized throughput ratio for ``runstore_gap``."""

    kind: str       # walk_idle | xla_waste | runstore_gap
    op: str
    severity: float
    detail: dict

    def to_dict(self) -> dict:
        return {"kind": self.kind, "op": self.op, "severity": round(self.severity, 4),
                **self.detail}


def engine_problem(engine):
    """The autotune :class:`Problem` of the engine's warm strategy, or None
    where the workload keeps no host matrix (nothing to re-measure) or its
    world spans processes (a trial in one process would stall the
    others' collectives)."""
    from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem

    model = getattr(engine.workload, "model", None)
    d_ops = getattr(model, "d_ops", None)
    S = getattr(model, "S_host", None)
    if d_ops is None or S is None:
        return None
    if getattr(d_ops.world, "num_processes", 1) > 1:
        return None
    return Problem.from_coo(S, d_ops.R)


def kernel_family(kernel) -> str:
    """The plan family of a live kernel: ``torch`` or ``cuda-<precision>``."""
    precision = getattr(kernel, "precision", None)
    return f"cuda-{precision}" if precision else "torch"


def realized_info(engine) -> dict:
    """What the incumbent runs, in the shape ``autotune.candidates.
    rank_candidates_realized`` reads: the kernel family, the realized
    variant (None: generic) and the worst per-op ``walk_idle_frac``."""
    from distributed_sddmm_tpu_torch.parallel.base import realized_kernel_variant

    model = getattr(engine.workload, "model", None)
    d_ops = getattr(model, "d_ops", None)
    if d_ops is None:
        return {}
    fracs = [g["walk_idle_frac"] for g in d_ops.metrics.structure_gauges().values()
             if g.get("walk_idle_frac") is not None]
    # The serving stamp wins over the strategy's: a promotion restamps
    # ``workload.kernel_variant`` (the strategy keeps its tiles), and the
    # trigger must read what serves now or it would fire again forever.
    variant = getattr(engine.workload, "kernel_variant", None)
    if variant is None:
        variant = realized_kernel_variant(d_ops)
    return {"kernel": kernel_family(d_ops.kernel), "variant": variant,
            "walk_idle_frac": max(fracs) if fracs else None}


def mine_engine(engine, idle_threshold: float = 1.0) -> list[TuneSignal]:
    """``walk_idle`` signals from the live strategy's gauges. Fires only
    when the realized walk is generic, its gauge reaches the threshold,
    and the fingerprint selects a banked variant (a gap the candidates can
    close). A banked incumbent's residual idle is no signal."""
    from distributed_sddmm_tpu_torch.codegen.variants import variant_ids_for

    problem = engine_problem(engine)
    if problem is None:
        return []
    info = realized_info(engine)
    frac = info.get("walk_idle_frac")
    if frac is None or frac < idle_threshold or info.get("variant") is not None:
        return []
    if info.get("kernel") == "torch" or not variant_ids_for(problem):
        return []
    return [TuneSignal(kind="walk_idle", op="fusedSpMM", severity=float(frac),
                       detail={"walk_idle_frac": round(float(frac), 6),
                               "threshold": idle_threshold, "realized_variant": None})]


def mine_watchdog(watchdog=None, since: int = 0) -> list[TuneSignal]:
    """``xla_waste`` signals from the watchdog's ``xla_flop_mismatch``
    anomalies in the waste direction, from event ``since`` on (a cursor,
    so an acted-on anomaly does not signal again)."""
    wd = watchdog if watchdog is not None else obs_watchdog.active()
    if wd is None:
        return []
    out = []
    for ev in list(wd.events[since:]):
        if ev.get("kind") != "xla_flop_mismatch" or ev.get("direction") != "xla_waste":
            continue
        ratio = ev.get("ratio") or 0.0
        out.append(TuneSignal(kind="xla_waste", op=str(ev.get("op", "?")),
                              severity=1.0 / ratio if ratio else 0.0, detail={"ratio": ratio}))
    return out


def mine_runstore(store, fingerprint_key: str, problem, predicted_ms: Optional[float],
                  gap_factor: float = 0.5, last: int = 5) -> list[TuneSignal]:
    """``runstore_gap`` signals: the last ``last`` stored runs of this
    fingerprint realize less than ``gap_factor`` of the throughput the
    plan's ``predicted_ms`` implies (the harness's ``4 nnz R`` FLOPs a
    pair). Index rows only: no document loads."""
    if store is None or not fingerprint_key or not predicted_ms:
        return []
    try:
        rows = store.history(key=fingerprint_key, limit=last)
    except Exception:  # noqa: BLE001 -- mining never fails the tuner
        return []
    realized = [r.get("overall_throughput") for r in rows if r.get("overall_throughput")]
    if not realized:
        return []
    got = statistics.median(realized)
    model_gflops = 4.0 * problem.nnz * problem.R / (predicted_ms / 1e3) / 1e9
    if model_gflops <= 0 or got >= gap_factor * model_gflops:
        return []
    return [TuneSignal(kind="runstore_gap", op="fusedSpMM",
                       severity=model_gflops / max(got, 1e-12),
                       detail={"realized_gflops": round(got, 3),
                               "modeled_gflops": round(model_gflops, 3),
                               "gap_factor": gap_factor, "runs": len(realized)})]
