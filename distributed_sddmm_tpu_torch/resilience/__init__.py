"""Resilience layer (counterpart of ``resilience/``): fault injection,
retries, numerical guards and step checkpoints.

* :mod:`.faults` -- seeded, deterministic fault-injection plans (the CLI's
  ``--faults``, ``SDDMM_TORCH_FAULTS``); every hook is a no-op without a
  plan;
* :mod:`.retry` -- call timeouts, backoff with jitter and retries (every
  timed op's resilient path, the autotuner's measured trials);
* :mod:`.guards` -- NaN/Inf output sentinels and CG divergence detection;
* :mod:`.checkpoint` -- atomic versioned step checkpoints with
  digest-checked, scan-back resume (the JAX package's on-disk format).

The ladder, top to bottom: retry the call (a transient fault heals),
restart damped (a diverged CG half-step re-solves with a stiffer ridge),
fall back (distributed ALS hands off to the serial float64 solver), and
finally fail loudly with a typed exception. The JAX package's chaos
schedules drive a serving fleet's replicas and come with the fleet
(ROADMAP.md, queue A item 16).
"""

from distributed_sddmm_tpu_torch.resilience.checkpoint import (
    CheckpointStore, default_checkpoint_dir,
)
from distributed_sddmm_tpu_torch.resilience.faults import (
    FaultError, FaultPlan, FaultSpec, InjectedFault, InjectedOOM, InjectedTimeout,
    fault_plan,
)
from distributed_sddmm_tpu_torch.resilience.guards import (
    CGGuard, NumericalFault, all_finite, check_finite, guard_output,
)
from distributed_sddmm_tpu_torch.resilience.retry import (
    Backoff, CallTimeout, call_with_timeout, retry_call,
)

__all__ = [
    "Backoff",
    "CGGuard",
    "CallTimeout",
    "CheckpointStore",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "InjectedOOM",
    "InjectedTimeout",
    "NumericalFault",
    "all_finite",
    "check_finite",
    "call_with_timeout",
    "default_checkpoint_dir",
    "fault_plan",
    "guard_output",
    "retry_call",
]
