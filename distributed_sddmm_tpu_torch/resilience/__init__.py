"""Resilience layer (counterpart of ``resilience/``): step checkpoints and
numerical guards, the pieces the ALS and GAT apps use.

* :mod:`.checkpoint` -- atomic versioned step checkpoints with
  digest-checked, scan-back resume (the JAX package's on-disk format);
* :mod:`.guards` -- NaN/Inf output sentinels and CG divergence detection;
* :mod:`.retry` -- call timeouts, backoff with jitter and retries (the
  autotuner's measured trials).

The ALS ladder, top to bottom: restart damped (a diverged CG half-step
re-solves with a stiffer ridge), fall back (distributed ALS hands off to
the serial float64 solver), and finally fail loudly with a typed
exception. Fault injection and chaos schedules are not ported
(ROADMAP.md, queue A item 14).
"""

from distributed_sddmm_tpu_torch.resilience.checkpoint import (
    CheckpointStore, default_checkpoint_dir,
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
    "NumericalFault",
    "all_finite",
    "check_finite",
    "call_with_timeout",
    "default_checkpoint_dir",
    "guard_output",
    "retry_call",
]
