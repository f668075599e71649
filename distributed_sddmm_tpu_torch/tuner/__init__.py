"""Closed-loop autotuning of a live serving replica (counterpart of
``tuner/``).

Offline autotuning picks a plan once, at warm-up or on a plan-cache miss,
and serving never feeds back: a replica warmed onto a mediocre variant
keeps it for life. This package closes the loop in three stages:

* :mod:`.signals` -- mine the live gauges for evidence that realized
  performance trails the model: the strategy's ``walk_idle_frac`` (the
  generic CSR walk idling on heavy rows, which a banked variant cuts),
  the watchdog's XLA-waste anomalies (a kind the port never records) and
  run-store history trailing the plan's prediction;
* :mod:`.retune` -- re-measure candidates off the request path through
  ``autotune/measure.py``'s trial machinery, ranked with the realized
  gauge (``autotune.candidates.rank_candidates_realized``), ``wall``
  trials on the card and ``counted`` ones elsewhere;
* :mod:`.shadow` and :mod:`.loop` -- promote by shadow execution: build
  the challenger's ladder off the path, replay mirrored requests through
  it, hold the replies bit for bit to the incumbent's (a mismatch dumps a
  flight record and blocks the promotion), then swap the ladder and the
  plan cache without dropping a request or building a cell on the
  request path.

:class:`BackgroundTuner` (``bench serve --tuner``, ``SDDMM_TORCH_TUNER``)
drives the cycle and reports ``time_to_adapt_s``.
"""

from distributed_sddmm_tpu_torch.tuner.loop import BackgroundTuner, TunerConfig
# ``retune.retune`` stays addressed through its module: re-exporting the
# function here would shadow the ``tuner.retune`` submodule.
from distributed_sddmm_tpu_torch.tuner.retune import counted_trial
from distributed_sddmm_tpu_torch.tuner.shadow import ShadowSession, StaleChallenger
from distributed_sddmm_tpu_torch.tuner.signals import (
    TuneSignal, engine_problem, mine_engine, mine_runstore, mine_watchdog,
)

__all__ = [
    "BackgroundTuner", "ShadowSession", "StaleChallenger", "TuneSignal", "TunerConfig",
    "counted_trial", "engine_problem", "mine_engine", "mine_runstore", "mine_watchdog",
]
