"""Observability (counterpart of ``obs/``), the in-run half:

* :mod:`.clock` -- the monotonic / wall clock pair;
* :mod:`.trace` -- nested spans and events as JSONL (``--trace``), the
  span ring;
* :mod:`.log` -- structured stderr lines mirrored into the trace;
* :mod:`.metrics` -- ``OpMetrics`` (a strategy's per-op attribution) and
  the process-wide ``GLOBAL`` counters;
* :mod:`.manifest` -- the environment of a trace (versions, card, power
  limit, git);
* :mod:`.profiler` -- ``torch.profiler`` captures and named ranges
  (``--profile``);
* :mod:`.watchdog` -- in-run anomalies (``--watchdog``);
* :mod:`.flightrec` -- the ring dumped on an anomaly (``--flightrec``).

The run store, the regression gate, the reports and the trace readers are
ROADMAP.md queue A item 19; telemetry and its HTTP export come with
serving.
"""
