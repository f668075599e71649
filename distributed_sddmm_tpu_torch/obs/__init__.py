"""Observability (counterpart of ``obs/``). In the run:

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

Across runs:

* :mod:`.store` -- the run store: a benchmark record becomes one run
  document under ``artifacts/runstore_torch/`` (``SDDMM_TORCH_RUNSTORE``),
  indexed by problem fingerprint, code hash and backend;
* :mod:`.regress` -- per-phase comparison of stored runs and the gate
  (exit 0 / 2 / 3);
* :mod:`.report` -- the self-contained HTML report over a store;
* :mod:`.tracemerge` -- per-process trace shards merged into one trace;
* :mod:`.traceexport` -- a trace as Chrome trace-event JSON.

``tools/tracereport.py`` reads and aggregates traces, ``tools/charts.py``
draws records. :mod:`.telemetry` holds the mergeable latency histogram of
the serving records (``serve/slo.py``); the telemetry sampler and its HTTP
export are not ported.
"""
