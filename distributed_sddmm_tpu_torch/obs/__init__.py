"""Observability (counterpart of ``obs/``): for now only the process-wide
event counters of :mod:`.metrics`."""
