"""Analytic tools (counterpart of ``tools/``)."""
