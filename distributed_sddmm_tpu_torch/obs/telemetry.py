"""Mergeable fixed-bucket latency histograms (counterpart of
``obs/telemetry.py``'s :class:`LatencyHistogram`).

The bounds are fixed, so two histograms from two processes, or from two
windows of one run, merge by adding counts: associative and commutative,
which sample-list percentiles are not without every sample. Percentiles
come back as bucket upper bounds (nearest rank over the cumulative
counts), so a merged p99 is conservative by at most one bucket.
``serve/slo.py`` records every reply's total latency here and reads the
SLO burn rate off it.

Only the histogram is ported here; the telemetry sampler, the stream
readers and ``bench top`` come with the live-telemetry slice.
"""

from __future__ import annotations

#: Bucket upper bounds in milliseconds (a 1-2-5 ladder, 0.25 ms to 30 s)
#: plus an overflow bucket. Fixed, so any two histograms merge; changing
#: them is a schema change, and the JAX package's are the same.
BUCKET_BOUNDS_MS: tuple[float, ...] = (
    0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class LatencyHistogram:
    """Fixed-bucket counts; :meth:`merge` is associative and commutative."""

    __slots__ = ("bounds_ms", "counts")

    def __init__(self, bounds_ms: tuple[float, ...] = BUCKET_BOUNDS_MS,
                 counts: list[int] | None = None):
        self.bounds_ms = tuple(float(b) for b in bounds_ms)
        n = len(self.bounds_ms) + 1  # the overflow bucket
        if counts is None:
            counts = [0] * n
        if len(counts) != n:
            raise ValueError(f"histogram needs {n} counts for {n - 1} bounds, "
                             f"got {len(counts)}")
        self.counts = [int(c) for c in counts]

    def add(self, latency_ms: float) -> None:
        for i, bound in enumerate(self.bounds_ms):
            if latency_ms <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def total(self) -> int:
        return sum(self.counts)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """A new histogram holding both operands' counts; raises on other
        bounds, whose merge would mean nothing."""
        if self.bounds_ms != other.bounds_ms:
            raise ValueError("cannot merge histograms with different bounds")
        return LatencyHistogram(self.bounds_ms,
                                [a + b for a, b in zip(self.counts, other.counts)])

    def __eq__(self, other) -> bool:
        return (isinstance(other, LatencyHistogram)
                and self.bounds_ms == other.bounds_ms and self.counts == other.counts)

    def quantile_ms(self, pct: float) -> float | None:
        """Nearest-rank percentile as a bucket upper bound (None when
        empty); a hit in the overflow bucket reads the last finite bound."""
        total = self.total
        if total == 0:
            return None
        rank = max(1, int(pct / 100.0 * total + 0.999999))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds_ms[min(i, len(self.bounds_ms) - 1)]
        return self.bounds_ms[-1]

    def fraction_above(self, threshold_ms: float) -> float:
        """The fraction in buckets lying wholly above ``threshold_ms`` (a
        lower bound: the bucket straddling the threshold is not charged)."""
        total = self.total
        if total == 0:
            return 0.0
        above = self.counts[-1] if self.bounds_ms[-1] >= threshold_ms else 0
        for i, bound in enumerate(self.bounds_ms):
            lower = self.bounds_ms[i - 1] if i else 0.0
            if lower >= threshold_ms:
                above += self.counts[i]
        return above / total

    def percentiles_ms(self, pcts=(50, 95, 99)) -> dict:
        out = {}
        for pct in pcts:
            v = self.quantile_ms(pct)
            if v is not None:
                out[f"p{pct}"] = v
        return out

    def to_dict(self) -> dict:
        return {"bounds_ms": list(self.bounds_ms), "counts": list(self.counts)}

    @classmethod
    def from_dict(cls, d: dict | None) -> "LatencyHistogram | None":
        if not isinstance(d, dict):
            return None
        try:
            return cls(tuple(d["bounds_ms"]), list(d["counts"]))
        except (KeyError, TypeError, ValueError):
            return None
