"""The shared power-of-two rounding rule (counterpart of the
``pow2_bucket`` helper of ``utils/buckets.py``).

The problem fingerprint's nnz/row bucket and the codegen variant's band
threshold both round through :func:`pow2_bucket`, so a variant id bands
rows exactly where the fingerprint buckets them, in both packages.
"""

from __future__ import annotations


def pow2_bucket(x: float) -> int:
    """``x`` rounded to the nearest power of two (>= 1), rounding at the
    geometric midpoint (6 -> 8, 5 -> 4, 1.4 -> 1)."""
    x = max(float(x), 1.0)
    b = 1
    while b * 2 <= x * (2 ** 0.5):
        b *= 2
    return b
