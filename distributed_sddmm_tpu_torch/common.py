"""Shared enums and integer helpers (counterpart of ``common.py``)."""

from __future__ import annotations

import enum


class KernelMode(enum.Enum):
    """The four distributed-op modes.

    * ``SDDMM_A`` — ``out_vals = S_vals * (A @ B^T sampled at pattern(S))``
    * ``SPMM_A``  — ``A += S @ B``
    * ``SPMM_B``  — ``B += S^T @ A``
    * ``SDDMM_B`` — SDDMM with values in S^T's nonzero order.
    """

    SDDMM_A = "sddmmA"
    SPMM_A = "spmmA"
    SPMM_B = "spmmB"
    SDDMM_B = "sddmmB"


class MatMode(enum.Enum):
    """Which dense matrix plays the output role."""

    A = "Amat"
    B = "Bmat"


def divide_round_up(num: int, denom: int) -> int:
    """Ceiling division."""
    return -(-num // denom)
