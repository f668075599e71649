"""Fingerprint verification protocol (counterpart of ``utils/verify.py``).

Fill A and B with the deterministic ``row * R + col`` values, run
sddmmA, spmmA, spmmB and the fused pair on one strategy, and compare the
squared-norm fingerprints with the float64 oracle's.
"""

from __future__ import annotations

import numpy as np

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.utils import oracle
from distributed_sddmm_tpu_torch.utils.coo import HostCOO


def fingerprint_algorithm(alg, S: HostCOO) -> dict[str, float]:
    """Run the verify protocol on one constructed strategy; returns the
    op -> fingerprint map (values in S's nonzero order, dense outputs in
    global row order with padding stripped)."""
    A = alg.dummy_initialize(MatMode.A)
    B = alg.dummy_initialize(MatMode.B)
    s_ones = alg.like_s_values(1.0)
    st_ones = alg.like_st_values(1.0)

    out: dict[str, float] = {}

    A_s, B_s = alg.initial_shift(A, B, KernelMode.SDDMM_A)
    mid = alg.sddmm_a(A_s, B_s, s_ones)
    out["sddmmA"] = oracle.fingerprint(alg.gather_s_values(mid))

    zero_a, B_s = alg.initial_shift(alg.like_a_matrix(0.0), B, KernelMode.SPMM_A)
    y = alg.spmm_a(zero_a, B_s, s_ones)
    y, _ = alg.de_shift(y, None, KernelMode.SPMM_A)
    out["spmmA"] = oracle.fingerprint(alg.host_a(y))

    A_s, zero_b = alg.initial_shift(A, alg.like_b_matrix(0.0), KernelMode.SPMM_B)
    yb = alg.spmm_b(A_s, zero_b, st_ones)
    _, yb = alg.de_shift(None, yb, KernelMode.SPMM_B)
    out["spmmB"] = oracle.fingerprint(alg.host_b(yb))

    A_s, B_s = alg.initial_shift(A, B, KernelMode.SDDMM_A)
    fz, fmid = alg.fused_spmm(A_s, B_s, s_ones, MatMode.A)
    fz, _ = alg.de_shift(fz, None, KernelMode.SPMM_A)
    out["fusedSpMM"] = oracle.fingerprint(alg.host_a(fz))
    out["fusedSpMM_mid"] = oracle.fingerprint(alg.gather_s_values(fmid))
    return out


def oracle_fingerprints(S: HostCOO, R: int) -> dict[str, float]:
    """The same op set computed by the float64 oracle on dummy operands."""
    A = oracle.dummy_dense(S.M, R)
    B = oracle.dummy_dense(S.N, R)
    S1 = S.with_values(np.ones_like(S.vals))
    mid = oracle.sddmm(S1, A, B)
    return {
        "sddmmA": oracle.fingerprint(mid),
        "spmmA": oracle.fingerprint(oracle.spmm_a(S1, B)),
        "spmmB": oracle.fingerprint(oracle.spmm_b(S1, A)),
        "fusedSpMM": oracle.fingerprint(oracle.spmm_a(S1.with_values(mid), B)),
        "fusedSpMM_mid": oracle.fingerprint(mid),
    }
