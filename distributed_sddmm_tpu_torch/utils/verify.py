"""Fingerprint verification protocol (counterpart of ``utils/verify.py``).

Fill A and B with the deterministic ``row * R + col`` values, run
sddmmA, spmmA, spmmB and the fused pair on one strategy, and compare the
squared-norm fingerprints with the float64 oracle's. :func:`op_outputs`
runs every op on given operands, for comparisons between strategies.
:func:`verify_algorithms` is the ``verify`` command: every named strategy
against the oracle, within a tolerance by the kernel's precision.
"""

from __future__ import annotations

import logging

import numpy as np

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.utils import oracle
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

_log = logging.getLogger("verify")

#: Fingerprint tolerance by the kernel's precision: the JAX package's
#: 1e-4 for float32 kernels, bf16 rounding for cuda-bf16.
VERIFY_RTOL = {"f32": 1e-4, "bf16": 1e-2}


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


def op_outputs(alg, A_host, B_host, vals) -> dict:
    """Every op in A and B modes on host operands, with the pre- and
    post-shifts the strategy asks for, in host order: sddmmA/B, spmmA/B
    into a zero output, and the fused pair in both modes (values and
    output). ``vals`` serves both value layouts: S^T keeps S's nonzero
    order."""
    A, B = alg.put_a(A_host), alg.put_b(B_host)
    sv, st = alg.scatter_s_values(vals), alg.scatter_st_values(vals)
    out = {}
    a, b = alg.initial_shift(A, B, KernelMode.SDDMM_A)
    out["sddmmA"] = alg.gather_s_values(alg.sddmm_a(a, b, sv))
    a, b = alg.initial_shift(A, B, KernelMode.SDDMM_B)
    out["sddmmB"] = alg.gather_st_values(alg.sddmm_b(a, b, st))
    z, b = alg.initial_shift(alg.like_a_matrix(0.0), B, KernelMode.SPMM_A)
    out["spmmA"] = alg.host_a(alg.de_shift(alg.spmm_a(z, b, sv), None, KernelMode.SPMM_A)[0])
    a, z = alg.initial_shift(A, alg.like_b_matrix(0.0), KernelMode.SPMM_B)
    out["spmmB"] = alg.host_b(alg.de_shift(None, alg.spmm_b(a, z, st), KernelMode.SPMM_B)[1])
    a, b = alg.initial_shift(A, B, KernelMode.SDDMM_A)
    y, mid = alg.fused_spmm(a, b, sv, MatMode.A)
    out["fusedA"] = alg.host_a(alg.de_shift(y, None, KernelMode.SPMM_A)[0])
    out["fusedA_mid"] = alg.gather_s_values(mid)
    a, b = alg.initial_shift(A, B, KernelMode.SDDMM_B)
    y, mid = alg.fused_spmm(a, b, st, MatMode.B)
    out["fusedB"] = alg.host_b(alg.de_shift(None, y, KernelMode.SPMM_B)[1])
    out["fusedB_mid"] = alg.gather_st_values(mid)
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


def verify_algorithms(log_m: int = 8, edge_factor: int = 8, R: int = 16, c: int = 1,
                      alg_names=None, kernel=None, rtol: float | None = None,
                      verbose: bool = False, S: HostCOO | None = None,
                      device=None, world=None) -> bool:
    """Every named strategy's fingerprints against the float64 oracle's, on
    the R-mat of ``(log_m, edge_factor)`` (seed 0) or on ``S``. True iff
    every strategy that takes the configuration matches within ``rtol``
    (None: ``VERIFY_RTOL`` of the kernel's precision); a strategy that
    refuses the grid or R is skipped with a note under the ``"verify"``
    logger. With ``verbose`` one ``OK``/``FAIL`` line an op."""
    from distributed_sddmm_tpu_torch.bench.harness import ALGORITHM_FACTORIES, make_algorithm

    if S is None:
        S = HostCOO.rmat(log_m, edge_factor, seed=0)
    want = oracle_fingerprints(S, R)
    all_ok = True
    for name in alg_names or sorted(ALGORITHM_FACTORIES):
        try:
            alg = make_algorithm(name, S, R, c, kernel=kernel, device=device, world=world)
        except ValueError as e:
            _log.info("skip %s: %s", name, e)
            continue
        tol = rtol if rtol is not None else VERIFY_RTOL[
            getattr(alg.kernel, "precision", "f32")]
        got = fingerprint_algorithm(alg, S)
        for op, v in want.items():
            ok = bool(np.isclose(got[op], v, rtol=tol))
            all_ok &= ok
            if verbose and alg.world.process_index == 0:
                flag = "OK " if ok else "FAIL"
                print(f"{flag} {name:22s} {op:14s} got={got[op]:.6e} want={v:.6e}",
                      flush=True)
    return all_ok
