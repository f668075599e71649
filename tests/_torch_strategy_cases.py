"""Shared cases of the port's strategy suites (``test_torch_sparse_shift``,
``test_torch_cannon_dense``, ``test_torch_cannon_sparse``): one op protocol
that runs on either package's strategy, the JAX strategies on the forced
CPU mesh (kept for the session: their programs compile once a
configuration) and the comparison rule.

The protocol runs every op in A and B modes, with the pre- and post-shifts
each strategy asks for: sddmmA/B, spmmA/B into a zero output, spmmA onto a
nonzero base (the Cannon strategies accumulate into it, the sparse shift
does not), and the fused pair in both modes. S^T keeps S's nonzero order,
so one host vector serves the values of both layouts (and the Cannon
dense strategy's transposed-values quirk is invisible in host order).
Outputs are held bit for bit on integer data (every sum an integer below
2**24) and within 1e-5 of the reference's max abs value on normal data.
"""

import functools

import numpy as np

import jax

from distributed_sddmm_tpu.common import KernelMode as JaxKM
from distributed_sddmm_tpu.common import MatMode as JaxMM
from distributed_sddmm_tpu.ops.pallas_kernels import PallasKernel
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel, select_variant
from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

_JAX: dict = {}
_RESULTS: dict = {}


@functools.cache
def problem():
    """The JAX suites' matrix: Erdos-Renyi 64 x 48, 4 a row, normal values
    (one object, so its JAX strategies compile once)."""
    return JaxCOO.erdos_renyi(64, 48, 4, seed=0, values="normal")


def port_coo(S) -> HostCOO:
    return HostCOO(S.rows, S.cols, S.vals, S.M, S.N)


def data(S, R: int, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return (rng.integers(-3, 4, (S.M, R)).astype(np.float32),
                rng.integers(-3, 4, (S.N, R)).astype(np.float32),
                rng.integers(-2, 3, S.nnz).astype(np.float32))
    return (rng.standard_normal((S.M, R)).astype(np.float32),
            rng.standard_normal((S.N, R)).astype(np.float32),
            rng.standard_normal(S.nnz).astype(np.float32))


def jax_alg(cls, S, R: int, c: int, p: int = 8, pallas: bool = True, **kw):
    """The JAX strategy on ``p`` devices, through the Pallas kernels in
    interpret mode (or its default XLA kernel)."""
    key = (cls.__name__, id(S), R, c, p, pallas, tuple(sorted(kw.items())))
    if key not in _JAX:
        kernel = PallasKernel(interpret=True, precision="f32") if pallas else None
        _JAX[key] = (S, cls(S, R=R, c=c, kernel=kernel, devices=jax.devices()[:p], **kw))
    return _JAX[key][1]


def port_alg(cls, S, R: int, c: int, p: int = 8, **kw):
    return cls(port_coo(S), R=R, c=c, world=LocalWorld(p), device="cpu", **kw)


def run_ops(alg, A_np, B_np, v, jax_side: bool = False) -> dict:
    """Every op of the protocol, outputs in host order."""
    KM, MM = (JaxKM, JaxMM) if jax_side else (KernelMode, MatMode)
    A, B = alg.put_a(A_np), alg.put_b(B_np)
    sv, st = alg.scatter_s_values(v), alg.scatter_st_values(v)
    out = {}
    a, b = alg.initial_shift(A, B, KM.SDDMM_A)
    out["sddmmA"] = alg.gather_s_values(alg.sddmm_a(a, b, sv))
    a, b = alg.initial_shift(A, B, KM.SDDMM_B)
    out["sddmmB"] = alg.gather_st_values(alg.sddmm_b(a, b, st))
    z, b = alg.initial_shift(alg.like_a_matrix(0.0), B, KM.SPMM_A)
    y, _ = alg.de_shift(alg.spmm_a(z, b, sv), None, KM.SPMM_A)
    out["spmmA"] = alg.host_a(y)
    a, b = alg.initial_shift(A, B, KM.SPMM_A)
    y, _ = alg.de_shift(alg.spmm_a(a, b, sv), None, KM.SPMM_A)
    out["spmmA_base"] = alg.host_a(y)
    a, z = alg.initial_shift(A, alg.like_b_matrix(0.0), KM.SPMM_B)
    _, y = alg.de_shift(None, alg.spmm_b(a, z, st), KM.SPMM_B)
    out["spmmB"] = alg.host_b(y)
    a, b = alg.initial_shift(A, B, KM.SDDMM_A)
    y, mid = alg.fused_spmm(a, b, sv, MM.A)
    y, _ = alg.de_shift(y, None, KM.SPMM_A)
    out["fusedA"], out["fusedA_mid"] = alg.host_a(y), alg.gather_s_values(mid)
    a, b = alg.initial_shift(A, B, KM.SDDMM_B)
    y, mid = alg.fused_spmm(a, b, st, MM.B)
    _, y = alg.de_shift(None, y, KM.SPMM_B)
    out["fusedB"], out["fusedB_mid"] = alg.host_b(y), alg.gather_st_values(mid)
    return out


def _results(jax_cls, port_cls, c: int, kind: str, banked: bool) -> tuple:
    """``(port, jax)`` outputs of every op at (8, c) on the JAX suites'
    matrix, computed once a session; the port through the generic tile
    kernel or the banked one of the matrix's variant."""
    key = (port_cls.__name__, c, kind, banked)
    if key not in _RESULTS:
        S = problem()
        ops = data(S, 8, kind, seed=c)
        want = run_ops(jax_alg(jax_cls, S, 8, c), *ops, jax_side=True)
        kernel = (BankedCudaKernel(select_variant(Problem.from_coo(port_coo(S), 8)), "f32",
                                   device="cpu") if banked else None)
        _RESULTS[key] = (run_ops(port_alg(port_cls, S, 8, c, kernel=kernel), *ops), want)
    return _RESULTS[key]


def check_op(jax_cls, port_cls, op: str, c: int, banked: bool = True) -> None:
    """One op at (8, c): bit for bit on integer data (generic, and banked
    with ``banked``), within 1e-5 of the max abs value on normal data."""
    for kind in ("int", "normal"):
        got, want = _results(jax_cls, port_cls, c, kind, False)
        if kind == "int":
            np.testing.assert_array_equal(got[op], want[op], err_msg=op)
        else:
            assert np.abs(got[op] - want[op]).max() <= 1e-5 * float(np.abs(want[op]).max()), op
    if banked:
        got, want = _results(jax_cls, port_cls, c, "int", True)
        np.testing.assert_array_equal(got[op], want[op], err_msg=f"{op} banked")
