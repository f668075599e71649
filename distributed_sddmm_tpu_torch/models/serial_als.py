"""Single-node ALS-CG in float64 numpy (counterpart of
``models/serial_als.py``).

The same alternating batched-CG structure as
:class:`~distributed_sddmm_tpu_torch.models.als.DistributedALS`, over host
arrays and the float64 oracle's sparse ops (``utils/oracle.py``). It is the
oracle the distributed ALS is tested against, and the last rung of that
solver's degradation ladder.
"""

from __future__ import annotations

import numpy as np

from distributed_sddmm_tpu_torch.utils import oracle
from distributed_sddmm_tpu_torch.utils.coo import HostCOO


class SerialALS:
    """Alternating least squares on one host."""

    def __init__(self, S: HostCOO, R: int, seed: int = 0, ridge_lambda: float = 1e-6,
                 artificial_groundtruth: bool = True,
                 ground_truth_vals: np.ndarray | None = None):
        self.S = S
        self.R = R
        self.ridge_lambda = ridge_lambda
        rng = np.random.default_rng(seed)
        self._ones = S.with_values(np.ones(S.nnz))
        if artificial_groundtruth:
            Agt = rng.uniform(-1, 1, (S.M, R)) / R
            Bgt = rng.uniform(-1, 1, (S.N, R)) / R
            self.ground_truth = oracle.sddmm(self._ones, Agt, Bgt)
        else:
            if ground_truth_vals is None:
                raise ValueError("ground_truth_vals required")
            self.ground_truth = np.asarray(ground_truth_vals, dtype=np.float64)
        self._S_gt = S.with_values(self.ground_truth)
        self.A = rng.uniform(-1, 1, (S.M, R)) / R * 1.4
        self.B = rng.uniform(-1, 1, (S.N, R)) / R / 1.3

    def _queries(self, A, B, mode: str) -> np.ndarray:
        """Gram operator: SDDMM, SpMM, plus the ridge."""
        S_mid = self.S.with_values(oracle.sddmm(self._ones, A, B))
        if mode == "A":
            return oracle.spmm_a(S_mid, B) + self.ridge_lambda * A
        return oracle.spmm_b(S_mid, A) + self.ridge_lambda * B

    def _rhs(self, mode: str) -> np.ndarray:
        if mode == "A":
            return oracle.spmm_a(self._S_gt, self.B)
        return oracle.spmm_b(self._S_gt, self.A)

    def _cg(self, mode: str, iters: int) -> None:
        eps = 1e-8
        X = self.A if mode == "A" else self.B
        r = self._rhs(mode) - self._queries(self.A, self.B, mode)
        p = r.copy()
        rsold = np.sum(r * r, axis=1)
        for _ in range(iters):
            Mp = (self._queries(p, self.B, mode) if mode == "A"
                  else self._queries(self.A, p, mode))
            alpha = (rsold + eps) / (np.sum(p * Mp, axis=1) + eps)
            X = X + alpha[:, None] * p
            r = r - alpha[:, None] * Mp
            rsnew = np.sum(r * r, axis=1)
            p = r + (rsnew / (rsold + eps))[:, None] * p
            rsold = rsnew
        if mode == "A":
            self.A = X
        else:
            self.B = X

    def run_cg(self, n_alternating_steps: int, cg_iters: int = 10) -> None:
        for _ in range(n_alternating_steps):
            self._cg("A", cg_iters)
            self._cg("B", cg_iters)

    def compute_residual(self) -> float:
        pred = oracle.sddmm(self._ones, self.A, self.B)
        return float(np.linalg.norm(pred - self.ground_truth))
