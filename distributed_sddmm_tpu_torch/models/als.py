"""ALS collaborative filtering via batched conjugate gradients (counterpart
of ``models/als.py``).

Alternating optimization of embeddings A (M x R) and B (N x R) against
observed sparse entries: each half-step solves the ridge normal equations
of one factor with a batched (per-row) CG whose matrix-vector product is
the fused SDDMM->SpMM pair plus ``lambda * X``. The dense operands are the
strategy's canonical tensors (its held rank blocks); the CG's per-row dots
are the strategy's :meth:`~distributed_sddmm_tpu_torch.parallel.base.
DistributedSparse.batch_dot`, which on an R-split strategy sums a row's
partial dots over the blocks that hold its R-slices (the psum XLA inserts
in the JAX package).

Every CG iteration applies the Gram operator through the public ops,
with ``initial_shift`` / ``de_shift`` around them
(:meth:`DistributedALS.compute_queries`). The counters follow the JAX
package's records: on ``DenseShift15D``, where the JAX package runs an
iteration as one program, one ``cgStep`` times each iteration (the public
ops inside it run untimed); on the R-split strategies (``SparseShift15D``,
``CannonDense25D``, ``CannonSparse25D``) the per-op counters show its
sddmm and spmm.

The CG carries are updated in place (this port's counterpart of the JAX
program's buffer donation): ``X`` is a copy of the factor and ``p`` a copy
of ``r``, so the committed factors stay untouched until a half-step
succeeds. The solver runs under ``torch.no_grad()``.

Resilience:

* **Checkpoint and resume**: ``run_cg(checkpoint=store,
  checkpoint_every=k, resume=True)`` persists the factors after every
  k-th alternating step (the JAX package's store format; under a world of
  processes the factors are gathered and process 0 writes) and resumes
  from the newest loadable checkpoint. Each step is a deterministic
  function of (A, B), so a killed and resumed run ends with the factors
  of an uninterrupted one, bit for bit.
* **CG divergence ladder** (while guards are on): a growing or non-finite
  residual triggers a damped-lambda restart of the half-step from the
  pre-step factors (ridge stiffened by ``damp_factor``); if that diverges
  too, a strategy on the CPU continues on the float64 serial solver
  (``models/serial_als.py``; pass ``S_host``). On the card, or without
  ``S_host``, the second failure raises
  :class:`~distributed_sddmm_tpu_torch.resilience.guards.NumericalFault`:
  a kernel that writes NaN is never hidden behind a host answer.

The fault-injection hooks of the JAX package (``als:step``,
``als:cg_iter``), its watchdog and ``from_plan`` are not ported (ROADMAP.md,
queue A items 11 and 14); its trace spans and log lines are Python
``logging`` under the logger ``"als"``. Random draws come from a
``torch.Generator`` seeded with ``seed`` and cannot equal ``jax.random``'s.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.parallel.mesh import AXES
from distributed_sddmm_tpu_torch.resilience import guards
from distributed_sddmm_tpu_torch.resilience.guards import CGGuard, NumericalFault

_log = logging.getLogger("als")

#: The CG's ``nan_avoidance_constant``.
EPS = 1e-8


class CGDivergence(ArithmeticError):
    """The batched-CG residual grew, or went non-finite, past the guard's
    tolerance: the Gram operator is inconsistent or the system too
    ill-conditioned for the current ridge."""


def _scale_rows(scale: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    return mat * scale.unsqueeze(-1)


def _cg_vector_update(X, r, p, rsold, Mp, dot, eps: float = EPS):
    """One CG iteration's vector algebra given the Gram product ``Mp`` and
    the per-row dot ``dot(x, y)``; updates ``X``, ``r`` and ``p`` in place
    and returns ``(X, r, p, rsnew)``."""
    alpha = (rsold + eps) / (dot(p, Mp) + eps)
    X.add_(_scale_rows(alpha, p))
    r.sub_(_scale_rows(alpha, Mp))
    rsnew = dot(r, r)
    p.mul_((rsnew / (rsold + eps)).unsqueeze(-1)).add_(r)
    return X, r, p, rsnew


def _no_mark(part: str, value=None) -> None:
    pass


class DistributedALS:
    """Alternating least squares over any distributed strategy."""

    def __init__(self, d_ops: DistributedSparse, seed: int = 0, ridge_lambda: float = 1e-6,
                 artificial_groundtruth: bool = True,
                 ground_truth_vals: np.ndarray | None = None,
                 ground_truth_vals_transpose: np.ndarray | None = None,
                 S_host=None, guard: str | bool = "auto", damp_factor: float = 1e3):
        self.d_ops = d_ops
        # One cgStep an iteration where the JAX package runs it as one
        # program: the strategy whose blocks hold whole rows.
        self._unit = not d_ops.r_split
        self.seed = seed
        self.ridge_lambda = ridge_lambda
        # ``guard`` "auto" follows guards.enabled(); S_host enables the
        # ladder's last rung (the serial solver).
        self.S_host = S_host
        self._guard = guard
        self.damp_factor = damp_factor
        self.degraded: str | None = None
        self._ones_vals: dict = {}

        if artificial_groundtruth:
            # Observations from an SDDMM of small random factors: a correct
            # solver drives the residual toward zero.
            Agt = self._random_like(0, MatMode.A) / d_ops.R
            Bgt = self._random_like(1, MatMode.B) / d_ops.R
            Agt_s, Bgt_s = d_ops.initial_shift(Agt, Bgt, KernelMode.SDDMM_A)
            self.ground_truth = d_ops.sddmm_a(Agt_s, Bgt_s, self._ones(MatMode.A))
            Agt_s, Bgt_s = d_ops.initial_shift(Agt, Bgt, KernelMode.SDDMM_B)
            self.ground_truth_transpose = d_ops.sddmm_b(Agt_s, Bgt_s, self._ones(MatMode.B))
        else:
            if ground_truth_vals is None:
                raise ValueError("ground_truth_vals required when artificial_groundtruth=False")
            self.ground_truth = d_ops.scatter_s_values(ground_truth_vals)
            # B half-steps need the observations in S^T's nonzero order
            # (S.with_values(obs).transpose().vals).
            self.ground_truth_transpose = (
                d_ops.scatter_st_values(ground_truth_vals_transpose)
                if ground_truth_vals_transpose is not None else None)
        self.A: torch.Tensor | None = None
        self.B: torch.Tensor | None = None

    def _random_like(self, stream: int, mode: MatMode) -> torch.Tensor:
        """Uniform(-1, 1) over the whole padded operand, drawn on the
        strategy's device from a generator of its own (seed, stream), so
        every world and every call draws the same values; a process keeps
        its block."""
        d = self.d_ops
        n_pad = d.M_pad if mode == MatMode.A else d.N_pad
        gen = torch.Generator(device=d.device).manual_seed(4 * self.seed + stream)
        x = torch.rand((n_pad, d.R), generator=gen, dtype=d.dtype, device=d.device) * 2 - 1
        return d.put_a(x) if mode == MatMode.A else d.put_b(x)

    def _ones(self, mode: MatMode) -> torch.Tensor:
        """The unit values of S (A mode) or S^T (B mode), built once."""
        if mode not in self._ones_vals:
            d = self.d_ops
            self._ones_vals[mode] = (d.like_s_values(1.0) if mode == MatMode.A
                                     else d.like_st_values(1.0))
        return self._ones_vals[mode]

    def initialize_embeddings(self) -> None:
        """The same draws on every call."""
        R = self.d_ops.R
        self.A = self._random_like(2, MatMode.A) / R * 1.4
        self.B = self._random_like(3, MatMode.B) / R / 1.3

    # ------------------------ normal-equation pieces ----------------------- #

    def compute_rhs(self, mode: MatMode) -> torch.Tensor:
        """``rhs = S_gt @ B`` (A mode) or ``S_gt^T @ A`` (B mode)."""
        d = self.d_ops
        if mode == MatMode.A:
            zero, B_s = d.initial_shift(d.like_a_matrix(0.0), self.B, KernelMode.SPMM_A)
            out, _ = d.de_shift(d.spmm_a(zero, B_s, self.ground_truth), None,
                                KernelMode.SPMM_A)
            return out
        if self.ground_truth_transpose is None:
            raise ValueError(
                "B-mode optimization requires transposed ground-truth values: "
                "pass ground_truth_vals_transpose (observations in "
                "S.transpose() nonzero order) to DistributedALS")
        A_s, zero = d.initial_shift(self.A, d.like_b_matrix(0.0), KernelMode.SPMM_B)
        _, out = d.de_shift(None, d.spmm_b(A_s, zero, self.ground_truth_transpose),
                            KernelMode.SPMM_B)
        return out

    def compute_queries(self, A, B, mode: MatMode, lam: float | None = None,
                        mark=_no_mark) -> torch.Tensor:
        """The Gram operator: ``fusedSpMM + lam * X`` (``lam`` overrides
        the ridge for damped restarts). ``mark("pair", out)`` is called
        after the shifted pair is issued (a timing hook; it does nothing
        by default)."""
        lam = self.ridge_lambda if lam is None else lam
        d = self.d_ops
        if mode == MatMode.A:
            A_s, B_s = d.initial_shift(A, B, KernelMode.SDDMM_A)
            out, _ = d.fused_spmm(A_s, B_s, self._ones(mode), MatMode.A)
            out, _ = d.de_shift(out, None, KernelMode.SPMM_A)
            mark("pair", out)
            return out + lam * A
        A_s, B_s = d.initial_shift(A, B, KernelMode.SDDMM_B)
        out, _ = d.fused_spmm(A_s, B_s, self._ones(mode), MatMode.B)
        _, out = d.de_shift(None, out, KernelMode.SPMM_B)
        mark("pair", out)
        return out + lam * B

    # ------------------------------ batched CG ----------------------------- #

    def _cg_step(self, mode: MatMode, lam: float, X, r, p, rsold, mark=_no_mark):
        """One CG iteration from the carries, the Gram product of ``p`` and
        the vector algebra; returns ``(X, r, p, rsnew)``. One ``cgStep`` on
        the dense shift, the public ops' counters elsewhere."""
        def step():
            Mp = (self.compute_queries(p, self.B, mode, lam, mark) if mode == MatMode.A
                  else self.compute_queries(self.A, p, mode, lam, mark))
            return _cg_vector_update(X, r, p, rsold, Mp, self._dot(mode))

        return self.d_ops._timed("cgStep", step) if self._unit else step()

    def _dot(self, mode: MatMode):
        """The per-row dot over ``mode``'s operand layout."""
        return lambda x, y: self.d_ops.batch_dot(x, y, mode)

    def _guard_active(self) -> bool:
        return guards.enabled() if self._guard == "auto" else bool(self._guard)

    @torch.no_grad()
    def _cg_run(self, mode: MatMode, cg_max_iter: int, lam: float) -> torch.Tensor:
        """One half-step's solve from the current factors; returns the new
        X without committing it. Raises :class:`CGDivergence` when the
        residual guard trips (checked only while guarding: one scalar copy
        to the host an iteration)."""
        cg_guard = CGGuard() if self._guard_active() else None
        dot = self._dot(mode)
        # The initial residual and every iteration see the same ridge.
        r = self.compute_rhs(mode) - self.compute_queries(self.A, self.B, mode, lam=lam)
        rsold = dot(r, r)
        # The in-place updates must touch neither the committed factor nor r
        # through p.
        X = (self.A if mode == MatMode.A else self.B).clone()
        p = r.clone()
        for _ in range(cg_max_iter):
            X, r, p, rsold = self._cg_step(mode, lam, X, r, p, rsold)
            if cg_guard is not None and cg_guard.update(float(rsold.sum())):
                raise CGDivergence(f"CG residual diverged in {mode.name} half-step "
                                   f"(λ={lam:g})")
        return X

    def cg_optimizer(self, mode: MatMode, cg_max_iter: int = 10) -> None:
        """One half-step through the ladder: solve, and on divergence (or a
        :class:`NumericalFault`) retry once from the pre-step factors with
        a ``damp_factor``-stiffer ridge. A second failure raises
        :class:`CGDivergence`; :meth:`run_cg` owns the last rung."""
        try:
            X = self._cg_run(mode, cg_max_iter, self.ridge_lambda)
        except (CGDivergence, NumericalFault) as first:
            if not self._guard_active():
                raise
            damped = self.ridge_lambda * self.damp_factor
            _log.warning("%s in %s half-step; damped-λ restart at λ=%g",
                         type(first).__name__, mode.name, damped)
            try:
                X = self._cg_run(mode, cg_max_iter, damped)
            except (CGDivergence, NumericalFault) as second:
                raise CGDivergence(
                    f"{mode.name} half-step diverged at λ={self.ridge_lambda:g} "
                    f"and at damped λ={damped:g}: {second}") from second
        if mode == MatMode.A:
            self.A = X
        else:
            self.B = X

    # ------------------- checkpoint, resume, degradation ------------------- #

    def _global_shape(self, mode: MatMode) -> tuple:
        d = self.d_ops
        return (d.M_pad if mode == MatMode.A else d.N_pad, d.R)

    def save_checkpoint(self, store, step: int) -> None:
        """Persist the factors as alternating step ``step``: the whole
        padded ``(M_pad, R)`` / ``(N_pad, R)`` operands in global row and
        column order, whatever the strategy's layout (the dense shift's is
        how the JAX package stores them). Under a world of processes they
        are gathered, process 0 writes, and every process reads the same
        store on resume (a directory all of them see)."""
        d = self.d_ops
        A, B = d._to_global(self.A, MatMode.A), d._to_global(self.B, MatMode.B)
        if d.world.process_index == 0:
            store.save(step, {"A": A.cpu().numpy(), "B": B.cpu().numpy()},
                       meta={"kind": "als", "R": d.R, "M": d.M, "N": d.N})
        if not d.comm.in_process:
            # A barrier: no process reads the store before process 0 wrote.
            d.comm.all_reduce([torch.zeros(1, device=d.device)], AXES)

    def restore_checkpoint(self, store) -> int:
        """Load the newest valid checkpoint into the factors; returns the
        alternating step to resume from (0: a fresh start). A foreign
        ``kind`` or other factor shapes read as no checkpoint."""
        loaded = store.load_latest()
        if loaded is None:
            return 0
        step, arrays, meta = loaded
        if meta and meta.get("kind") not in (None, "als"):
            return 0  # never resurrect GAT weights as factors
        # A directory shared across configurations must not restore another
        # problem's factors as this one's.
        want_a, want_b = self._global_shape(MatMode.A), self._global_shape(MatMode.B)
        if ("A" not in arrays or "B" not in arrays
                or tuple(arrays["A"].shape) != want_a
                or tuple(arrays["B"].shape) != want_b):
            _log.warning("ignoring checkpoint with mismatched factor shapes "
                         "(want %s and %s); fresh start", want_a, want_b)
            return 0
        self.A = self.d_ops.put_a(arrays["A"])
        self.B = self.d_ops.put_b(arrays["B"])
        return step

    def degrade_to_serial(self, n_steps: int, cg_iters: int = 10,
                          cause: CGDivergence | None = None) -> None:
        """The ladder's last rung: continue on the float64 serial solver,
        seeded from the current factors. Needs ``S_host`` and a strategy on
        the CPU: on the card it raises :class:`NumericalFault` (naming
        ``cause``, the half-step that failed at both ridges), as the
        divergence is then the card's to answer for, not the host's."""
        from distributed_sddmm_tpu_torch.models.serial_als import SerialALS

        d = self.d_ops
        if d.device.type != "cpu":
            raise NumericalFault(
                f"distributed ALS diverged on {d.device} ({cause}); no host "
                "fallback runs for a strategy on the card")
        if self.S_host is None:
            raise NumericalFault(
                "distributed ALS diverged and no S_host was provided for the "
                "serial fallback; pass S_host=<HostCOO> to DistributedALS")
        serial = SerialALS(self.S_host, d.R, ridge_lambda=self.ridge_lambda * self.damp_factor,
                           artificial_groundtruth=False,
                           ground_truth_vals=d.gather_s_values(self.ground_truth))
        serial.A = d.host_a(self.A).astype(np.float64)
        serial.B = d.host_b(self.B).astype(np.float64)
        serial.run_cg(n_steps, cg_iters=cg_iters)
        self.A = d.put_a(serial.A.astype(np.float32))
        self.B = d.put_b(serial.B.astype(np.float32))
        self.degraded = "serial"
        _log.warning("degraded to the serial solver for %d remaining steps", n_steps)

    def run_cg(self, n_alternating_steps: int, cg_iters: int = 10, *, checkpoint=None,
               checkpoint_every: int = 1, resume: bool = False) -> None:
        """``n_alternating_steps`` steps of an A then a B half-step. With a
        :class:`~distributed_sddmm_tpu_torch.resilience.CheckpointStore`
        the factors persist every ``checkpoint_every`` steps and after the
        last; ``resume=True`` restarts from the newest valid checkpoint
        (corrupt ones scan back; none: step 0)."""
        checkpoint_every = max(1, int(checkpoint_every))
        step = 0
        if checkpoint is not None and resume:
            step = self.restore_checkpoint(checkpoint)
        if self.A is None:
            self.initialize_embeddings()
        while step < n_alternating_steps:
            try:
                self.cg_optimizer(MatMode.A, cg_iters)
                self.cg_optimizer(MatMode.B, cg_iters)
            except CGDivergence as e:
                _log.error("%s", e)
                self.degrade_to_serial(n_alternating_steps - step, cg_iters, cause=e)
                return
            step += 1
            if checkpoint is not None and (step % checkpoint_every == 0
                                           or step == n_alternating_steps):
                self.save_checkpoint(checkpoint, step)

    def item_factors(self) -> np.ndarray:
        """The item factors ``(N, R)`` in global row order on the host."""
        if self.B is None:
            raise ValueError("no factors yet: run initialize_embeddings()/run_cg() "
                             "or restore a checkpoint first")
        return self.d_ops.host_b(self.B)

    @torch.no_grad()
    def compute_residual(self) -> float:
        """``||sddmm(A, B) - ground_truth||_2`` over the nonzeros, in float64
        on the host (pad slots never enter)."""
        d = self.d_ops
        A_s, B_s = d.initial_shift(self.A, self.B, KernelMode.SDDMM_A)
        pred = d.gather_s_values(d.sddmm_a(A_s, B_s, self._ones(MatMode.A)))
        diff = pred.astype(np.float64) - d.gather_s_values(self.ground_truth).astype(np.float64)
        return float(np.sqrt(np.sum(diff * diff)))
