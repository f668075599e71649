"""Numerical guardrails: NaN/Inf sentinels and CG divergence detection
(counterpart of ``resilience/guards.py``).

Guards are off by default: a finite check is one device reduction and a
scalar copy to the host per guarded output. ``SDDMM_TORCH_GUARDS=1`` turns
them on, as do the apps' own ``guard`` knobs. (The JAX package also turns
them on under an active fault plan; fault plans are not ported, ROADMAP.md
queue A item 14.)

``SDDMM_TORCH_GUARD_MODE`` selects what a tripped sentinel does: ``raise``
(the default: a :class:`NumericalFault` naming the op) or ``repair``
(``nan_to_num`` the poisoned tensors and log a warning).
"""

from __future__ import annotations

import logging
import math
import os

import torch

GUARDS_ENV = "SDDMM_TORCH_GUARDS"
GUARD_MODE_ENV = "SDDMM_TORCH_GUARD_MODE"

_log = logging.getLogger("guards")


class NumericalFault(ArithmeticError):
    """A guarded output contained NaN or Inf."""


def enabled() -> bool:
    """True when ``SDDMM_TORCH_GUARDS`` is 1, on, true or yes."""
    return os.environ.get(GUARDS_ENV, "").lower() in ("1", "on", "true", "yes")


def guard_mode() -> str:
    mode = os.environ.get(GUARD_MODE_ENV, "raise").lower()
    return mode if mode in ("raise", "repair") else "raise"


def _float_leaves(tree) -> list:
    """The floating tensors of a tensor, or of nested lists, tuples and
    dict values of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _float_leaves(t)]
    return []


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return tree


def all_finite(tree) -> bool:
    """One device reduction and scalar copy per floating tensor."""
    return all(bool(torch.isfinite(leaf).all()) for leaf in _float_leaves(tree))


def check_finite(name: str, tree) -> None:
    """Raise :class:`NumericalFault` naming ``name`` on any NaN/Inf."""
    if not all_finite(tree):
        raise NumericalFault(f"non-finite values in output of {name}")


def guard_output(name: str, tree, mode: str | None = None):
    """Sentinel and repair in one call: returns ``tree``, repaired in
    ``repair`` mode (``torch.nan_to_num`` of every floating tensor);
    ``raise`` mode raises :class:`NumericalFault`."""
    if all_finite(tree):
        return tree
    if (mode or guard_mode()) == "raise":
        raise NumericalFault(f"non-finite values in output of {name}")
    _log.warning("repaired non-finite output of %s", name)
    return _map(torch.nan_to_num, tree)


class CGGuard:
    """Residual-divergence detector for the batched-CG inner loop.

    CG on the ridge normal equations drives the summed squared residual
    down (up to float noise); sustained growth means the Gram operator went
    inconsistent or the system is indefinite. Trips after ``patience``
    consecutive iterations of ``rs > growth_tol * best_rs``, or at once on
    a non-finite residual.
    """

    def __init__(self, growth_tol: float = 10.0, patience: int = 2):
        self.growth_tol = growth_tol
        self.patience = patience
        self.best: float | None = None
        self.strikes = 0

    def update(self, rs: float) -> bool:
        """Feed one iteration's summed squared residual; True = diverged."""
        if not math.isfinite(rs):
            return True
        if self.best is None or rs < self.best:
            self.best = rs
            self.strikes = 0
            return False
        if rs > self.growth_tol * max(self.best, 1e-30):
            self.strikes += 1
        else:
            self.strikes = 0
        return self.strikes >= self.patience
