"""Shared ring-loop machinery for the shift strategies (counterpart of
``parallel/loops.py``).

Every strategy's inner loop is ``n`` steps of compute and rotate. The
loops here run in Python, one step after another: the JAX package's
``unroll`` switch and its rolled ``fori_loop`` only bound XLA's compile
time and have no counterpart in eager PyTorch, so they are not ported.

The shift after the final step is often waste (the rotated operand is
discarded) but sometimes required (a traveling operand must complete its
round trip home). ``shift_final`` / ``final_shift`` say which: without it
a ring of ``n`` steps makes ``n - 1`` hops, with it ``n``.

The ``abl_*`` wrappers are the collectives as the strategies call them,
under an ablation mode that :meth:`~distributed_sddmm_tpu_torch.parallel.
base.DistributedSparse.measure_breakdown` sets to attribute time:

* ``"full"``    -- the real program;
* ``"no_ring"`` -- ring hops replaced by the identity (compute and the
  replication collectives remain);
* ``"local"``   -- every collective replaced by a local op of the same
  shape (compute only).

Computation ~= t(local); Replication ~= t(no_ring) - t(local);
Propagation ~= t(full) - t(no_ring). Ablated programs give wrong numbers
by design: they exist only to be timed. Payloads cross at float32 (the
JAX package's ``wire="f32"``; other wire precisions are not ported).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

_ABLATION = "full"
ABLATION_MODES = ("full", "no_ring", "local")


def ring_perm(n: int) -> list:
    """The +1 ring permutation for an axis of size n."""
    return [(k, (k + 1) % n) for k in range(n)]


def ablation() -> str:
    return _ABLATION


@contextlib.contextmanager
def ablation_mode(mode: str):
    if mode not in ABLATION_MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; expected {ABLATION_MODES}")
    global _ABLATION
    prev = _ABLATION
    _ABLATION = mode
    try:
        yield
    finally:
        _ABLATION = prev


def abl_ppermute(comm, xs: list, axis, perm, out: list | None = None) -> Callable:
    """Start a ring hop of the per-rank blocks ``xs``; returns the wait,
    which gives the received blocks. The identity under ``no_ring`` and
    ``local`` (Propagation)."""
    if _ABLATION != "full":
        return lambda: xs
    return comm.ppermute_start(xs, axis, perm, out)


def abl_all_gather(comm, xs: list, axis, size: int) -> list:
    """Replication gather (tiled on dim 0); ``size`` local copies
    concatenated under ``local``."""
    if _ABLATION == "local":
        return [torch.cat([x] * size) for x in xs]
    return comm.all_gather(xs, axis)


def abl_psum_scatter(comm, xs: list, axis, size: int) -> list:
    """Replication reduce-scatter (sum, tiled on dim 0); the first
    ``1/size`` of each block under ``local``."""
    if _ABLATION == "local":
        return [x[: x.shape[0] // size] for x in xs]
    return comm.reduce_scatter(xs, axis)


class Shifter:
    """The hops of one ring pass of per-rank blocks along ``axis``.

    Under a world whose ranks live in other processes each hop receives
    into a buffer of this pass: two at most, allocated on first use and
    swapped, so a hop never writes into the caller's input or into the
    block a step is reading. A world of in-process ranks rotates its list
    and needs none.
    """

    def __init__(self, comm, axis, n: int):
        self.comm, self.axis, self.perm = comm, axis, ring_perm(n)
        self._bufs: list = []

    def start(self, xs: list) -> Callable:
        """Issue one hop; the returned wait gives the shifted blocks."""
        out = None
        if not self.comm.in_process:
            x = xs[0]
            recv = next((b for b in self._bufs if b is not x), None)
            if recv is None:
                recv = torch.empty_like(x)
                self._bufs.append(recv)
            out = [recv]
        return abl_ppermute(self.comm, xs, self.axis, self.perm, out)

    def __call__(self, xs: list) -> list:
        return self.start(xs)()


def ring_loop(n: int, body: Callable, state, shift_between: Callable,
              shift_final: Optional[Callable] = None):
    """Run ``state = body(s, state)`` for s in 0..n-1 with
    ``shift_between`` applied between steps and ``shift_final`` (if any)
    after the last."""
    for s in range(n):
        state = body(s, state)
        if s < n - 1:
            state = shift_between(state)
    if shift_final is not None and n > 1:
        state = shift_final(state)
    return state


def ring_loop_overlap(n: int, body: Callable, carry, mov, start_shift: Callable,
                      final_shift: bool = False, shift_carry: Optional[Callable] = None):
    """Double-buffered ring loop, the paper's local kernel overlap: each
    step issues the next hop of the moving operand before the body
    consumes the resident one, and waits for it after the body, so a
    hop between processes runs while the step computes.

    ``body(s, carry, mov) -> carry``; ``start_shift(mov)`` issues a hop
    and returns its wait. ``shift_carry`` hops state that travels but
    depends on the body (the sparse shift's accumulating dots): after the
    body, with the moving operand's hops. With ``final_shift`` the hop
    after the last step runs too; hop counts are the sequential
    :func:`ring_loop`'s: ``n - 1`` without it, ``n`` with (none when
    ``n == 1``). Every body consumes exactly the blocks the sequential
    loop would, in the same order, so the results are the same bits.
    Returns ``(carry, mov)``."""
    final_shift = final_shift and n > 1
    for s in range(n):
        wait = start_shift(mov) if s < n - 1 or final_shift else None
        carry = body(s, carry, mov)
        if wait is not None:
            if shift_carry is not None:
                carry = shift_carry(carry)
            mov = wait()
    return carry, mov
