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
by design: they exist only to be timed.

Each wrapper takes the payload's wire type (``wire=``, one role of a
``parallel/wire.py`` policy): under ``"bf16"`` every float32 tensor is
cast to bf16 just before the collective and back to its own type right
after, so compute and every accumulation stay float32; integer tensors
(and anything else a ring carries, such as a ``LocalWorld``'s tile
views) pass through. The casts are torch ops around the comm's autograd
nodes, so a backward's cotangents cross the wire in bf16 too.
``wire="f32"`` does nothing at all: no cast, no copy.
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


def _wire_down(xs: list, wire: str) -> list:
    """Each float32 tensor of ``xs`` in the wire type (bf16 under
    ``"bf16"``); everything else as it is."""
    if wire == "f32":
        return xs
    if wire != "bf16":
        raise ValueError(f"unknown wire dtype {wire!r}")
    return [x.to(torch.bfloat16) if isinstance(x, torch.Tensor) and x.dtype == torch.float32
            else x for x in xs]


def _wire_up(ys: list, xs: list) -> list:
    """Each received block back in the type of the payload it replaced
    (every rank's payload has one type). A block several ranks share (a
    gather's) is cast once, unless autograd sees it: then each rank casts
    its own copy, so each rank's cotangent is rounded to the wire type on
    its own before the adjoint sums them in it, as between processes."""
    done: dict = {}
    out = []
    for y, x in zip(ys, xs):
        if isinstance(y, torch.Tensor) and y.dtype != x.dtype:
            if y.requires_grad and torch.is_grad_enabled():
                y = y.to(x.dtype)
            else:
                if id(y) not in done:
                    done[id(y)] = y.to(x.dtype)
                y = done[id(y)]
        out.append(y)
    return out


def abl_ppermute(comm, xs: list, axis, perm, wire: str = "f32") -> Callable:
    """Start a ring hop of the per-rank blocks ``xs``; returns the wait,
    which gives the received blocks. The identity under ``no_ring`` and
    ``local`` (Propagation). Rounding is idempotent, so a read-only
    payload riding k hops at ``wire="bf16"`` is rounded once; a traveling
    accumulator hops at the policy's ``ring_accum`` type instead."""
    if _ABLATION != "full":
        return lambda: xs
    if wire == "f32":
        return comm.ppermute_start(xs, axis, perm)
    wait = comm.ppermute_start(_wire_down(xs, wire), axis, perm)
    return lambda: _wire_up(wait(), xs)


def abl_all_gather(comm, xs: list, axis, size: int, wire: str = "f32") -> list:
    """Replication gather (tiled on dim 0); ``size`` local copies
    concatenated under ``local``."""
    if _ABLATION == "local":
        return [torch.cat([x] * size) for x in xs]
    if wire == "f32":
        return comm.all_gather(xs, axis)
    return _wire_up(comm.all_gather(_wire_down(xs, wire), axis), xs)


def abl_psum_scatter(comm, xs: list, axis, size: int, wire: str = "f32") -> list:
    """Replication reduce-scatter (sum, tiled on dim 0); the first
    ``1/size`` of each block under ``local``. ``wire="bf16"`` sums on the
    wire in bf16: the default bf16 policy keeps this role f32, and only
    an explicit ``reduce=bf16`` override reaches the cast."""
    if _ABLATION == "local":
        return [x[: x.shape[0] // size] for x in xs]
    if wire == "f32":
        return comm.reduce_scatter(xs, axis)
    return _wire_up(comm.reduce_scatter(_wire_down(xs, wire), axis), xs)


class Shifter:
    """The hops of one ring pass of per-rank blocks along ``axis``.

    Under a world whose ranks live in other processes each hop receives
    into a new buffer (the caching allocator hands back the memory of the
    blocks the ring has let go), so a hop never writes into the caller's
    input, into the block a step is reading, or into a moving tile a tile
    op saved for its backward. A world of in-process ranks rotates its
    list and moves nothing. ``wire`` is the payload's wire type (the
    role's under the strategy's policy).
    """

    def __init__(self, comm, axis, n: int, wire: str = "f32"):
        self.comm, self.axis, self.perm = comm, axis, ring_perm(n)
        self.wire = wire

    def start(self, xs: list) -> Callable:
        """Issue one hop; the returned wait gives the shifted blocks."""
        return abl_ppermute(self.comm, xs, self.axis, self.perm, self.wire)

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
