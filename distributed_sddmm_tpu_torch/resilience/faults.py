"""Seeded, deterministic fault-injection plans (counterpart of
``resilience/faults.py``; the same plans fire on the same calls and
corrupt the same elements in both packages).

A :class:`FaultPlan` is a list of :class:`FaultSpec`: a *site* pattern
(an fnmatch glob over the site strings the hooks pass), a *kind*, and a
firing rule -- call indices at the site (``at``) or a probability a call
(``prob``). Whether a call fires is a pure function of (plan seed, spec
index, site, call count): the SHA-256 rule of :func:`_unit_hash`, so a
plan replays identically across runs, processes and packages.

==========  =======================  ========================================
kind        hook                     effect
==========  =======================  ========================================
nan / inf   :func:`corrupt_outputs`  overwrite a fraction of the elements
timeout     :func:`maybe_raise`      raise :class:`InjectedTimeout`
oom         :func:`maybe_raise`      raise :class:`InjectedOOM`
error       :func:`maybe_raise`      raise :class:`InjectedFault`
delay       :func:`maybe_raise`      sleep ``param`` seconds (a straggler)
garble      :func:`garble_text`      flip bytes mid-payload before a write
truncate    :func:`garble_text`      cut the payload (a torn write)
kill        :func:`maybe_kill`       ``os._exit(KILL_EXIT_CODE)``
skew        :func:`scale_value`      multiply a counted quantity (the
            ``comm:<op>`` sites: layout math drifting from the model)
==========  =======================  ========================================

Sites: ``execute:<op>`` and ``output:<op>`` at every timed op
(``parallel/base.py``), ``comm:<op>`` where an op's words are counted,
``als:step`` and ``als:cg_iter`` in ALS, ``write:<file name>`` in
``utils/atomic.py``.

Activation: :func:`install` / the :func:`fault_plan` context, the CLI's
``--faults``, or ``SDDMM_TORCH_FAULTS`` (a JSON spec list, a ``{"seed",
"specs"}`` object, ``@/path/plan.json``, or the ``delay,nan`` shorthand),
which reaches worker processes. With no plan every hook is one ``None``
check.

``nan``/``inf`` corruption writes the Weyl index sequence of the JAX
package's ``_corrupt_leaf`` into a copy of each floating tensor, on the
tensor's own device: the indices are computed there and nothing of the
tensor crosses to the host.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import json
import os
import pathlib
import sys
import threading
import time
from typing import Optional

import torch

#: Exit code of ``kill`` faults, distinguishable from a Python crash.
KILL_EXIT_CODE = 17

FAULTS_ENV = "SDDMM_TORCH_FAULTS"

_KINDS = ("nan", "inf", "timeout", "oom", "error", "delay", "garble",
          "truncate", "kill", "skew")

#: The comma shorthand (``FaultPlan.from_spec("delay,nan")``): each kind
#: at its natural site family.
SHORTHAND_SITES = {
    "nan": "output:*", "inf": "output:*",
    "timeout": "execute:*", "oom": "execute:*", "error": "execute:*",
    "delay": "execute:*",
    "garble": "write:*", "truncate": "write:*",
    "kill": "worker:*", "skew": "comm:*",
}
SHORTHAND_PROB = 0.1
SHORTHAND_PARAM = {"delay": 0.05, "nan": 0.05, "inf": 0.05}

#: The Weyl multiplier of the corrupted-index sequence.
_WEYL = 2654435761


class FaultError(RuntimeError):
    """Base class of every injected failure (never raised by a real
    fault, so catching it cannot hide one)."""


class InjectedFault(FaultError):
    """A synthetic execution failure."""


class InjectedTimeout(FaultError, TimeoutError):
    """A synthetic timeout (catches as TimeoutError)."""


class InjectedOOM(FaultError, MemoryError):
    """A synthetic out-of-memory failure (catches as MemoryError)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One rule. ``at`` (0-based call indices at the site) wins over
    ``prob``; ``param`` is the kind's knob (the corrupted fraction for
    nan/inf, the cut for truncate, seconds for delay, the factor for
    skew)."""

    site: str
    kind: str
    at: tuple[int, ...] | None = None
    prob: float = 0.0
    param: float = 0.01

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {_KINDS}")
        if self.at is not None:
            object.__setattr__(self, "at", tuple(int(i) for i in self.at))

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(site=d["site"], kind=d["kind"],
                   at=tuple(d["at"]) if d.get("at") is not None else None,
                   prob=float(d.get("prob", 0.0)), param=float(d.get("param", 0.01)))


def _unit_hash(*parts) -> float:
    """A value in [0, 1) from ``parts``, stable across processes."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultPlan:
    """A replayable set of rules with per-site call counters."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        #: ``(site, kind, call)`` of every firing, in order.
        self.events: list[tuple[str, str, int]] = []
        self._counters: dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec) -> "FaultPlan":
        """From a JSON string, ``@path``, a list of dicts, a ``{"seed",
        "specs"}`` dict, or the comma shorthand (``"delay,nan"``: each kind
        at its site family with probability :data:`SHORTHAND_PROB`)."""
        if isinstance(spec, str):
            if spec.startswith("@"):
                spec = json.loads(pathlib.Path(spec[1:]).read_text())
            else:
                words = [w.strip() for w in spec.split(",") if w.strip()]
                if words and all(w in _KINDS for w in words):
                    spec = [{"site": SHORTHAND_SITES[w], "kind": w, "prob": SHORTHAND_PROB,
                             "param": SHORTHAND_PARAM.get(w, 0.01)} for w in words]
                else:
                    spec = json.loads(spec)
        if isinstance(spec, dict):
            seed, entries = spec.get("seed", 0), spec.get("specs", [])
        else:
            seed, entries = 0, spec
        return cls([FaultSpec.from_dict(d) for d in entries], seed=seed)

    def fires(self, site: str) -> list[FaultSpec]:
        """Advance ``site``'s counter and return the specs that fire on
        this call; each firing lands in :attr:`events`, the log, the
        ``faults_fired`` counter and a ``fault_fired`` trace event."""
        from distributed_sddmm_tpu_torch.obs import log, metrics, trace

        with self._lock:
            n = self._counters.get(site, 0)
            self._counters[site] = n + 1
        fired = []
        for i, spec in enumerate(self.specs):
            if not fnmatch.fnmatch(site, spec.site):
                continue
            hit = (n in spec.at) if spec.at is not None else (
                _unit_hash(self.seed, i, site, n) < spec.prob)
            if hit:
                fired.append(spec)
                with self._lock:
                    self.events.append((site, spec.kind, n))
                metrics.GLOBAL.add("faults_fired")
                trace.event("fault_fired", site=site, kind=spec.kind, call=n)
                log.warn("faults", f"{spec.kind} fired", site=site, call=n)
        return fired

    def call_count(self, site: str) -> int:
        with self._lock:
            return self._counters.get(site, 0)


# ------------------------------------------------------- the active plan

_active: Optional[FaultPlan] = None
_env_checked = False
_registry_lock = threading.Lock()


def install(plan: Optional[FaultPlan]) -> None:
    """Make ``plan`` the process-wide plan (None: no plan)."""
    global _active, _env_checked
    with _registry_lock:
        _active = plan
        _env_checked = True


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    """The active plan, read from ``SDDMM_TORCH_FAULTS`` on the first
    query."""
    global _active, _env_checked
    if _env_checked:
        return _active
    with _registry_lock:
        if not _env_checked:
            env = os.environ.get(FAULTS_ENV)
            if env:
                try:
                    _active = FaultPlan.from_spec(env)
                except (ValueError, KeyError, OSError) as e:
                    from distributed_sddmm_tpu_torch.obs import log

                    log.warn("faults", f"ignoring malformed {FAULTS_ENV}", error=str(e))
            _env_checked = True
    return _active


class fault_plan:
    """Context manager: ``plan`` inside the block, the previous plan
    after."""

    def __init__(self, plan: Optional[FaultPlan]):
        self.plan = plan

    def __enter__(self) -> Optional[FaultPlan]:
        self._prev = active()
        install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        install(self._prev)


# ------------------------------------------------------------------ hooks
# One per consuming family, so each advances its site's counter once a
# call.


def maybe_raise(site: str) -> None:
    """Raise a synthetic timeout, OOM or error, or sleep through a
    ``delay``, if one fires at ``site``."""
    plan = active()
    if plan is None:
        return
    for spec in plan.fires(site):
        if spec.kind == "timeout":
            raise InjectedTimeout(f"injected timeout at {site}")
        if spec.kind == "oom":
            raise InjectedOOM(f"injected OOM at {site}")
        if spec.kind == "error":
            raise InjectedFault(f"injected fault at {site}")
        if spec.kind == "delay":
            time.sleep(max(float(spec.param), 0.0))


def maybe_kill(site: str) -> None:
    """Exit the process at once if a ``kill`` fires at ``site``."""
    plan = active()
    if plan is None:
        return
    for spec in plan.fires(site):
        if spec.kind == "kill":
            sys.stderr.flush()
            os._exit(KILL_EXIT_CODE)


def corrupt_indices(size: int, frac: float, salt: int, device=None) -> torch.Tensor:
    """The flat positions ``_corrupt_leaf`` overwrites in a ``size``-element
    array: ``n = max(1, int(size * frac))`` terms of the Weyl sequence
    ``(salt + k * 2654435761) % size``, deduplicated and sorted (int64 on
    ``device``)."""
    n = max(1, int(size * frac))
    k = torch.arange(n, dtype=torch.int64, device=device)
    return torch.unique((salt + k * _WEYL) % size)


def _corrupt_leaf(x: torch.Tensor, kind: str, frac: float, salt: int) -> torch.Tensor:
    """A copy of a floating tensor with ~``frac`` of its elements NaN or
    Inf at the deterministic positions; anything else as it is."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.numel() == 0:
        return x
    idx = corrupt_indices(x.numel(), frac, salt, x.device)
    out = x.detach().clone()
    out.view(-1).index_fill_(0, idx, float("nan") if kind == "nan" else float("inf"))
    return out


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, t) for t in tree)
    return fn(tree)


def corrupt_outputs(site: str, tree):
    """Any nan/inf firing at ``site`` applied to every floating tensor of
    ``tree`` (a tensor, or lists, tuples and dicts of them); the tree
    itself when nothing fires. The inputs are never written."""
    plan = active()
    if plan is None:
        return tree
    specs = [s for s in plan.fires(site) if s.kind in ("nan", "inf")]
    for spec in specs:
        salt = int(_unit_hash(plan.seed, site, spec.kind) * (1 << 31))
        tree = _map_leaves(lambda x: _corrupt_leaf(x, spec.kind, spec.param, salt), tree)
    return tree


def scale_value(site: str, value: float) -> float:
    """``value`` times any ``skew`` firing at ``site`` (``comm:<op>``)."""
    plan = active()
    if plan is None:
        return value
    for spec in plan.fires(site):
        if spec.kind == "skew":
            value = value * float(spec.param)
    return value


def garble_text(site: str, text: str) -> str:
    """Any garble/truncate firing at ``site`` applied to a payload about
    to be written: a torn write or a partial flush."""
    plan = active()
    if plan is None:
        return text
    for spec in plan.fires(site):
        if spec.kind == "truncate":
            text = text[:max(1, int(len(text) * min(max(spec.param, 0.0), 0.95)))]
        elif spec.kind == "garble":
            pos = len(text) // 2
            text = text[:pos] + "\x00#GARBLED#\x00" + text[pos + 1:]
    return text
