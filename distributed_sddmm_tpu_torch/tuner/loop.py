"""The background tuner: scan, re-measure, shadow, hot-swap (counterpart
of ``tuner/loop.py``).

One :class:`BackgroundTuner` watches one serving engine. Its daemon
thread paces a small state machine (:meth:`BackgroundTuner.step`, which
the tests call directly):

* ``scan`` -- mine trigger signals (``tuner/signals.py``). None: sleep
  again, the steady state, a few dict reads. Signals: re-measure
  (``tuner/retune.py``) under the tuner's budget; a challenger that beats
  the measured incumbent starts a shadow session (``tuner/shadow.py``)
  and arms the engine's mirror.
* ``shadow`` -- replay the mirrored requests through the challenger's
  cells. A mismatch: a flight record, the challenger rejected, a
  cooldown. Enough equal replies: **promote** -- ``ServingEngine.
  swap_ladder`` swaps the challenger's cells in (a dispatch in flight
  finishes on its cell; no request dropped, no cell built on the request
  path), the plan cache takes the challenger under the fingerprint key
  (the next replica warms onto it), and the promotion is recorded with
  its ``time_to_adapt_s`` (detection to promotion).
* ``exhausted`` -- the measurement budget is spent; the tuner retires.

Everything the tuner runs on the device -- trials, the shadow's cells --
runs on the tuner's thread (a trial on the thread ``measure_candidates``
starts for it) and on the tuner's own CUDA stream, inside the engine's
device: never on the runner's stream.

Knobs: :class:`TunerConfig`, each with its ``SDDMM_TORCH_TUNER_*``
variable (``INTERVAL``, ``LANE_FRAC``, ``SHADOW_N``, ``BUDGET``,
``COOLDOWN``, ``GAP``, ``TRIAL``); ``SDDMM_TORCH_TUNER`` turns the tuner
on under ``bench serve``. Only the variant is hot-swapped: another
algorithm or c lands in the plan cache for the next warm-up (``bench
tune`` explores that space).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Optional

import distributed_sddmm_tpu_torch.tuner.retune as retune_mod
import distributed_sddmm_tpu_torch.tuner.signals as signals_mod
from distributed_sddmm_tpu_torch.obs import clock
from distributed_sddmm_tpu_torch.obs import log as obs_log
from distributed_sddmm_tpu_torch.obs import metrics as obs_metrics
from distributed_sddmm_tpu_torch.obs import trace as obs_trace
from distributed_sddmm_tpu_torch.tuner.shadow import (
    ShadowSession, StaleChallenger, on_stream, tuner_stream,
)

TUNER_ENV = "SDDMM_TORCH_TUNER"
#: Fused pairs a ``wall`` trial times (the fastest counts), after one
#: warm-up pair.
TRIAL_PAIRS = 10


@dataclasses.dataclass(frozen=True)
class TunerConfig:
    """The tuner's knobs. ``lane_frac`` keeps the JAX package's name and
    is the ``walk_idle_frac`` trigger threshold: 1.0 (a wave idles as long
    as the nonzeros work) fires on Graph500 R-mat 2^16 (44.9) and not on a
    uniform R-mat 2^16 (0.105)."""

    interval_s: float = 2.0
    lane_frac: float = 1.0
    shadow_samples: int = 4
    budget_s: float = 300.0
    cooldown_s: float = 30.0
    gap_factor: float = 0.5
    trial: str = "auto"       # auto | counted | wall
    trial_timeout_s: float = 60.0
    top_k: int = 3
    margin: float = 0.05
    #: A shadow that cannot gather its samples (traffic stopped) is given
    #: up after this long, so the tuner goes back to scanning.
    shadow_timeout_s: float = 120.0

    @classmethod
    def from_env(cls, **overrides) -> "TunerConfig":
        kw = dict(
            interval_s=float(os.environ.get("SDDMM_TORCH_TUNER_INTERVAL", cls.interval_s)),
            lane_frac=float(os.environ.get("SDDMM_TORCH_TUNER_LANE_FRAC", cls.lane_frac)),
            shadow_samples=int(float(os.environ.get("SDDMM_TORCH_TUNER_SHADOW_N",
                                                    cls.shadow_samples))),
            budget_s=float(os.environ.get("SDDMM_TORCH_TUNER_BUDGET", cls.budget_s)),
            cooldown_s=float(os.environ.get("SDDMM_TORCH_TUNER_COOLDOWN", cls.cooldown_s)),
            gap_factor=float(os.environ.get("SDDMM_TORCH_TUNER_GAP", cls.gap_factor)),
            trial=os.environ.get("SDDMM_TORCH_TUNER_TRIAL", cls.trial),
        )
        kw.update(overrides)
        return cls(**kw)

    def trial_fn(self, device=None, world=None) -> Callable:
        """The trial this config selects (``tuner.retune.select_trial_fn``)."""
        return retune_mod.select_trial_fn(self.trial, device=device, world=world)


def factory_name(d_ops) -> Optional[str]:
    """The harness factory name (``ALGORITHM_FACTORIES``) of a live
    strategy, the name plans speak; None for a class it does not know
    (the tuner then stands down)."""
    cls = type(d_ops).__name__
    if cls == "DenseShift15D":
        return "15d_fusion1" if getattr(d_ops, "fusion_approach", 2) == 1 else "15d_fusion2"
    return {"SparseShift15D": "15d_sparse", "CannonDense25D": "25d_dense_replicate",
            "CannonSparse25D": "25d_sparse_replicate"}.get(cls)


class BackgroundTuner:
    """Closed-loop re-tuning of one live serving engine."""

    def __init__(self, engine, config: Optional[TunerConfig] = None, plan_cache=None,
                 run_store=None, trial_fn: Optional[Callable] = None):
        self.engine = engine
        self.config = config or TunerConfig.from_env()
        self._plan_cache = plan_cache
        if run_store is None:
            from distributed_sddmm_tpu_torch.obs import store as obs_store

            run_store = obs_store.active()
        self.run_store = run_store
        self._trial_fn = trial_fn
        #: The tuner's own CUDA stream (None on the CPU).
        self.stream = tuner_stream(engine.device)
        self.state = "scan"
        self.shadow: Optional[ShadowSession] = None
        self.challenger = None
        self.scans = 0
        self.last_signals: list[dict] = []
        #: The last re-measure's trials: candidate and GFLOP/s, fastest first.
        self.last_trials: list[dict] = []
        self.promotions: list[dict] = []
        self.rejects: list[dict] = []
        self.measure_spent_s = 0.0
        self.t_detect: Optional[float] = None
        self._wd_cursor = 0
        self._cool_until = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The engine's snapshot reads the tuner's state through this.
        engine.tuner = self

    # ------------------------------------------------------------- reading

    @property
    def problem(self):
        return signals_mod.engine_problem(self.engine)

    def _d_ops(self):
        return getattr(getattr(self.engine.workload, "model", None), "d_ops", None)

    def incumbent_plan(self):
        """The warm model's plan, or one describing what runs (a model
        built without ``from_plan`` has none)."""
        model = getattr(self.engine.workload, "model", None)
        plan = getattr(model, "plan", None)
        if plan is not None:
            return plan
        d_ops = self._d_ops()
        if d_ops is None or factory_name(d_ops) is None:
            return None
        from distributed_sddmm_tpu_torch.autotune.plan import Plan
        from distributed_sddmm_tpu_torch.parallel.base import realized_kernel_variant

        return Plan(algorithm=factory_name(d_ops), c=d_ops.c,
                    kernel=signals_mod.kernel_family(d_ops.kernel),
                    variant=realized_kernel_variant(d_ops),
                    wire=None if d_ops.wire.label == "f32" else d_ops.wire.label,
                    source="live")

    def plan_cache(self):
        if self._plan_cache is None:
            from distributed_sddmm_tpu_torch.autotune.cache import PlanCache

            self._plan_cache = PlanCache()
        return self._plan_cache

    def _trial(self) -> Callable:
        """The trial function, entered on the engine's device and the
        tuner's stream in whichever thread runs it."""
        d_ops = self._d_ops()
        fn = self._trial_fn or self.config.trial_fn(self.engine.device, d_ops.world)
        device, stream = self.engine.device, self.stream

        def on_tuner_stream(*args, **kw):
            with on_stream(device, stream):
                return fn(*args, **kw)

        return on_tuner_stream

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "BackgroundTuner":
        if self._thread is not None:
            raise RuntimeError("tuner already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="tuner")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None
        self._detach_shadow()

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 -- the loop survives
                obs_log.error("tuner", "tuner step failed", error=f"{type(e).__name__}: {e}")

    # ------------------------------------------------------ the state machine

    def step(self) -> str:
        """Advance one poll; returns the state after it."""
        if self.state == "scan":
            self._step_scan()
        elif self.state == "shadow":
            self._step_shadow()
        return self.state

    def _step_scan(self) -> None:
        if clock.now() < self._cool_until:
            return
        problem, incumbent = self.problem, self.incumbent_plan()
        if problem is None or incumbent is None:
            return
        from distributed_sddmm_tpu_torch.obs import watchdog as obs_watchdog

        with obs_trace.span("tuner:scan"):
            obs_metrics.GLOBAL.add("tuner_scans")
            self.scans += 1
            sigs = signals_mod.mine_engine(self.engine, idle_threshold=self.config.lane_frac)
            sigs += signals_mod.mine_watchdog(since=self._wd_cursor)
            wd = obs_watchdog.active()
            if wd is not None:
                self._wd_cursor = len(wd.events)
            sigs += signals_mod.mine_runstore(self.run_store, incumbent.fingerprint_key, problem,
                                              incumbent.predicted_ms,
                                              gap_factor=self.config.gap_factor)
        if not sigs:
            return
        obs_metrics.GLOBAL.add("tuner_signals", len(sigs))
        self.last_signals = [s.to_dict() for s in sigs]
        if self.t_detect is None:
            self.t_detect = clock.now()
        obs_trace.event("tuner_signals", count=len(sigs), kinds=sorted({s.kind for s in sigs}))
        if self.measure_spent_s >= self.config.budget_s:
            # Terminal: the signals are structural and would fire again at
            # every cooldown.
            self._reject("measure_budget_exhausted")
            self.state = "exhausted"
            obs_log.warn("tuner", "measurement budget exhausted; tuner retiring",
                         spent_s=round(self.measure_spent_s, 1), budget_s=self.config.budget_s)
            return
        d_ops = self._d_ops()
        measured: list = []
        t0 = clock.now()
        with obs_trace.span("tuner:measure", signals=len(sigs)):
            obs_metrics.GLOBAL.add("tuner_retunes")
            challenger = retune_mod.retune(
                problem, incumbent, self.engine.workload.model.S_host,
                realized=signals_mod.realized_info(self.engine), top_k=self.config.top_k,
                trials=TRIAL_PAIRS,
                timeout_s=self.config.trial_timeout_s,
                max_elapsed_s=max(self.config.budget_s - self.measure_spent_s, 1.0),
                margin=self.config.margin, hot_swappable=True, trial_fn=self._trial(),
                world=d_ops.world, device=self.engine.device, measured_out=measured)
        self.measure_spent_s += clock.now() - t0
        self.last_trials = [{"algorithm": c.algorithm, "kernel": c.kernel, "variant": c.variant,
                             "gflops": rec.get("overall_throughput"),
                             "pairs_ms": rec.get("pairs_ms")} for c, rec in measured]
        if challenger is None:
            self._reject("no_better_candidate", cooldown=True)
            return
        try:
            shadow = ShadowSession(self.engine, challenger.variant, stream=self.stream)
            with obs_trace.span("tuner:shadow_arm", variant=challenger.variant or "generic"):
                shadow.warm()
        except StaleChallenger as e:
            self._reject("stale_challenger", cooldown=True, error=str(e))
            return
        except Exception as e:  # noqa: BLE001 -- a cell that fails to build is counted
            self._reject("shadow_build_failed", cooldown=True,
                         error=f"{type(e).__name__}: {e}")
            return
        self.challenger, self.shadow = challenger, shadow
        self.engine.attach_mirror(shadow.offer)
        self.state = "shadow"
        obs_log.info("tuner", "shadowing challenger", variant=challenger.variant,
                     kernel=challenger.kernel, measured_gflops=challenger.measured_gflops)

    def _step_shadow(self) -> None:
        shadow = self.shadow
        if shadow is None:  # detached from outside
            self.state = "scan"
            return
        shadow.drain()
        if shadow.mismatches:
            self._reject("shadow_mismatch", cooldown=True, detail=shadow.mismatch_detail)
        elif shadow.clean(self.config.shadow_samples):
            self._promote()
        elif clock.now() - shadow.t_start > self.config.shadow_timeout_s:
            self._reject("shadow_timeout", cooldown=True, ok=shadow.ok,
                         needed=self.config.shadow_samples)

    # ------------------------------------------------------------- verdicts

    def _detach_shadow(self) -> None:
        if self.shadow is not None:
            self.engine.detach_mirror()
            self.shadow = None

    def _cooldown(self) -> None:
        self._cool_until = clock.now() + self.config.cooldown_s
        self.t_detect = None

    def _reject(self, reason: str, cooldown: bool = False, **detail) -> None:
        self.rejects.append({"reason": reason, **detail})
        del self.rejects[:-32]  # bounded: it rides every record
        obs_metrics.GLOBAL.add("tuner_rejects")
        obs_trace.event("tuner_reject", reason=reason)
        self._detach_shadow()
        self.challenger = None
        self.state = "scan"
        if cooldown:
            self._cooldown()

    def _promote(self) -> None:
        """The hot swap: the shadow's cells into the ladder, the
        challenger into the plan cache and onto the model, the promotion
        and its time to adapt into the record."""
        shadow, challenger = self.shadow, self.challenger
        tta = clock.now() - self.t_detect if self.t_detect is not None else None
        with obs_trace.span("tuner:promote", variant=challenger.variant or "generic"):
            self.engine.swap_ladder(shadow.programs, challenger.variant)
            if challenger.fingerprint_key:
                try:
                    self.plan_cache().store(challenger.fingerprint_key, challenger.to_dict())
                except Exception as e:  # noqa: BLE001 -- the cache is advisory
                    obs_log.warn("tuner", "plan-cache store failed", error=str(e))
            model = getattr(self.engine.workload, "model", None)
            if model is not None:
                # The next scan's incumbent: without it the loop would
                # re-tune the same gap forever.
                model.plan = challenger
        promo = {"t_promote_epoch": clock.epoch(),
                 "time_to_adapt_s": round(tta, 6) if tta is not None else None,
                 "plan": challenger.to_dict(), "shadow": shadow.stats(),
                 "signals": self.last_signals}
        self.promotions.append(promo)
        obs_metrics.GLOBAL.add("tuner_promotions")
        obs_trace.event("tuner_promoted", variant=challenger.variant,
                        time_to_adapt_s=promo["time_to_adapt_s"], shadow_ok=shadow.ok)
        obs_log.info("tuner", "challenger promoted", variant=challenger.variant,
                     time_to_adapt_s=promo["time_to_adapt_s"])
        self._detach_shadow()
        self.challenger = None
        self.state = "scan"
        self._cooldown()

    # ------------------------------------------------------------ reporting

    @property
    def time_to_adapt_s(self) -> Optional[float]:
        """Detection to the first promotion (None until one lands)."""
        for p in self.promotions:
            if p.get("time_to_adapt_s") is not None:
                return p["time_to_adapt_s"]
        return None

    def summary(self) -> dict:
        """The serve record's ``tuner`` field."""
        out = {"enabled": True, "state": self.state, "scans": self.scans,
               "signals": self.last_signals, "promotions": self.promotions,
               "rejects": self.rejects, "trials": self.last_trials,
               "measure_spent_s": round(self.measure_spent_s, 3),
               "time_to_adapt_s": self.time_to_adapt_s}
        if self.shadow is not None:
            out["shadow"] = self.shadow.stats()
        return out

    def snapshot(self) -> dict:
        """The compact live view (the telemetry snapshot's ``tuner``)."""
        return {"state": self.state, "scans": self.scans, "promotions": len(self.promotions),
                "rejects": len(self.rejects), "time_to_adapt_s": self.time_to_adapt_s}
