"""The Plan record and the ``get_plan`` entry point (counterpart of
``autotune/plan.py``).

Selection order, fastest knowledge first:

1. **Cache hit**: a stored plan for this exact fingerprint returns at
   once: no trial, no strategy built.
2. **Warm start**: the port's own records, when the caller names them,
   seed a candidate (checked for legality before it is trusted).
3. **Cost model**: candidates enumerated, memory-guarded and ranked by
   the analytic models.
4. **Measurement** (``mode="measure"``, or ``"auto"`` with the sparse
   matrix given): the top few candidates run short trials through the
   harness under per-trial timeouts, and the measured winner takes the
   plan. Every failure of measurement falls back to step 3's ranking.
   An explicit ``measure`` upgrades a cached model or seed plan.

The plan is stored back under the fingerprint key, so the next process
with the same problem, world, device and code takes path 1. Under a world
of processes every process follows process 0's cache read and process
0's selection (a broadcast), and only process 0 writes the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from distributed_sddmm_tpu_torch.autotune import cache as cache_mod
from distributed_sddmm_tpu_torch.autotune import candidates as cand_mod
from distributed_sddmm_tpu_torch.autotune import measure as measure_mod
from distributed_sddmm_tpu_torch.autotune.cache import PlanCache
from distributed_sddmm_tpu_torch.autotune.candidates import Candidate
from distributed_sddmm_tpu_torch.autotune.fingerprint import (
    Problem, machine_signature, make_fingerprint,
)
from distributed_sddmm_tpu_torch.obs import metrics, trace

MODES = ("auto", "model", "measure")


@dataclasses.dataclass
class Plan:
    """A selected execution configuration for one fingerprinted problem."""

    algorithm: str
    c: int
    kernel: str = "cuda-bf16"
    gather_budget: int | None = None
    #: Codegen kernel-variant id (``codegen/variants.py``); None: the
    #: generic tile kernel.
    variant: str | None = None
    #: Wire-precision comm dtype (``parallel/wire.py``); None: the f32
    #: identity wire.
    wire: str | None = None
    source: str = "model"            # model | measured | seed
    predicted_ms: float | None = None
    measured_gflops: float | None = None
    fingerprint_key: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        return cls(
            algorithm=d["algorithm"],
            c=int(d["c"]),
            kernel=d.get("kernel", "cuda-bf16"),
            gather_budget=d.get("gather_budget"),
            variant=d.get("variant"),
            wire=d.get("wire"),
            source=d.get("source", "model"),
            predicted_ms=d.get("predicted_ms"),
            measured_gflops=d.get("measured_gflops"),
            fingerprint_key=d.get("fingerprint_key", ""),
        )

    def candidate(self) -> Candidate:
        return Candidate(algorithm=self.algorithm, c=self.c, kernel=self.kernel,
                         gather_budget=self.gather_budget, variant=self.variant,
                         wire=self.wire)

    def make_kernel(self, device=None):
        return measure_mod._build_kernel(self.candidate(), device)

    def instantiate(self, S, R: int, world=None, device=None, program_store=None, **kw):
        """The planned strategy for a concrete sparse matrix, through the
        harness factory. ``R`` is explicit: a plan is selected for a
        problem and does not carry it.

        With the program store active (``programs/``; ``program_store``
        overrides it, ``SDDMM_TORCH_PROGRAMS=0`` turns it off) and a
        fingerprint on the plan, the strategy's set-up is looked up first
        under this plan's fingerprint key: a hit builds the strategy from
        the stored tile sets, a miss builds them, saves them and counts a
        ``live_compiles``. Either way the strategy is bound to the store."""
        from distributed_sddmm_tpu_torch.bench.harness import (
            ALGORITHM_CLASSES, make_algorithm,
        )
        from distributed_sddmm_tpu_torch.device import resolve_device
        from distributed_sddmm_tpu_torch.parallel.comm import world_from_env
        from distributed_sddmm_tpu_torch.programs import store as programs

        device = resolve_device(device)
        world = world_from_env(device) if world is None else world
        kernel = self.make_kernel(device)

        def build():
            return make_algorithm(self.algorithm, S, R=R, c=self.c, kernel=kernel,
                                  device=device, world=world, wire=self.wire, **kw)

        config = programs.SetupConfig(ALGORITHM_CLASSES[self.algorithm], self.c, kernel,
                                      self.wire, overlap=kw.get("overlap", False))
        return programs.build_bound(build, config, S, self.fingerprint_key, world=world,
                                    device=device, store=program_store)


def _seed_candidate(problem: Problem, p: int, backend: str, kernels: tuple,
                    winner_records=None, kernel_records=None) -> Optional[Candidate]:
    """A legality-checked candidate from the port's own records. Only a
    winner record (an algorithm and c measured on this problem shape)
    seeds; the kernel records can refine its family, never invent an
    algorithm or c."""
    seed = cache_mod.seed_winner_plan(problem, p, winner_records)
    if seed is None:
        return None
    algorithm, c = seed.get("algorithm"), seed.get("c")
    if algorithm not in cand_mod.ALGORITHM_MODELS:
        return None
    if c not in cand_mod.legal_c_values(algorithm, p, problem.R):
        return None
    kernel = cache_mod.seed_kernel_family(problem, backend, kernels, kernel_records)
    return Candidate(algorithm=algorithm, c=int(c), kernel=kernel or kernels[0])


def _ranks_sharing(world, device) -> int:
    """The ranks one device's memory holds: every rank of a ``LocalWorld``,
    every process of a world on the host; one a card otherwise."""
    import torch

    from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld

    if isinstance(world, LocalWorld) or torch.device(device).type == "cpu":
        return world.p
    return 1


def _from_process_zero(world, obj):
    """``obj`` as process 0 of the world has it (itself in one process)."""
    if world.num_processes == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def get_plan(
    problem: Problem,
    world=None,
    S=None,
    *,
    device=None,
    kernel: str | None = None,
    mode: str = "auto",
    cache: Optional[PlanCache] = None,
    machine=None,
    top_k: int = 3,
    trials: int = 2,
    warmup: int = 1,
    timeout_s: float = 120.0,
    retries: int = 1,
    backoff_s: float = 2.0,
    jitter: float = 0.25,
    max_elapsed_s: float = 900.0,
    trial_fn: Optional[Callable] = None,
    winner_records=None,
    kernel_records=None,
) -> Plan:
    """Select (or recall) the plan of a fingerprinted problem on ``world``
    (None: ``parallel/comm.world_from_env``) and ``device`` (default
    ``cuda``).

    ``mode``: ``"model"`` never measures; ``"measure"`` needs ``S`` and
    measures the top ``top_k`` candidates of the model's ranking;
    ``"auto"`` measures when ``S`` is given. ``kernel`` names the kernel
    family (the precision) a plan may use (``fingerprint.kernel_families``);
    the memory guard's budget is the device's (``candidates.memory_budget``).
    ``winner_records`` / ``kernel_records`` are the port's own harness and
    ``bench kernels`` records to seed from. ``trial_fn(S, problem,
    candidate, trials, warmup) -> record`` replaces the harness trial."""
    from distributed_sddmm_tpu_torch.device import resolve_device
    from distributed_sddmm_tpu_torch.parallel.comm import world_from_env

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if mode == "measure" and S is None:
        raise ValueError("mode='measure' needs the sparse matrix S")
    device = resolve_device(device)
    world = world_from_env(device) if world is None else world
    p, backend, kernels = machine_signature(world, device, kernel)
    fp = make_fingerprint(problem, p, backend, kernels)
    cache = cache if cache is not None else PlanCache()
    lead = world.process_index == 0

    hit = _from_process_zero(world, cache.load(fp.key) if lead else None)
    # An explicit measure request upgrades a cached model or seed guess;
    # a measured plan always serves.
    if hit is not None and not (mode == "measure" and hit.get("source") != "measured"):
        metrics.GLOBAL.add("plan_cache_hits")
        trace.event("plan_cache_hit", key=fp.key, algorithm=hit.get("algorithm"),
                    c=hit.get("c"), source=hit.get("source"))
        return Plan.from_dict(hit)
    metrics.GLOBAL.add("plan_cache_misses")

    budget_bytes = cand_mod.memory_budget(device, _ranks_sharing(world, device))
    cands = cand_mod.enumerate_candidates(problem, p, kernels, budget_bytes)
    if not cands:
        raise ValueError(f"no constructible algorithm configuration for {problem} on "
                         f"p={p} (check the R divisibility and the memory budget)")
    ranked = cand_mod.rank_candidates(problem, cands, p, machine)

    seed = _seed_candidate(problem, p, backend, kernels, winner_records, kernel_records)
    if seed is not None:
        seed = cand_mod.hbm_guard(problem, seed, p, budget_bytes)
    seeded_first = ranked
    if seed is not None:
        seeded_first = [cs for cs in ranked if cs[0] == seed]
        seeded_first += [cs for cs in ranked if cs[0] != seed]
        if seeded_first[0][0] != seed:
            seeded_first = [(seed, cand_mod.model_cost(problem, seed, p, machine))] + ranked

    measured: list = []
    if mode == "measure" or (mode == "auto" and S is not None):
        measured = measure_mod.measure_candidates(
            S, problem, [cand for cand, _ in seeded_first[:top_k]],
            trials=trials, warmup=warmup, timeout_s=timeout_s, retries=retries,
            backoff_s=backoff_s, jitter=jitter, max_elapsed_s=max_elapsed_s,
            trial_fn=trial_fn, device=device, world=world,
        )

    if measured:
        best, rec = measured[0]
        plan = Plan(algorithm=best.algorithm, c=best.c, kernel=best.kernel,
                    gather_budget=best.gather_budget, variant=best.variant,
                    wire=best.wire, source="measured",
                    predicted_ms=cand_mod.model_cost(problem, best, p, machine) * 1e3,
                    measured_gflops=rec.get("overall_throughput"),
                    fingerprint_key=fp.key)
    else:
        best, cost = seeded_first[0]
        plan = Plan(algorithm=best.algorithm, c=best.c, kernel=best.kernel,
                    gather_budget=best.gather_budget, variant=best.variant,
                    wire=best.wire,
                    source="seed" if seed is not None and best == seed else "model",
                    predicted_ms=cost * 1e3, fingerprint_key=fp.key)
    plan = Plan.from_dict(_from_process_zero(world, plan.to_dict()))
    trace.event("plan_selected", key=fp.key, algorithm=plan.algorithm, c=plan.c,
                kernel=plan.kernel, source=plan.source, measured=len(measured))
    if lead:
        cache.store(fp.key, plan.to_dict())
    return plan
