"""Autotune: problem-fingerprinted plan selection (counterpart of
``autotune/``).

The paper's central artifact is a winner map: which of the five algorithm
configurations (1.5D dense and sparse shift with their fusions, 2.5D
Cannon dense- and sparse-replicating) wins at a given (M, nnz/row, R, p,
c). This package turns that map, analytic (``tools/costmodel.py``) or
measured on demand, into a plan at run time.

* :mod:`.fingerprint` -- the canonical problem and machine signature and
  its stable cache key;
* :mod:`.candidates`  -- legal candidates, the memory guard and the
  cost-model ranking;
* :mod:`.measure`     -- short measured trials under timeouts, retries
  and backoff; a failure degrades to the model's ranking;
* :mod:`.cache`       -- the versioned, atomically written JSON plan cache
  under ``artifacts/plan_cache_torch/`` and warm-start seeding from the
  port's own records;
* :mod:`.plan`        -- the :class:`Plan` record and :func:`get_plan`.

Entry points::

    from distributed_sddmm_tpu_torch.autotune import Problem, get_plan
    plan = get_plan(Problem.from_coo(S, R))  # model-ranked, cached
    alg = plan.instantiate(S, R=R)           # a DistributedSparse

or the algorithm name ``auto`` of the benchmark CLI (``--plan-mode``).
Selection is traced as in the JAX package: an ``autotune:trial`` span an
attempt, and the events ``autotune_candidate_dropped``, ``plan_cache_hit``
and ``plan_selected``.
"""

from distributed_sddmm_tpu_torch.autotune.cache import SCHEMA_VERSION, PlanCache
from distributed_sddmm_tpu_torch.autotune.candidates import Candidate, enumerate_candidates
from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem, make_fingerprint
from distributed_sddmm_tpu_torch.autotune.plan import Plan, get_plan

__all__ = [
    "Candidate",
    "Plan",
    "PlanCache",
    "Problem",
    "SCHEMA_VERSION",
    "enumerate_candidates",
    "get_plan",
    "make_fingerprint",
]
