"""Online serving layer: request queue, micro-batching, warm engines
(counterpart of ``serve/``).

* :mod:`.queue` -- bounded admission, dynamic micro-batching and
  backpressure (:class:`ShedError`), weighted-fair tenant classes;
* :mod:`.engine` -- warm-model execution over a bucketed program ladder
  with the resilience ladder around every dispatch (retry, then the host
  rung on the CPU or an error reply on the card);
* :mod:`.workloads` -- the paper's apps as endpoints: ALS user fold-in and
  top-k, attention token scoring, GAT node scoring, each on the
  hand-written kernels of ``ops/serve_kernels.py``;
* :mod:`.slo` -- SLO specs (``SDDMM_TORCH_SLO``), latency and occupancy
  recording, and the open-loop Poisson load generator behind ``bench
  serve``.

:func:`build_als_engine`, :func:`build_gat_engine` and
:func:`build_attention_engine` are the path from a matrix to serving: plan
the strategy (``autotune``; the set-up through the program store by
``Plan.instantiate``), warm the model, wrap it in an engine. They run on
``cuda`` unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from distributed_sddmm_tpu_torch.serve.engine import ServingEngine
from distributed_sddmm_tpu_torch.serve.queue import (
    DEFAULT_TENANT, Request, RequestError, RequestQueue, ShedError, TenantSpec,
)
from distributed_sddmm_tpu_torch.serve.slo import (
    LatencyRecorder, SLOSpec, parse_tenants, percentile, run_load, tenants_from_env,
)
from distributed_sddmm_tpu_torch.serve.workloads import (
    ALSFoldInTopK, AttentionTokenScore, GATNodeScore, ServingWorkload, bucket_for,
)

__all__ = [
    "ALSFoldInTopK", "AttentionTokenScore", "DEFAULT_TENANT", "GATNodeScore",
    "LatencyRecorder", "Request", "RequestError", "RequestQueue",
    "ServingEngine", "ServingWorkload", "ShedError", "SLOSpec", "TenantSpec",
    "bucket_for", "build_als_engine", "build_attention_engine",
    "build_gat_engine", "parse_tenants", "percentile", "run_load",
    "tenants_from_env",
]


def build_als_engine(S, R: int = 16, train_steps: int = 2, cg_iters: int = 5, k: int = 10,
                     plan_mode: str = "model", world=None, device=None, item_buckets=None,
                     **engine_kw) -> ServingEngine:
    """Plan, train and wrap a warm ALS fold-in endpoint. ``train_steps``
    alternating steps warm the factors (a deployment would restore a
    checkpoint instead: pass ``train_steps=0`` and load factors onto the
    model)."""
    from distributed_sddmm_tpu_torch.models.als import DistributedALS

    model = DistributedALS.from_plan(S, R, world=world, device=device, plan_mode=plan_mode)
    if train_steps:
        model.run_cg(train_steps, cg_iters=cg_iters)
    elif model.A is None:
        model.initialize_embeddings()
    kw = {"k": k}
    if item_buckets is not None:
        kw["item_buckets"] = tuple(item_buckets)
    return ServingEngine(ALSFoldInTopK(model, **kw), **engine_kw)


def build_attention_engine(S, R: int = 16, window: int | None = None,
                           plan_mode: str = "model", world=None, device=None,
                           token_buckets=None, seed: int = 0, **engine_kw) -> ServingEngine:
    """Plan, run and wrap a token-scoring attention endpoint.

    ``S`` is the block-sparse attention mask (``masks``). One fused SDDMM →
    masked softmax → SpMM call over seeded context embeddings runs here
    through the planned strategy; its output rows are the cached context
    the per-request window scorer serves from. A plan whose layout cannot
    carry the softmax denominator (sparse shift, Cannon) keeps its kernel
    and is pinned to ``15d_fusion2`` at c = 1, and the plan is restamped
    with what runs: ``algorithm`` and ``c`` are run-store axes."""
    import dataclasses

    import numpy as np

    from distributed_sddmm_tpu_torch.autotune import Problem, get_plan
    from distributed_sddmm_tpu_torch.bench.harness import ATTENTION_CAPABLE, make_algorithm
    from distributed_sddmm_tpu_torch.device import resolve_device
    from distributed_sddmm_tpu_torch.parallel.comm import world_from_env

    device = resolve_device(device)
    world = world_from_env(device) if world is None else world
    plan = get_plan(Problem.from_coo(S, R), world, S=S if plan_mode != "model" else None,
                    device=device, mode=plan_mode)
    if plan.algorithm in ATTENTION_CAPABLE:
        alg = plan.instantiate(S, R=R, world=world, device=device, attention=True)
    else:
        alg = make_algorithm("15d_fusion2", S, R, c=1, kernel=plan.make_kernel(device),
                             device=device, attention=True, world=world)
        plan = dataclasses.replace(plan, algorithm="15d_fusion2", c=1,
                                   source=f"{plan.source}-pinned")
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((max(S.M, S.N), R)) / np.sqrt(R)).astype(np.float32)
    out, _ = alg.fused_attention(alg.put_a(X[: alg.M]), alg.put_b(X[: alg.N]),
                                 alg.like_s_values(1.0))
    context = alg.host_a(out)
    kw = {"window": window}
    if token_buckets is not None:
        kw["token_buckets"] = tuple(token_buckets)
    workload = AttentionTokenScore(context, d_ops=alg, **kw)
    # The serve CLI reads engine.workload.model.d_ops / .plan for its
    # record; this workload carries the strategy itself.
    workload.model = workload
    workload.plan = plan
    return ServingEngine(workload, **engine_kw)


def build_gat_engine(S, R: int = 16, num_layers: int = 2, plan_mode: str = "model",
                     world=None, device=None, node_buckets=None,
                     **engine_kw) -> ServingEngine:
    """Plan, build and wrap a warm GAT node-scoring endpoint (the forward
    pass runs once at workload construction; ``refresh()`` it after a
    weight update)."""
    from distributed_sddmm_tpu_torch.bench.harness import _gat_layers
    from distributed_sddmm_tpu_torch.models.gat import GAT

    model = GAT.from_plan(S, _gat_layers(R, num_layers), world=world, device=device,
                          plan_mode=plan_mode)
    kw = {}
    if node_buckets is not None:
        kw["node_buckets"] = tuple(node_buckets)
    return ServingEngine(GATNodeScore(model, **kw), **engine_kw)
