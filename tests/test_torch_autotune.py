"""The port's autotuner (``autotune/``), its retry layer
(``resilience/retry.py``), the ``auto`` algorithm of the CLI and
``from_plan``, against the JAX package's where the two agree by design
(``tests/test_autotune_select.py``, ``tests/test_resilience_retry.py``).

Candidates: the same legal c values and the same (algorithm, c, wire) set
as the JAX package's for p in 1..16; the CUDA family adds banked variants
(none on the replicated 2.5D tiles) and the plain ``torch`` family is a
family on the CPU only. Fingerprints: stable across processes, changed by
a ``.cu`` byte, the device kind and the world kind. The cache: atomic
writes, corrupt files and schema misses read as misses. Measurement: the
JAX suite's timeout, retry, backoff and fallback cases through an injected
``trial_fn``, and the card's stop-on-timeout rule.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_sddmm_tpu.autotune import candidates as jax_cands
from distributed_sddmm_tpu.autotune.fingerprint import Problem as JaxProblem

from distributed_sddmm_tpu_torch.autotune import Plan, PlanCache, Problem, get_plan
from distributed_sddmm_tpu_torch.autotune import cache as cache_mod
from distributed_sddmm_tpu_torch.autotune import candidates as cands
from distributed_sddmm_tpu_torch.autotune import fingerprint as fp
from distributed_sddmm_tpu_torch.autotune.measure import MeasureTimeout, measure_candidates
from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.bench.harness import ALGORITHM_FACTORIES, make_algorithm
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.models.gat import GAT, GATLayer
from distributed_sddmm_tpu_torch.obs import metrics
from distributed_sddmm_tpu_torch.parallel.comm import DistWorld, LocalWorld
from distributed_sddmm_tpu_torch.resilience import (
    Backoff, CallTimeout, call_with_timeout, retry_call,
)
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.verify import fingerprint_algorithm, oracle_fingerprints

# Benchmarks here write no run document into the checkout's default store.
os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = Problem(M=256, N=256, nnz=2048, R=32)


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SDDMM_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    return PlanCache(tmp_path / "plans")


# ------------------------------------------------------------ candidates


def test_legal_c_values_equal_jax():
    for p in range(1, 17):
        for R in (2, 4, 8, 12, 16, 32, 48, 64, 128):
            for alg in cands.ALGORITHM_MODELS:
                assert cands.legal_c_values(alg, p, R) == jax_cands.legal_c_values(alg, p, R)
    assert cands.ALGORITHM_MODELS == jax_cands.ALGORITHM_MODELS


@pytest.mark.parametrize("R", [16, 32])
def test_candidate_set_equals_jax(R):
    """The (algorithm, c, wire) set for p in 1..16 is the JAX package's;
    the CUDA family's banked variants land on the same triples, never on
    the replicated 2.5D tiles; float64 problems get no bf16 twin."""
    for p in range(1, 17):
        prob = Problem(M=256, N=256, nnz=256 * 48, R=R)
        got = cands.enumerate_candidates(prob, p, ("cuda-f32",))
        want = jax_cands.enumerate_candidates(JaxProblem(M=256, N=256, nnz=256 * 48, R=R), p)
        assert {(x.algorithm, x.c, x.wire) for x in got} == \
            {(x.algorithm, x.c, x.wire) for x in want}, p
        banked = [x for x in got if x.variant]
        assert banked and all(x.algorithm != "25d_sparse_replicate" for x in banked)
        assert all(x.kernel == "cuda-f32" and x.gather_budget is None for x in got)
    f64 = cands.enumerate_candidates(Problem(256, 256, 2048, 32, dtype="float64"), 8)
    assert f64 and all(x.wire is None for x in f64)


def test_kernel_families_never_offer_the_plain_kernel_on_a_card():
    assert fp.kernel_families(torch.device("cuda")) == ("cuda-bf16",)
    assert fp.kernel_families(torch.device("cuda"), "cuda-f32") == ("cuda-f32",)
    with pytest.raises(ValueError, match="not a plan family on a card"):
        fp.kernel_families(torch.device("cuda"), "torch")
    assert fp.kernel_families(torch.device("cpu")) == ("cuda-f32", "torch")
    assert fp.kernel_families(torch.device("cpu"), "torch") == ("torch",)


def test_memory_guard_routes_the_plain_kernel_and_only_prunes_cuda():
    """The heavy corner (log_m 16, 128 a row, R 512, one rank) on a 12 GiB
    budget: the plain kernel gets a segment budget, the CUDA walk stays as
    it is; resident state past the budget prunes both."""
    M = 1 << 16
    heavy = Problem(M=M, N=M, nnz=M * 128, R=512)
    budget = 12 * (1 << 30)
    routed = cands.hbm_guard(heavy, cands.Candidate("15d_fusion2", 1, kernel="torch"), 1, budget)
    assert routed.gather_budget is not None and routed.gather_budget * 4 < budget
    cuda = cands.Candidate("15d_fusion2", 1, kernel="cuda-bf16")
    assert cands.hbm_guard(heavy, cuda, 1, budget) == cuda
    assert cands.hbm_guard(heavy, cuda, 1, 1 << 20) is None
    small = cands.Candidate("15d_fusion2", 1, kernel="torch")
    assert cands.hbm_guard(SMALL, small, 1, budget) == small
    for x in cands.enumerate_candidates(heavy, 1, ("cuda-f32", "torch"), budget):
        assert x.kernel != "torch" or x.gather_budget is not None


def test_local_world_ranks_share_one_devices_memory():
    from distributed_sddmm_tpu_torch.autotune.plan import _ranks_sharing

    total = cands.memory_budget("cpu", 1)
    assert 0 < total < os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert cands.memory_budget("cpu", 16) == int(total / 16) or \
        abs(cands.memory_budget("cpu", 16) - total / 16) <= 1
    assert _ranks_sharing(LocalWorld(16), torch.device("cpu")) == 16


def test_rank_prefers_the_single_pass_fusion():
    prob = Problem(M=4096, N=4096, nnz=4096 * 32, R=128)
    ranked = cands.rank_candidates(prob, [cands.Candidate("15d_fusion1", 1),
                                          cands.Candidate("15d_fusion2", 1)], p=8)
    assert ranked[0][0].algorithm == "15d_fusion2"
    bf16 = cands.Candidate("15d_fusion2", 1, wire="bf16")
    assert cands.model_cost(prob, bf16, 8) < cands.model_cost(prob, ranked[0][0], 8)


# ------------------------------------------------------------ fingerprint


def _key_in_subprocess() -> str:
    code = ("from distributed_sddmm_tpu_torch.autotune.fingerprint import *\n"
            "print(make_fingerprint(Problem(4096, 4096, 131072, 128, row_max=77), 4, "
            "'cuda:NVIDIA H100 80GB HBM3:local', ('cuda-bf16',)).key)")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_fingerprint_key_is_stable_and_sees_device_world_and_sources(tmp_path):
    prob = Problem(4096, 4096, 131072, 128, row_max=77)
    key = fp.make_fingerprint(prob, 4, "cuda:NVIDIA H100 80GB HBM3:local", ("cuda-bf16",)).key
    assert _key_in_subprocess() == _key_in_subprocess() == key
    for backend in ("cuda:NVIDIA H100 80GB HBM3:nccl", "cuda:NVIDIA A100-SXM4-80GB:local",
                    "cpu:local"):
        assert fp.make_fingerprint(prob, 4, backend, ("cuda-bf16",)).key != key
    assert fp.make_fingerprint(prob, 4, "cuda:NVIDIA H100 80GB HBM3:local",
                               ("cuda-f32",)).key != key
    skew = Problem(4096, 4096, 131072, 128, row_max=4000)
    assert fp.make_fingerprint(skew, 4, "cuda:NVIDIA H100 80GB HBM3:local",
                               ("cuda-bf16",)).key != key
    # A .cu byte changes the code hash.
    pkg = os.path.join(ROOT, "distributed_sddmm_tpu_torch")
    tree = tmp_path / "pkg"
    for sub in ("ops", "ops/csrc", "parallel", "codegen"):
        (tree / sub).mkdir(parents=True)
        for name in os.listdir(os.path.join(pkg, sub)):
            if name.endswith((".py", ".cu", ".cuh")):
                (tree / sub / name).write_bytes(open(os.path.join(pkg, sub, name), "rb").read())
    before = fp.code_hash(tree)
    assert before == fp.code_hash()
    cu = tree / "ops/csrc/tile_kernels.cu"
    cu.write_bytes(cu.read_bytes() + b" ")
    assert fp.code_hash(tree) != before


def test_machine_signature_names_device_and_world_kind(tmp_path):
    p, backend, kernels = fp.machine_signature(LocalWorld(4), "cpu")
    assert (p, backend, kernels) == (4, "cpu:local", ("cuda-f32", "torch"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        assert fp.machine_signature(DistWorld(), "cpu", "torch") == (1, "cpu:gloo", ("torch",))
    finally:
        dist.destroy_process_group()


def test_problem_from_coo_reads_the_heaviest_row():
    S = HostCOO(np.array([0, 0, 0, 2]), np.array([0, 1, 2, 0]), np.ones(4), 3, 3)
    prob = Problem.from_coo(S, 8)
    assert (prob.M, prob.nnz, prob.R, prob.row_max) == (3, 4, 8, 3)


# ------------------------------------------------------------------ cache


def test_cache_is_atomic_and_reads_damage_as_a_miss(tmp_path):
    cache = PlanCache(tmp_path)
    plan = Plan("15d_fusion2", 2, kernel="cuda-f32", wire="bf16", fingerprint_key="abc")
    cache.store("abc", plan.to_dict())
    assert os.listdir(tmp_path) == ["abc.json"]  # no temporary file left
    rec = cache.load("abc")
    assert rec["schema_version"] == cache_mod.SCHEMA_VERSION
    assert Plan.from_dict(rec) == plan
    (tmp_path / "abc.json").write_text('{"algorithm": "15d_fus')
    assert cache.load("abc") is None
    cache.store("abc", plan.to_dict())
    raw = json.loads((tmp_path / "abc.json").read_text())
    (tmp_path / "abc.json").write_text(json.dumps(dict(raw, schema_version=0)))
    assert cache.load("abc") is None
    (tmp_path / "xyz.json").write_text(json.dumps(raw))  # a copied file
    assert cache.load("xyz") is None
    (tmp_path / "abc.json").write_text("[1, 2]")
    assert cache.load("abc") is None
    cache.invalidate("abc")
    cache.invalidate("abc")
    assert cache.load("abc") is None and cache.load("missing") is None


def test_cache_directory_knob(monkeypatch, tmp_path):
    monkeypatch.delenv("SDDMM_TORCH_PLAN_CACHE", raising=False)
    assert cache_mod.default_cache_dir().parts[-2:] == ("artifacts", "plan_cache_torch")
    monkeypatch.setenv("SDDMM_TORCH_PLAN_CACHE", str(tmp_path))
    assert PlanCache().root == tmp_path


def test_seeds_read_only_the_records_given(tmp_path, plan_cache):
    S = HostCOO.rmat(6, 4, seed=0)
    prob = Problem.from_coo(S, 16)
    assert cache_mod.seed_winner_plan(prob, 4, None) is None
    assert cache_mod.seed_kernel_family(prob, "cpu:local", ("cuda-f32", "torch")) is None
    winners = tmp_path / "runs.jsonl"
    base = {"app": "vanilla", "fused": True, "R": 16, "c": 2,
            "alg_info": {"m": S.M, "n": S.N, "p": 4, "nnz": S.nnz}}
    winners.write_text("\n".join(json.dumps(x) for x in (
        dict(base, algorithm="15d_fusion1", overall_throughput=3.0),
        dict(base, algorithm="15d_sparse", overall_throughput=1.0),
        dict(base, algorithm="15d_fusion2", overall_throughput=9.0, app="gat"))))
    seed = cache_mod.seed_winner_plan(prob, 4, winners)
    assert (seed["algorithm"], seed["c"], seed["source"]) == ("15d_fusion1", 2, "seed")
    assert cache_mod.seed_winner_plan(prob, 8, winners) is None
    kernels = tmp_path / "kernels.jsonl"
    krec = {"M": S.M, "N": S.N, "nnz": S.nnz, "R": 16, "device": "cpu"}
    kernels.write_text("\n".join(json.dumps(dict(krec, kernel=k, fused_pair_gflops=g))
                                 for k, g in (("cuda-f32", 1.0), ("torch", 2.0))))
    assert cache_mod.seed_kernel_family(prob, "cpu:local", ("cuda-f32", "torch"),
                                        kernels) == "torch"
    assert cache_mod.seed_kernel_family(prob, "cuda:NVIDIA H100 80GB HBM3:local",
                                        ("cuda-bf16",), kernels) is None
    plan = get_plan(prob, LocalWorld(4), device="cpu", mode="model", cache=plan_cache,
                    winner_records=winners, kernel_records=kernels)
    assert (plan.source, plan.algorithm, plan.c, plan.kernel) == ("seed", "15d_fusion1", 2,
                                                                  "torch")


# ----------------------------------------------------------- measurement


def test_measure_timeout_degrades_to_model_ranking(plan_cache):
    S = HostCOO.rmat(6, 4, seed=0)
    prob = Problem.from_coo(S, 16)
    attempts = []

    def timing_out(S_, problem, cand, trials, warmup):
        attempts.append(cand)
        raise MeasureTimeout("simulated hang")

    plan = get_plan(prob, LocalWorld(8), S=S, device="cpu", mode="measure",
                    cache=plan_cache, trial_fn=timing_out, top_k=2, retries=1,
                    backoff_s=0.0)
    assert plan.source == "model" and plan.algorithm in ALGORITHM_FACTORIES
    assert len(attempts) == 2 * 2  # each shortlisted candidate got its retry


def test_measured_winner_beats_model_ranking(plan_cache):
    S = HostCOO.rmat(6, 4, seed=0)
    prob = Problem.from_coo(S, 16)

    def rigged(S_, problem, cand, trials, warmup):
        return {"overall_throughput": 100.0 if cand.algorithm == "15d_sparse" else 1.0}

    plan = get_plan(prob, LocalWorld(8), S=S, device="cpu", mode="measure",
                    cache=plan_cache, trial_fn=rigged, top_k=200, backoff_s=0.0)
    assert (plan.source, plan.algorithm, plan.measured_gflops) == ("measured", "15d_sparse",
                                                                   100.0)
    assert plan.predicted_ms > 0


def test_measure_retry_backoff_sequence_and_refusal():
    sleeps, calls = [], {"n": 0}

    def flaky(S_, problem, cand, trials, warmup):
        calls["n"] += 1
        if calls["n"] < 3:
            raise MeasureTimeout("flaky")
        return {"overall_throughput": 5.0}

    prob = Problem(M=64, N=64, nnz=256, R=8)
    before = metrics.GLOBAL.get("autotune_trial_retries")
    out = measure_candidates(None, prob, [cands.Candidate("15d_fusion2", 1)], retries=2,
                             backoff_s=1.5, jitter=0.0, trial_fn=flaky, sleep=sleeps.append)
    assert len(out) == 1 and sleeps == [1.5, 3.0]
    assert metrics.GLOBAL.get("autotune_trial_retries") == before + 2
    refused = {"n": 0}

    def refuses(S_, problem, cand, trials, warmup):
        refused["n"] += 1
        raise ValueError("grid it cannot split")

    dropped = metrics.GLOBAL.get("autotune_candidates_dropped")
    assert measure_candidates(None, prob, [cands.Candidate("15d_fusion2", 1)], retries=3,
                              trial_fn=refuses, sleep=sleeps.append) == []
    assert refused["n"] == 1  # a deterministic refusal burns no retry
    assert metrics.GLOBAL.get("autotune_candidates_dropped") == dropped + 1


def test_measure_backoff_jitter_and_elapsed_cap():
    import itertools

    sleeps = []

    def always_out(S_, problem, cand, trials, warmup):
        raise MeasureTimeout("dead device")

    prob = Problem(M=64, N=64, nnz=256, R=8)
    measure_candidates(None, prob, [cands.Candidate("15d_fusion2", 1)], retries=3,
                       backoff_s=2.0, jitter=0.5, rng=random.Random(11),
                       trial_fn=always_out, sleep=sleeps.append)
    assert len(sleeps) == 3
    for i, s in enumerate(sleeps):
        assert 2.0 * 2 ** i < s <= 2.0 * 2 ** i * 1.5
    sleeps2, clock = [], itertools.count(0, 100)
    measure_candidates(None, prob, [cands.Candidate("15d_fusion2", 1)], retries=5,
                       backoff_s=1.0, jitter=0.0, max_elapsed_s=150.0,
                       trial_fn=always_out, sleep=sleeps2.append,
                       monotonic=lambda: float(next(clock)))
    assert len(sleeps2) < 5


def test_a_timeout_on_the_card_ends_measuring():
    """A timed-out trial's thread may still hold the card: no retry, and
    no later candidate is timed behind it; the trials before it stand."""
    tried = []

    def trial(S_, problem, cand, trials, warmup):
        tried.append(cand.c)
        if cand.c == 2:
            time.sleep(2.0)
        return {"overall_throughput": float(cand.c)}

    prob = Problem(M=64, N=64, nnz=256, R=8)
    shortlist = [cands.Candidate("15d_fusion2", c) for c in (1, 2, 4)]
    out = measure_candidates(None, prob, shortlist, timeout_s=0.5, retries=2, backoff_s=0.0,
                             trial_fn=trial, stop_on_timeout=True)
    assert tried == [1, 2] and [x.c for x, _ in out] == [1]
    tried.clear()
    out = measure_candidates(None, prob, shortlist, timeout_s=0.5, retries=0, backoff_s=0.0,
                             trial_fn=trial, stop_on_timeout=False)
    assert tried == [1, 2, 4] and [x.c for x, _ in out] == [4, 1]


def test_default_trial_measures_through_the_harness(plan_cache):
    """``mode="measure"`` without an injected trial: real short runs of each
    candidate's strategy on the CPU (the plain versions), the winner
    measured."""
    S = HostCOO.rmat(6, 4, seed=0)
    plan = get_plan(Problem.from_coo(S, 16), LocalWorld(4), S=S, device="cpu",
                    mode="measure", cache=plan_cache, top_k=2, trials=1, warmup=0)
    assert plan.source == "measured" and plan.measured_gflops > 0


# --------------------------------------------------------------- get_plan


def test_second_call_hits_the_cache_with_zero_trials(plan_cache):
    S = HostCOO.rmat(6, 4, seed=0)
    prob = Problem.from_coo(S, 16)
    trials = []

    def trial(S_, problem, cand, n, warmup):
        trials.append(cand)
        return {"overall_throughput": 1.0 + cand.c}

    hits, misses = (metrics.GLOBAL.get(k) for k in ("plan_cache_hits", "plan_cache_misses"))
    model = get_plan(prob, LocalWorld(4), device="cpu", mode="model", cache=plan_cache,
                     trial_fn=trial)
    assert model.source == "model" and trials == []
    again = get_plan(prob, LocalWorld(4), S=S, device="cpu", mode="auto", cache=plan_cache,
                     trial_fn=trial)
    assert again == model and trials == []  # a hit serves even in auto mode
    measured = get_plan(prob, LocalWorld(4), S=S, device="cpu", mode="measure",
                        cache=plan_cache, trial_fn=trial, top_k=3)
    assert measured.source == "measured" and len(trials) == 3  # measure upgrades
    n = len(trials)
    assert get_plan(prob, LocalWorld(4), S=S, device="cpu", mode="measure",
                    cache=plan_cache, trial_fn=trial) == measured and len(trials) == n
    assert metrics.GLOBAL.get("plan_cache_hits") == hits + 2
    assert metrics.GLOBAL.get("plan_cache_misses") == misses + 2
    # Another world kind or size is another key.
    assert get_plan(prob, LocalWorld(8), device="cpu", mode="model",
                    cache=plan_cache).fingerprint_key != model.fingerprint_key
    with pytest.raises(ValueError, match="mode"):
        get_plan(prob, LocalWorld(4), device="cpu", mode="guess", cache=plan_cache)
    with pytest.raises(ValueError, match="needs the sparse matrix"):
        get_plan(prob, LocalWorld(4), device="cpu", mode="measure", cache=plan_cache)


@pytest.mark.parametrize("turf,log_m,ef,R", [
    ("dense_shift", 7, 8, 16), ("sparse_shift", 7, 4, 64), ("cannon", 6, 32, 32)])
def test_auto_plan_is_valid_and_oracle_correct(turf, log_m, ef, R, plan_cache):
    S = HostCOO.rmat(log_m, ef, seed=0)
    plan = get_plan(Problem.from_coo(S, R), LocalWorld(8), device="cpu", mode="model",
                    cache=plan_cache)
    assert plan.algorithm in ALGORITHM_FACTORIES
    assert plan.c in cands.legal_c_values(plan.algorithm, 8, R)
    assert plan.kernel in ("cuda-f32", "torch")
    alg = plan.instantiate(S, R=R, world=LocalWorld(8), device="cpu")
    assert alg.wire.label == (plan.wire or "f32")
    got, want = fingerprint_algorithm(alg, S), oracle_fingerprints(S, R)
    tol = 1e-2 if plan.wire == "bf16" else 1e-4
    for op, v in want.items():
        assert np.isclose(got[op], v, rtol=tol), (turf, op, got[op], v)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("mode", ["model", "measure"])
def test_cli_auto_writes_a_record_with_its_plan(mode, plan_cache, tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "4")
    out = tmp_path / "rec.jsonl"
    assert cli.main(["er", "6", "4", "auto", "16", "1", "--device", "cpu", "--trials", "1",
                     "--plan-mode", mode, "-o", str(out)]) == 0
    io = capsys.readouterr()
    printed = json.loads(io.out.splitlines()[-1])
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["plan"]["algorithm"] == rec["algorithm"] == printed["algorithm"]
    assert rec["plan"]["source"] == ("measured" if mode == "measure" else "model")
    assert rec["c"] == rec["plan"]["c"] and rec["wire"] == (rec["plan"]["wire"] or "f32")
    assert f"plan[{rec['plan']['source']}] {rec['algorithm']} c={rec['c']}" in io.err
    # The second call recalls the plan from the cache.
    assert cli.main(["er", "6", "4", "auto", "16", "1", "--device", "cpu", "--trials", "1",
                     "--plan-mode", mode]) == 0
    assert f"plan[{rec['plan']['source']}]" in capsys.readouterr().err


def test_cli_wire_flag_reaches_the_record(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "4")
    out = tmp_path / "rec.jsonl"
    for w in ("bf16", "f32"):
        assert cli.main(["er", "6", "4", "15d_fusion2", "16", "2", "--device", "cpu",
                         "--trials", "1", "--wire", w, "-o", str(out)]) == 0
    assert [json.loads(x)["wire"] for x in out.read_text().splitlines()] == ["bf16", "f32"]
    assert all("plan" not in json.loads(x) for x in out.read_text().splitlines())
    with pytest.raises(SystemExit):
        cli.main(["er", "6", "4", "15d_fusion2", "16", "1", "--wire", "fp8"])
    capsys.readouterr()


# -------------------------------------------------------------- from_plan


def test_from_plan_builds_the_same_als_and_gat(plan_cache):
    S = HostCOO.rmat(6, 8, seed=0)
    plan = Plan(algorithm="15d_fusion2", c=2, kernel="cuda-f32", wire="bf16")
    als = DistributedALS.from_plan(S, R=16, plan=plan, world=LocalWorld(4), device="cpu")
    ref = DistributedALS(make_algorithm("15d_fusion2", S, 16, c=2, world=LocalWorld(4),
                                        device="cpu", wire="bf16"), S_host=S)
    assert als.plan is plan and ref.plan is None and als.d_ops.wire.label == "bf16"
    for model in (als, ref):
        model.initialize_embeddings()
        model.run_cg(1, cg_iters=3)
    assert als.compute_residual() == ref.compute_residual()
    layers = [GATLayer(16, 8, 2), GATLayer(16, 8, 2)]
    gat = GAT.from_plan(S, layers, world=LocalWorld(4), device="cpu")
    assert gat.plan.source == "model" and gat.plan.algorithm in ALGORITHM_FACTORIES
    ref_layers = [GATLayer(16, 8, 2), GATLayer(16, 8, 2)]
    ref = GAT(ref_layers, gat.plan.instantiate(S, R=16, world=LocalWorld(4), device="cpu"))
    torch.testing.assert_close(gat.forward(), ref.forward(), rtol=0, atol=0)
    again = DistributedALS.from_plan(S, R=16, world=LocalWorld(4), device="cpu")
    assert again.plan.algorithm in ALGORITHM_FACTORIES and again.S_host is S


# ----------------------------------------------------------------- retry


def test_call_with_timeout_returns_propagates_and_expires():
    assert call_with_timeout(lambda: 42, 5.0) == 42
    assert call_with_timeout(lambda: 7, 0) == 7
    with pytest.raises(KeyError):
        call_with_timeout(lambda: {}["x"], 5.0)
    t0 = time.monotonic()
    with pytest.raises(CallTimeout):
        call_with_timeout(lambda: time.sleep(10), 0.2, label="hang")
    assert time.monotonic() - t0 < 5.0


def test_call_with_timeout_works_off_the_main_thread():
    result = {}

    def worker():
        try:
            call_with_timeout(lambda: time.sleep(10), 0.2)
        except CallTimeout:
            result["timed_out"] = True

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert result.get("timed_out") is True


def test_backoff_jitter_bounds_determinism_and_desync():
    bo = Backoff(base_s=1.0, factor=2.0, jitter=0.5, rng=random.Random(7))
    delays = [bo.delay(i) for i in range(4)]
    for i, d in enumerate(delays):
        assert 1.0 * 2 ** i < d <= 1.5 * 2 ** i
    bo2 = Backoff(base_s=1.0, factor=2.0, jitter=0.5, rng=random.Random(7))
    assert delays == [bo2.delay(i) for i in range(4)]
    a = Backoff(base_s=1.0, jitter=0.5)
    b = Backoff(base_s=1.0, jitter=0.5, rng=random.Random(a.rng.random()))
    assert [a.delay(i) for i in range(4)] != [b.delay(i) for i in range(4)]


def test_retry_call_recovers_exhausts_gives_up_and_caps():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TimeoutError("flaky")
        return "ok"

    no_wait = Backoff(base_s=0.0, jitter=0.0)
    assert retry_call(flaky, retries=3, backoff=no_wait, sleep=lambda s: None) == "ok"
    assert calls["n"] == 3

    def dead():
        raise TimeoutError("dead")

    with pytest.raises(TimeoutError):
        retry_call(dead, retries=2, backoff=no_wait, sleep=lambda s: None)
    bad = {"n": 0}

    def deterministic():
        bad["n"] += 1
        raise ValueError("deterministic")

    with pytest.raises(ValueError):
        retry_call(deterministic, retries=5, retry_on=(Exception,), give_up_on=(ValueError,),
                   sleep=lambda s: None)
    assert bad["n"] == 1
    sleeps, clock = [], iter(range(0, 10000, 100))
    with pytest.raises(TimeoutError):
        retry_call(dead, retries=10, backoff=Backoff(base_s=1.0, jitter=0.0,
                                                     max_elapsed_s=150.0),
                   sleep=sleeps.append, clock=lambda: float(next(clock)))
    assert len(sleeps) < 10


def test_counters_are_a_thread_safe_registry():
    c = metrics.Counters()
    threads = [threading.Thread(target=lambda: [c.add("x") for _ in range(1000)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.get("x") == 4000 and c.snapshot() == {"x": 4000.0} and c.get("y", 3.0) == 3.0
    c.clear()
    assert c.snapshot() == {}
