"""The port's benchmark command line, ``python -m
distributed_sddmm_tpu_torch.bench er ...``, on the CPU: one JSON summary
line per run, the full record appended to ``-o``, unported flags refused;
and the apps' records against the JAX package's."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.resilience import CheckpointStore
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Benchmarks here write no run document into the checkout's default store.
os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"


def _run(*args, env=None):
    extra = env or {}
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.update(extra)
    return subprocess.run([sys.executable, "-m", "distributed_sddmm_tpu_torch.bench",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


def test_er_attention_subprocess_prints_one_json_line(tmp_path):
    """The summary rounds GFLOP/s to 3 decimals, as the JAX CLI does: at
    this size a loaded CPU runs below 5e-4 GFLOP/s, which prints 0.0, so
    the rate is read unrounded from the record."""
    out = tmp_path / "rec.jsonl"
    proc = _run("er", "6", "4", "15d_fusion2", "8", "1", "--app", "attention",
                "--mask", "window:4", "--device", "cpu", "--kernel", "torch",
                "-o", str(out))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert summary["algorithm"] == "15d_fusion2" and summary["fused"] is True
    assert summary["GFLOPs"] >= 0
    rec = json.loads(out.read_text())
    assert rec["overall_throughput"] > 0 and rec["elapsed"] > 0


def test_er_accepts_no_runstore_and_writes_nothing(tmp_path):
    """``--no-runstore`` beats ``SDDMM_TORCH_RUNSTORE``: a subprocess run
    with the knob naming a store writes no document there; without the flag
    the same run writes one."""
    env_store = tmp_path / "store"
    base = ("er", "6", "4", "15d_fusion2", "8", "1", "--device", "cpu", "--kernel", "torch")
    proc = _run(*base, "--no-runstore", env={"SDDMM_TORCH_RUNSTORE": str(env_store)})
    assert proc.returncode == 0, proc.stderr
    assert not env_store.exists()
    proc = _run(*base, env={"SDDMM_TORCH_RUNSTORE": str(env_store)})
    assert proc.returncode == 0, proc.stderr
    assert len(list((env_store / "runs").glob("*.json"))) == 1


@pytest.mark.parametrize("kernel,name", [("cuda-f32", "cuda-f32"),
                                         ("cuda-bf16", "cuda-bf16"),
                                         (None, "cuda-f32"), ("torch", "torch")])
def test_er_records_both_apps(tmp_path, capsys, kernel, name):
    out = tmp_path / "rec.jsonl"
    base = ["er", "5", "4", "15d_fusion1", "4", "1", "--device", "cpu",
            "--trials", "1", "-o", str(out)]
    base += [] if kernel is None else ["--kernel", kernel]
    assert cli.main(base + ["--app", "attention", "--mask", "bigbird:w=2",
                            "--fused", "both"]) == 0
    assert cli.main(base) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    summaries = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["fused"] for r in summaries] == [True, False, True]
    assert [(r["app"], r["mask"], r["fused"]) for r in recs] == [
        ("attention", "bigbird:w=2", True), ("attention", "bigbird:w=2", False),
        ("vanilla", None, True)]
    assert all(r["kernel"] == name and r["device"] == "cpu" for r in recs)
    assert recs[0]["alg_info"]["m"] == 32 and "attention_hbm" in recs[0]


def test_er_graph_mask_keeps_the_rmat_pattern(tmp_path):
    out = tmp_path / "rec.jsonl"
    args = ["er", "5", "4", "15d_fusion2", "4", "1", "--device", "cpu",
            "--trials", "1", "-o", str(out)]
    cli.main(args + ["--app", "attention", "--mask", "graph"])
    cli.main(args)
    graph, vanilla = (json.loads(line) for line in out.read_text().splitlines())
    assert graph["alg_info"]["nnz"] == vanilla["alg_info"]["nnz"]


def test_er_unported_app_raises(tmp_path, capsys):
    """Every app of the JAX CLI is ported: ``--app als`` (with a checkpoint
    store, then resumed from it) and ``--app gat`` append their records;
    an unknown app is refused by argparse."""
    out, ckpt = tmp_path / "rec.jsonl", tmp_path / "ckpt"
    base = ["er", "5", "4", "15d_fusion2", "4", "1", "--device", "cpu", "--trials", "2",
            "-o", str(out)]
    assert cli.main(base + ["--app", "als", "--checkpoint-dir", str(ckpt)]) == 0
    assert CheckpointStore(ckpt).steps() == [1, 2]
    assert cli.main(base + ["--app", "als", "--checkpoint-dir", str(ckpt), "--resume",
                            "--checkpoint-every", "2"]) == 0
    assert cli.main(base + ["--app", "gat"]) == 0
    als, resumed, gat = (json.loads(line) for line in out.read_text().splitlines())
    assert als["app"] == resumed["app"] == "als" and als["cg_iters"] == 10
    # The resumed run starts at the stored step 2 of 2: no step runs.
    assert resumed["metrics"].keys() == {"sddmmA"}
    assert resumed["als_residual"] == pytest.approx(als["als_residual"], rel=1e-6)
    assert gat["app"] == "gat" and gat["gat_heads"] == [4, 4, 6] and gat["R"] == 24
    assert len(capsys.readouterr().out.splitlines()) == 3
    proc = _run("er", "5", "4", "15d_fusion2", "4", "1", "--device", "cpu",
                "--app", "nope")
    assert proc.returncode == 2 and "--app" in proc.stderr


APP_RECORD_DIFFS = {
    # Fields one package has and the other has not, by design: the port
    # names the device it ran on; the JAX package's XLA cost cross-check
    # (present only when programs were costed) has no counterpart: eager
    # PyTorch compiles no program to cost.
    "port_only": {"device"},
    "jax_only": {"xla_cost"},
}


@pytest.mark.parametrize("app,alg,p", [
    pytest.param("als", "15d_fusion2", 4, id="als"),
    pytest.param("gat", "15d_fusion2", 4, id="gat"),
    pytest.param("als", "15d_sparse", 4, id="als-15d_sparse"),
    pytest.param("als", "25d_dense_replicate", 8, id="als-25d_dense_replicate"),
    pytest.param("als", "25d_sparse_replicate", 8, id="als-25d_sparse_replicate"),
    pytest.param("gat", "15d_sparse", 4, id="gat-15d_sparse"),
    pytest.param("gat", "25d_dense_replicate", 8, id="gat-25d_dense_replicate"),
    pytest.param("gat", "25d_sparse_replicate", 8, id="gat-25d_sparse_replicate"),
    pytest.param("vanilla", "15d_fusion1", 4, id="vanilla-15d_fusion1"),
    pytest.param("vanilla", "15d_fusion2", 4, id="vanilla-15d_fusion2"),
    pytest.param("attention", "15d_fusion1", 4, id="attention-15d_fusion1"),
    pytest.param("attention", "15d_fusion2", 4, id="attention-15d_fusion2"),
    pytest.param("vanilla", "15d_sparse", 4, id="vanilla-15d_sparse"),
    pytest.param("vanilla", "25d_dense_replicate", 8, id="vanilla-25d_dense_replicate"),
    pytest.param("vanilla", "25d_sparse_replicate", 8, id="vanilla-25d_sparse_replicate"),
])
def test_app_records_match_jax(app, alg, p):
    """Both packages' ``benchmark_algorithm`` on one ER matrix: the same
    record fields but the listed ones, the same configuration values, the
    same app fields and the same per-op counters (``cgStep`` an ALS CG
    iteration, ``gatLayer`` a GAT layer on the dense shift; the R-split
    strategies' fused pair is their sddmmA and spmmA, and their apps run
    the public ops) and the same ``alg_info``. Attention runs on the
    ``window:4`` mask over as many tokens; its counted ``attention_hbm``
    counts each package's own tile arrays."""
    import jax

    from distributed_sddmm_tpu import masks as jax_masks
    from distributed_sddmm_tpu.bench import harness as jax_harness
    from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

    from distributed_sddmm_tpu_torch.bench import harness

    S = JaxCOO.erdos_renyi(32, 32, 4, seed=1)
    kw = dict(R=4, c=2, app=app, trials=2)
    if app == "attention":
        S = jax_masks.from_spec("window:4", n=32)
        kw["mask"] = "window:4"
    want = jax_harness.benchmark_algorithm(S, alg, None, True,
                                           devices=jax.devices()[:p], **kw)
    got = harness.benchmark_algorithm(HostCOO(S.rows, S.cols, S.vals, S.M, S.N),
                                      alg, None, True, device="cpu",
                                      world=LocalWorld(p), **kw)
    assert set(got) - set(want) == APP_RECORD_DIFFS["port_only"]
    assert set(want) - set(got) <= APP_RECORD_DIFFS["jax_only"]
    for key in ("algorithm", "app", "R", "c", "fused", "fusion", "mask", "num_trials",
                "kernel_variant", "wire", "num_processes", "process_index", "cg_iters",
                "gat_heads", "als_degraded", "program_store", "dynstruct"):
        assert got.get(key) == want.get(key), key
    assert set(got["metrics"]) == set(want["metrics"])
    assert {k: v["calls"] for k, v in got["metrics"].items()} == {
        k: v["calls"] for k, v in want["metrics"].items()}
    # The same metric fields, and the same counted words, bytes and FLOPs.
    for op, m in want["metrics"].items():
        assert set(got["metrics"][op]) == set(m), op
        for key in ("retries", "comm_words", "comm_bytes", "comm_words_extra", "flops"):
            assert got["metrics"][op][key] == m[key], (op, key)
    assert set(got["perf_stats"]) == set(want["perf_stats"])
    for key in ("m", "n", "nnz", "r", "p", "c", "dim_values", "nnz_procs"):
        assert got["alg_info"][key] == want["alg_info"][key], key
    if app in ("vanilla", "attention"):
        assert got["alg_info"] == want["alg_info"]
    if app == "attention":
        assert set(got["attention_hbm"]) == set(want["attention_hbm"])


def test_er_groups_run_each_member_and_skip_what_refuses(tmp_path, capsys, monkeypatch):
    """``er 15d|25d|all``: one record and one summary line a member that
    runs; a member the grid, the app or the fusion build refuses is
    reported on stderr and skipped, and the group goes on (the JAX
    sweep's rule). Both apps run on every member."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "4")
    out = tmp_path / "rec.jsonl"

    def run(group, c, *extra):
        assert cli.main(["er", "5", "4", group, "4", str(c), "--device", "cpu", "--trials",
                         "1", "-o", str(out), *extra]) == 0
        io = capsys.readouterr()
        ran = [json.loads(line)["algorithm"] for line in io.out.splitlines()]
        skipped = [line.split()[1] for line in io.err.splitlines() if line.startswith("skip ")]
        return ran, skipped

    every = ["15d_fusion1", "15d_fusion2", "15d_sparse", "25d_dense_replicate",
             "25d_sparse_replicate"]
    assert run("all", 1) == (every, [])
    assert run("15d", 2) == (every[:3], [])
    # p/c = 2 is no square: both Cannon members refuse the grid.
    assert run("25d", 2) == ([], every[3:])
    assert run("all", 1, "--fusion", "overlap") == (every[:3], every[3:])
    assert run("all", 1, "--app", "attention", "--mask", "window:2") == (
        every[:2], every[2:])
    assert run("all", 1, "--app", "als") == (every, [])
    assert run("all", 1, "--app", "gat") == (every, [])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["algorithm"] for r in recs] == every + every[:3] + every[:3] + every[:2] + every * 2
    assert all(r["app"] == "gat" and r["gat_heads"] == [4, 4, 6] for r in recs[-5:])
    assert all(np.isfinite(r["als_residual"]) for r in recs[-10:-5])
    assert {r["alg_info"]["alg_name"] for r in recs[:5]} == {
        "1.5D Block Row Replicated S Striped AB Cyclic Shift",
        "1.5D Sparse Shifting Dense Replicating Algorithm",
        "2.5D Cannon's Algorithm Replicating Dense Matrices",
        "2.5D Cannon's Algorithm Replicating Sparse Matrix"}
    assert recs[3]["alg_info"]["dim_values"] == [2, 2, 1]
    with pytest.raises(SystemExit, match="unknown algorithm 'nope'"):
        cli.main(["er", "5", "4", "nope", "4", "1", "--device", "cpu"])


def test_er_at_four_local_ranks_overlap_and_breakdown(tmp_path, capsys, monkeypatch):
    """``SDDMM_TORCH_LOCAL_RANKS=4``: the world of the run is four ranks in
    this process; ``--fusion overlap`` and ``--breakdown`` run, and the
    records carry the world, the fusion build and the grid."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "4")
    out = tmp_path / "rec.jsonl"
    base = ["er", "6", "4", "15d_fusion2", "8", "2", "--device", "cpu",
            "--trials", "2", "-o", str(out)]
    assert cli.main(base + ["--fusion", "overlap"]) == 0
    assert cli.main(base + ["--breakdown"]) == 0
    overlap, breakdown = (json.loads(line) for line in out.read_text().splitlines())
    assert len(capsys.readouterr().out.splitlines()) == 2
    for rec, fusion in ((overlap, "overlap"), (breakdown, "sequential")):
        assert rec["fusion"] == fusion
        assert (rec["num_processes"], rec["process_index"]) == (1, 0)
        info = rec["alg_info"]
        assert info["p"] == 4 and info["c"] == 2 and info["adjacency_mode"] == 1
        assert info["dim_values"] == [2, 2] and len(info["nnz_procs"]) == 4
    assert set(breakdown["perf_stats"]) == {"fusedSpMM", "replication", "ppermute",
                                            "fusedSpMM_total"}
    assert set(overlap["perf_stats"]) == {"fusedSpMM"}


def test_er_breakdown_refuses_what_it_cannot_attribute():
    for extra in (["--app", "attention"], ["--fused", "no"]):
        with pytest.raises(SystemExit, match="--breakdown requires"):
            cli.main(["er", "5", "4", "15d_fusion2", "4", "1", "--device", "cpu",
                      "--breakdown", *extra])
    proc = _run("er", "5", "4", "15d_fusion2", "4", "1", "--device", "cpu",
                "--fusion", "double")
    assert proc.returncode == 2 and "--fusion" in proc.stderr


# ------------------------------------------------- the rest of the command line


def _jax_main(argv, monkeypatch, tmp_path, bench: bool = True) -> int:
    """The JAX package's CLI in this process, on its forced 8-device CPU
    mesh; a benchmark runs with the XLA kernel and without its run store.
    Its plan cache is redirected under ``tmp_path`` and its program store
    is off (re-read from ``DSDDMM_PROGRAMS=0`` whatever an earlier test in
    this process enabled), so no run writes into the checkout's
    ``artifacts/``."""
    from distributed_sddmm_tpu.bench import cli as jax_cli
    from distributed_sddmm_tpu.programs import store as jax_programs

    monkeypatch.setenv("DSDDMM_PLAN_CACHE", str(tmp_path / "jax_plan_cache"))
    monkeypatch.setenv("DSDDMM_PROGRAMS", "0")
    monkeypatch.setattr(jax_programs, "_active", None)
    monkeypatch.setattr(jax_programs, "_env_checked", False)
    return jax_cli.main([*argv, "--kernel", "xla", "--no-runstore"] if bench else argv)


def test_jax_cli_runs_write_no_store_in_the_checkout(tmp_path, monkeypatch, capsys):
    """A JAX ``er`` run through ``_jax_main`` writes nothing at the JAX
    package's default program-store and plan-cache roots (here moved to
    canaries under ``tmp_path``, so that other processes writing the
    checkout's ``artifacts/`` cannot touch the check), and leaves the
    program store off."""
    from distributed_sddmm_tpu.autotune import cache as jax_cache
    from distributed_sddmm_tpu.programs import store as jax_programs

    canary = tmp_path / "default_roots"
    monkeypatch.setattr(jax_programs, "DEFAULT_ROOT", canary / "programs")
    monkeypatch.setattr(jax_cache, "DEFAULT_CACHE_DIR", canary / "plan_cache")
    monkeypatch.setattr(jax_programs, "_active", jax_programs.ProgramStore(canary / "stale"))
    monkeypatch.setattr(jax_programs, "_env_checked", True)
    out = tmp_path / "jax.jsonl"
    argv = ["er", "5", "4", "15d_fusion2", "8", "1", "--trials", "1", "-o", str(out)]
    assert _jax_main(argv, monkeypatch, tmp_path) == 0
    assert len(_records(out)) == 1
    assert jax_programs.active() is None
    assert not (canary / "programs").exists() and not (canary / "plan_cache").exists()
    assert not any((canary / "stale").rglob("*.prog"))
    assert jax_cache.default_cache_dir() == tmp_path / "jax_plan_cache"


def _records(path) -> list:
    return [json.loads(line) for line in pathlib.Path(path).read_text().splitlines()]


@pytest.mark.parametrize("argv", [
    pytest.param(["er", "6", "4", "15d_fusion2", "8", "2"], id="er"),
    pytest.param(["file", "{mtx}", "15d_fusion2", "8", "2"], id="file"),
    pytest.param(["file", "{mtx}", "15d_fusion1", "8", "1", "--permute"], id="file-permute"),
    pytest.param(["file", "{mtx}", "all", "8", "2"], id="file-all"),
    pytest.param(["heatmap", "6", "4", "2", "--alg", "15d_fusion2", "--r-values", "8", "16"],
                 id="heatmap"),
])
def test_records_share_alg_info_with_the_jax_cli(tmp_path, monkeypatch, capsys, argv):
    """``er``, ``file`` (a Graph500 R-mat written to ``.mtx``, with and
    without ``--permute``) and ``heatmap`` on both command lines at p = 8
    (the JAX mesh's devices, the port's ``SDDMM_TORCH_LOCAL_RANKS``): the
    same members run, in the same order, at the same R, each record's
    ``alg_info`` equal to the JAX CLI's."""
    from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "8")
    mtx = tmp_path / "g500.mtx"
    JaxCOO.rmat(log_m=6, edge_factor=4, a=0.57, b=0.19, c=0.19, d=0.05, seed=2).save_mtx(
        str(mtx))
    argv = [a.format(mtx=mtx) for a in argv]
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert cli.main([*argv, "--device", "cpu", "--trials", "1", "-o", str(ours)]) == 0
    assert _jax_main([*argv, "--trials", "1", "-o", str(theirs)], monkeypatch, tmp_path) == 0
    got, want = _records(ours), _records(theirs)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g["algorithm"], g["R"], g["c"]) == (w["algorithm"], w["R"], w["c"])
        assert g["alg_info"] == w["alg_info"], g["algorithm"]
    if argv[0] == "heatmap":
        assert [g["R"] for g in got] == [8, 16]


def test_permute_writes_the_jax_permutation(tmp_path, monkeypatch, capsys):
    """``permute`` (default output ``<in>-permuted.mtx``, and ``-o`` with
    a seed) writes the matrix the JAX ``permute`` writes, and prints the
    same line."""
    from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

    src = tmp_path / "m.mtx"
    J = JaxCOO.erdos_renyi(40, 30, 3, seed=4, values="normal")
    J.save_mtx(str(src))
    assert cli.main(["permute", str(src)]) == 0
    ours_line = capsys.readouterr().out
    ours = HostCOO.load_mtx(tmp_path / "m-permuted.mtx")
    assert _jax_main(["permute", str(src), "-o", str(tmp_path / "j.mtx")], monkeypatch,
                     tmp_path, bench=False) == 0
    theirs_line = capsys.readouterr().out
    assert ours_line.split()[2:] == theirs_line.split()[2:]
    theirs = JaxCOO.load_mtx(str(tmp_path / "j.mtx"))
    for key in ("rows", "cols", "vals", "M", "N"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(theirs, key))
    np.testing.assert_array_equal(ours.rows, J.random_permuted(seed=0).rows)
    assert cli.main(["permute", str(src), "--seed", "3", "-o", str(tmp_path / "s3.mtx")]) == 0
    np.testing.assert_array_equal(HostCOO.load_mtx(tmp_path / "s3.mtx").cols,
                                  J.random_permuted(seed=3).cols)


def test_verify_prints_ok_lines_and_matches_the_jax_fingerprints(capsys, monkeypatch):
    """``verify`` at its defaults (R-mat 8/8, R 16, c 1, every algorithm,
    cuda-f32): one ``OK`` line an op and algorithm, exit 0; each
    algorithm's fingerprints within 1e-6 of the JAX package's
    ``fingerprint_algorithm`` through ``PallasKernel(interpret=True,
    precision="f32")``; a wrong oracle exits 1 with ``FAIL`` lines."""
    import jax

    from distributed_sddmm_tpu.bench.harness import make_algorithm as jax_make
    from distributed_sddmm_tpu.ops.pallas_kernels import PallasKernel
    from distributed_sddmm_tpu.utils import verify as jax_verify
    from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

    from distributed_sddmm_tpu_torch.bench.harness import make_algorithm
    from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
    from distributed_sddmm_tpu_torch.utils import verify

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("SDDMM_TORCH_LOCAL_RANKS", raising=False)
    assert cli.main(["verify", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 * 5 and all(line.startswith("OK ") for line in lines)
    S, J = HostCOO.rmat(8, 8, seed=0), JaxCOO.rmat(log_m=8, edge_factor=8, seed=0)
    for name in cli.ALG_GROUPS["all"]:
        got = verify.fingerprint_algorithm(
            make_algorithm(name, S, 16, 1, kernel=CudaTileKernel("f32", device="cpu"),
                           device="cpu"), S)
        want = jax_verify.fingerprint_algorithm(
            jax_make(name, J, 16, 1, kernel=PallasKernel(interpret=True, precision="f32"),
                     devices=jax.devices()[:1]), J)
        for op, v in want.items():
            assert got[op] == pytest.approx(v, rel=1e-6), (name, op)
    real = verify.oracle_fingerprints
    monkeypatch.setattr(verify, "oracle_fingerprints",
                        lambda S, R: {k: v * 1.01 for k, v in real(S, R).items()})
    assert cli.main(["verify", "--device", "cpu", "--alg", "15d_fusion2"]) == 1
    assert all(line.startswith("FAIL") for line in capsys.readouterr().out.splitlines())


#: Record fields of ``kernels`` and ``baseline`` that one package has and
#: the other has not: the port names the device; the JAX sweep's tiling
#: knobs of its Pallas kernel have no counterpart.
KERNEL_RECORD_DIFFS = {"port_only": {"device"},
                       "jax_only": {"bm", "bn", "group", "chunk", "scatter_form",
                                    "batch_step"}}


def test_kernels_and_baseline_records_have_the_jax_keys(tmp_path, capsys):
    """``kernels`` (its three kernels) and ``baseline`` on the CPU: the JAX
    records' keys (its XLA record's; its Pallas records add the tiling
    knobs) plus ``device``; the same sizes and FLOP accounting."""
    from distributed_sddmm_tpu.bench import baseline as jax_baseline
    from distributed_sddmm_tpu.bench import kernels as jax_kernels
    from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

    out = tmp_path / "k.jsonl"
    assert cli.main(["kernels", "--log-m", "7", "--nnz-per-row", "4", "--r-values", "8",
                     "--kernels", "cuda-f32", "cuda-bf16", "torch", "--trials", "2",
                     "--device", "cpu", "-o", str(out)]) == 0
    recs = _records(out)
    J = JaxCOO.rmat(log_m=7, edge_factor=4, seed=0)
    J = J.with_values(np.random.default_rng(1).standard_normal(J.nnz))
    want = jax_kernels._bench_one(J, 8, "xla", 2)
    assert [r["kernel"] for r in recs] == ["cuda-f32", "cuda-bf16", "torch"]
    for rec in recs:
        assert set(rec) - set(want) == KERNEL_RECORD_DIFFS["port_only"]
        assert set(want) <= set(rec)
        assert (rec["M"], rec["N"], rec["nnz"], rec["R"]) == (want["M"], want["N"],
                                                               want["nnz"], want["R"])
        assert rec["device"] == "cpu" and rec["fused_pair_ms"] > 0
        assert rec["sddmm_gflops"] == pytest.approx(2 * rec["nnz"] * 8 / rec["sddmm_ms"] / 1e6)
    assert cli.main(["baseline", "7", "4", "8", "--iters", "2", "-o", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    rec = _records(out)[-1]
    want = jax_baseline.run_baseline(J, R=8, iters=2)
    assert printed == rec and rec["device"] == "host"
    assert set(rec) - set(want) == KERNEL_RECORD_DIFFS["port_only"] and set(want) <= set(rec)
    for key in ("baseline", "m", "n", "nnz", "r", "num_iterations"):
        assert rec[key] == want[key], key


UNPORTED_COMMANDS = ("overlap", "fleet", "tune", "top", "lint", "env")


@pytest.mark.parametrize("base", [["er", "5", "4", "15d_fusion2", "4", "1"],
                                  ["file", "m.mtx", "15d_fusion2", "4", "1"],
                                  ["heatmap", "5", "4", "1"]], ids=["er", "file", "heatmap"])
def test_unported_flags_and_subcommands_are_refused(base, capsys):
    """Every flag of the JAX benchmark subcommands is ported (the last,
    ``--no-runstore``, parses on each); the subcommands that are not are
    refused."""
    assert cli.build_parser().parse_args([*base, "--no-runstore"]).no_runstore
    for cmd in UNPORTED_COMMANDS:
        with pytest.raises(SystemExit) as e:
            cli.main([cmd])
        assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err


OBS_FLAGS = {
    "faults": ["--faults", '[{"site": "execute:fusedSpMM", "kind": "error", "at": [1]}]'],
    "trace": ["--trace", "{tmp}/t.jsonl"],
    "profile": ["--profile", "{tmp}/prof"],
    "watchdog": ["--watchdog", "warn"],
    "flightrec": ["--flightrec", "{tmp}/fr"],
}


@pytest.mark.parametrize("flag", list(OBS_FLAGS))
@pytest.mark.parametrize("base", [["er", "5", "4", "15d_fusion2", "4", "1"],
                                  ["file", "{tmp}/m.mtx", "15d_fusion2", "4", "1"],
                                  ["heatmap", "5", "4", "1", "--alg", "15d_fusion2",
                                   "--r-values", "4"]], ids=["er", "file", "heatmap"])
def test_observability_flags_run_and_land_in_the_record(base, flag, tmp_path, capsys):
    """Each flag of the JAX CLI's ``er``, ``file`` and ``heatmap``: the run
    exits 0, the record carries what the flag adds (``faults_fired`` and a
    retry, ``run_id``/``trace_path``, ``anomalies``), the profile and the
    trace land where asked, and nothing stays on after the command."""
    from distributed_sddmm_tpu_torch.obs import flightrec, profiler, trace, watchdog
    from distributed_sddmm_tpu_torch.resilience import faults

    HostCOO.rmat(5, 4, seed=0).save_mtx(tmp_path / "m.mtx")
    out = tmp_path / "rec.jsonl"
    argv = [a.replace("{tmp}", str(tmp_path)) for a in [*base, *OBS_FLAGS[flag]]]
    assert cli.main([*argv, "--device", "cpu", "--trials", "2", "-o", str(out)]) == 0
    (rec,) = _records(out)
    if flag == "faults":
        assert rec["faults_fired"] == [{"site": "execute:fusedSpMM", "kind": "error",
                                        "call": 1}]
        assert rec["metrics"]["fusedSpMM"]["retries"] == 1
    elif flag == "trace":
        assert rec["trace_path"] == str(tmp_path / "t.jsonl") and rec["run_id"]
        assert (tmp_path / "t.manifest.json").exists()
    elif flag == "profile":
        assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1
    elif flag == "watchdog":
        assert rec["anomalies"] == {"mode": "warn", "total": 0, "anomalies": []}
    else:  # armed, but no watchdog: nothing fires, nothing is dumped
        assert "anomalies" not in rec and not list(tmp_path.glob("fr/*/*.json"))
    assert faults.active() is None and not trace.enabled() and not profiler.active()
    assert watchdog.active() is None and flightrec.active() is None


def test_fault_and_watchdog_records_match_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``er ... --faults PLAN --watchdog warn`` on both command lines at p =
    8, c = 2: the same ``faults_fired``, the same retries a op and the same
    anomalies (a ``comm:fusedSpMM`` skew's ``comm_mismatch``; four calls,
    fewer than the watchdog's warmup, so no timing anomaly can fire). The
    JAX CLI leaves its plan and watchdog on, so they are turned off
    here."""
    from distributed_sddmm_tpu.obs import watchdog as jax_watchdog
    from distributed_sddmm_tpu.resilience import faults as jax_faults

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "8")
    plan = json.dumps({"seed": 3, "specs": [
        {"site": "execute:fusedSpMM", "kind": "error", "at": [1]},
        {"site": "output:fusedSpMM", "kind": "nan", "at": [2], "param": 0.1},
        {"site": "comm:fusedSpMM", "kind": "skew", "prob": 1.0, "param": 2.0}]})
    argv = ["er", "6", "4", "15d_fusion2", "8", "2", "--trials", "3", "--faults", plan,
            "--watchdog", "warn"]
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    try:
        assert cli.main([*argv, "--device", "cpu", "-o", str(ours)]) == 0
        assert _jax_main([*argv, "-o", str(theirs)], monkeypatch, tmp_path) == 0
    finally:
        jax_faults.clear()
        jax_watchdog.disable()
    (got,), (want,) = _records(ours), _records(theirs)
    assert got["faults_fired"] == want["faults_fired"]
    assert [f["kind"] for f in got["faults_fired"]] == ["skew", "skew", "error", "nan"]
    assert ({op: m["retries"] for op, m in got["metrics"].items()}
            == {op: m["retries"] for op, m in want["metrics"].items()} == {"fusedSpMM": 2})
    assert got["anomalies"] == want["anomalies"]
    assert [(a["kind"], a["first"]["ratio"]) for a in got["anomalies"]["anomalies"]] == [
        ("comm_mismatch", 2.0)]


def test_card_subcommands_default_to_cuda():
    """Every subcommand that uses the card defaults to ``--device cuda``,
    and ``baseline`` takes no device (it runs on the host by design)."""
    parser = cli.build_parser()
    for argv in (["er", "5", "4", "a", "4", "1"], ["file", "m.mtx", "a", "4", "1"],
                 ["heatmap", "5", "4", "1"], ["kernels"], ["verify"]):
        assert parser.parse_args(argv).device == "cuda", argv[0]
    assert not hasattr(parser.parse_args(["baseline", "5", "4", "8"]), "device")
    assert parser.parse_args(["kernels"]).kernels == ["torch", "cuda-bf16"]
    assert parser.parse_args(["heatmap", "5", "4", "1"]).r_values == cli.HEATMAP_R_VALUES


def _seeded_store_and_traces(root: pathlib.Path) -> dict:
    """A store of the JAX tests' synthetic documents (three close runs, a
    slow one, one of another key) and their traces: a valid one, an invalid
    one, two shards of one run."""
    from test_obs_regress import make_doc
    from test_trace_export import _synthetic_trace
    from test_trace_merge import _shard

    from distributed_sddmm_tpu_torch.obs.store import RunStore

    store = RunStore(root / "store")
    for i, scale in enumerate([1.0, 1.02, 0.98]):
        store.put(dict(make_doc(f"run-{i}", scale), created_epoch=100.0 + i))
    store.put(dict(make_doc("other", key="key-z"), created_epoch=110.0))
    store.put(dict(make_doc("slow", 2.0), created_epoch=120.0))
    bad = root / "bad.jsonl"
    bad.write_text('{"type": "span", "name": "x"}\n')
    _shard(root / "P.jsonl", "ra", 1000.0, 11, spans=[("bench", 0.0, 2.0)])
    _shard(root / "P.shards" / "rb.jsonl", "rb", 1000.5, 22, spans=[("bench", 0.0, 1.0)])
    return {"store": str(root / "store"), "good": str(_synthetic_trace(root)),
            "bad": str(bad), "absent": str(root / "absent.jsonl"), "stem": str(root / "P.jsonl"),
            "root": str(ROOT), "out": str(root / "out")}


STORE_AND_TRACE_ARGVS = {
    "history": [["history", "--store", "{store}"], ["history", "--store", "{store}", "--key",
                                                    "key-z", "--json"],
                ["history", "--store", "{store}", "--limit", "2"]],
    "compare": [["compare", "run-0", "slow", "--store", "{store}"],
                ["compare", "latest~1", "latest", "--store", "{store}", "--json"],
                ["compare", "run-0", "nope", "--store", "{store}"],
                ["compare", "run", "slow", "--store", "{store}"]],
    "gate": [["gate", "slow", "--store", "{store}"],
             ["gate", "run-2", "--store", "{store}", "--threshold", "0.5"],
             ["gate", "other", "--store", "{store}"],
             ["gate", "slow", "--store", "{store}", "--min-runs", "5"],
             ["gate", "slow", "--store", "{store}", "--against", "run-1", "--json"],
             ["gate", "nope", "--store", "{store}"]],
    "backfill": [["backfill", "--store", "{out}/bf", "--root", "{root}"]],
    "report-html": [["report-html", "--store", "{store}", "-o", "{out}/r.html"]],
    "report-trace": [["report-trace", "{good}"], ["report-trace", "{bad}"],
                     ["report-trace", "{absent}"]],
    "trace-merge": [["trace-merge", "{stem}", "-o", "{out}/m.jsonl"],
                    ["trace-merge", "{bad}"], ["trace-merge", "{absent}"]],
    "trace-export": [["trace-export", "{good}", "-o", "{out}/c.json"],
                     ["trace-export", "{bad}"], ["trace-export", "{absent}"]],
}


@pytest.mark.parametrize("cmd", sorted(STORE_AND_TRACE_ARGVS))
def test_store_and_trace_subcommands_exit_like_the_jax_cli(cmd, tmp_path, capsys):
    """The eight run-store and trace subcommands take the JAX CLI's
    arguments and exit with its codes (0, 2 on a regression or an invalid
    trace, 3 without enough baseline runs, ``SystemExit`` on a run spec
    that names nothing); where the output holds no path or package name it
    is the JAX CLI's too."""
    from distributed_sddmm_tpu.bench import cli as jax_cli

    paths = _seeded_store_and_traces(tmp_path)
    for argv in STORE_AND_TRACE_ARGVS[cmd]:
        argv = [a.format(**paths) for a in argv]
        results = []
        for main in (cli.main, jax_cli.main):
            try:
                code = main(argv)
            except SystemExit as e:
                code = ("SystemExit", str(e.code)[:20])
            results.append((code, capsys.readouterr()))
        (got, ours), (want, theirs) = results
        assert got == want, argv
        if cmd in ("history", "compare", "gate"):
            assert ours.out == theirs.out, argv
    if cmd == "backfill":
        assert "backfilled" in ours.out and "backfill-bench_r05" in ours.out
