"""The port's run store (``obs/store.py``) against the JAX package's, and
its behaviour through the port's CLI on the CPU.

* Documents and index rows: the same ``_INDEX_FIELDS`` and
  ``_CONFIG_AXES``, the same rows of the same documents, ``put``/``get``/
  ``resolve``/``matching`` over one directory written by either package.
* A port ``er`` writes one document into the store its flags and
  ``SDDMM_TORCH_RUNSTORE`` name; ``--no-runstore`` and
  ``SDDMM_TORCH_RUNSTORE=0`` write none; the command leaves the store as it
  found it.
* The slice as a whole: one ``er`` of a small R-mat through the JAX CLI
  (``--kernel xla``, into a JAX store) and through the port's CLI
  (``--device cpu``): index rows with the same fields and the same values
  but the ones that differ by design (``BY_DESIGN``) and the timings.
* A JAX document and a port document of one problem in one directory never
  pool (``gate`` exits 3); backfilled TPU rounds never enter a card run's
  baseline; a corrupt index is rebuilt on read; two processes ingesting
  into one store keep both rows; autotune trials leave no document.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from test_obs_store import _doc

from distributed_sddmm_tpu.obs import regress as jax_regress
from distributed_sddmm_tpu.obs import store as jax_store

from distributed_sddmm_tpu_torch.autotune import Problem
from distributed_sddmm_tpu_torch.autotune.candidates import Candidate
from distributed_sddmm_tpu_torch.autotune.measure import measure_candidates
from distributed_sddmm_tpu_torch.bench import cli, harness
from distributed_sddmm_tpu_torch.obs import regress, store, trace
from distributed_sddmm_tpu_torch.obs.store import RunStore
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: Index fields whose values differ between the packages by design: the
#: run's identity and time, the key and backend (the port's name the card
#: or the CPU and the world kind, and hash the port's kernel families and
#: sources), the kernel name and the timings.
BY_DESIGN = {"run_id", "created_epoch", "key", "backend", "code_hash", "kernel",
             "elapsed", "overall_throughput"}

CARD = "cuda:NVIDIA H100 80GB HBM3:local"


@pytest.fixture(autouse=True)
def _fresh_store_state(monkeypatch):
    """Both packages' module state reset (no active store, the environment
    unread), and no tracer."""
    for mod in (store, jax_store):
        monkeypatch.setattr(mod, "_active", None)
        monkeypatch.setattr(mod, "_env_checked", False)
        monkeypatch.setattr(mod, "_suppress_count", 0)
    monkeypatch.delenv("SDDMM_TORCH_TRACE", raising=False)
    trace.disable()
    yield
    trace.disable()


def _record(R=64, p=8, **kw):
    rec = {"run_id": kw.pop("run_id", "r1"), "algorithm": "15d_fusion2", "app": "vanilla",
           "R": R, "c": 2, "fused": True, "kernel": "cuda-f32", "wire": "f32",
           "alg_info": {"m": 64, "n": 64, "nnz": 512, "p": p},
           "metrics": {"fusedSpMM": {"calls": 5, "kernel_s": 0.05, "overhead_s": 0.0,
                                     "retries": 0, "comm_words": 10.0, "flops": 1e6}}}
    rec.update(kw)
    return rec


# ------------------------------------------------------------- documents


def test_schema_constants_equal_jax():
    assert store._INDEX_FIELDS == jax_store._INDEX_FIELDS
    assert store._CONFIG_AXES == jax_store._CONFIG_AXES
    assert store.SCHEMA_VERSION == jax_store.SCHEMA_VERSION
    for spec in ("", "1", "on", "TRUE", "yes", "0", "off", "False", "no", "/some/dir"):
        assert store.parse_env_spec(spec) == jax_store.parse_env_spec(spec), spec
    for rid in ("run-a", "../x", ".hidden", "a/b\\c", "..."):
        assert store._safe_id(rid) == jax_store._safe_id(rid)


def test_index_rows_and_queries_equal_jax(tmp_path):
    """Documents written by either package read the same through both."""
    docs = [_doc("a1", t=1.0), _doc("a2", t=1.1), _doc("b1", key="k2"),
            _doc("c1", extra={"record": dict(_record(), c=1)}), _doc("w1", backend="tpu"),
            _doc("attn", extra={"record": dict(_record(), app="attention",
                                               mask="window:4")})]
    for i, d in enumerate(docs):
        d["created_epoch"] = 1000.0 + i
        (RunStore(tmp_path) if i % 2 else jax_store.RunStore(tmp_path)).put(dict(d))
    ours, theirs = RunStore(tmp_path), jax_store.RunStore(tmp_path)
    assert ours.index() == theirs.index()
    assert [store._index_row(d) for d in docs] == [jax_store._index_row(d) for d in docs]
    for kw in ({}, {"key": "k1"}, {"backend": "tpu"}, {"limit": 2}, {"limit": 0}):
        assert ours.history(**kw) == theirs.history(**kw), kw
    for rid in ("a1", "a2", "c1", "attn"):
        assert ours.matching(ours.get(rid)) == theirs.matching(theirs.get(rid)), rid
    for spec in ("latest", "latest~1", "latest~9", "a1", "b", "zz", "latest~x"):
        assert ours.resolve(spec) == theirs.resolve(spec), spec
    with pytest.raises(ValueError, match="ambiguous"):
        ours.resolve("a")


def test_port_store_reads_a_jax_cli_store(tmp_path, monkeypatch, capsys):
    """A store directory the JAX CLI wrote: the port's store and CLI list,
    resolve and gate its documents as the JAX CLI does."""
    from distributed_sddmm_tpu.bench import cli as jax_cli

    root = tmp_path / "jaxstore"
    monkeypatch.setenv("DSDDMM_RUNSTORE", str(root))
    monkeypatch.setenv("DSDDMM_PLAN_CACHE", str(tmp_path / "plans"))
    for _ in range(2):
        assert jax_cli.main(["er", "5", "4", "15d_fusion2", "8", "2", "--trials", "2",
                             "--kernel", "xla"]) == 0
    capsys.readouterr()
    ours, theirs = RunStore(root), jax_store.RunStore(root)
    assert len(ours.index()) == 2 and ours.index() == theirs.index()
    assert ours.matching(ours.resolve("latest")) == theirs.matching(theirs.resolve("latest"))
    for argv in (["history"], ["history", "--json"], ["compare", "latest~1", "latest"],
                 ["compare", "latest~1", "latest", "--json"], ["gate", "latest"],
                 ["gate", "latest", "--min-runs", "2"], ["gate", "latest", "--json"]):
        got = cli.main([*argv, "--store", str(root)])
        out = capsys.readouterr().out
        want = jax_cli.main([*argv, "--store", str(root)])
        assert (got, out) == (want, capsys.readouterr().out), argv


def test_build_run_doc_joins_trace_manifest_and_key(tmp_path):
    """The join on a traced record; the port's key hashes the port's kernel
    families and the backend of the manifest, and differs from the JAX key
    of the same record."""
    trace_path = tmp_path / "r1.jsonl"
    trace_path.write_text(
        json.dumps({"type": "begin", "schema": 1, "run_id": "r1", "t0_epoch": 0.0}) + "\n"
        + json.dumps({"type": "span", "name": "fusedSpMM", "id": 1, "tid": 1, "t0": 0.0,
                      "t1": 0.5, "dur_s": 0.5, "attrs": {"kernel_s": 0.5, "comm_words": 10.0,
                                                           "flops": 100.0}}) + "\n")
    (tmp_path / "r1.manifest.json").write_text(json.dumps({
        "schema": 1, "run_id": "r1", "backend": CARD, "torch_version": "2.x",
        "device_name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W", "git_rev": "abc",
        "env": {}}))
    rec = _record(trace_path=str(trace_path))
    doc = store.build_run_doc(rec)
    want = jax_store.build_run_doc(rec)
    assert doc["phases"] == want["phases"] and doc["strategy"] == want["strategy"]
    assert doc["trace_events"] == want["trace_events"]
    assert doc["backend"] == doc["manifest"]["backend"] == CARD
    assert doc["manifest"]["power_limit"] == "700.00 W"
    assert list(doc["fingerprint"]["kernels"]) == ["cuda-bf16", "cuda-f32", "torch"]
    # Even on one manifest's backend the keys differ: kernel families, code.
    assert doc["key"] != want["key"] and doc["code_hash"] != want["code_hash"]
    assert store.build_run_doc(dict(rec, run_id="r2"))["key"] == doc["key"]
    assert store.build_run_doc(dict(rec, R=128))["key"] != doc["key"]
    assert store.build_run_doc(dict(rec, trace_path=None))["backend"] == "cpu:local"


def test_traced_and_untraced_runs_reach_one_key(tmp_path, monkeypatch, capsys):
    """The backend comes from the manifest when a run is traced and from the
    process otherwise; both give the same string, so both runs share a key
    (what phase runstore checks on the card)."""
    root = tmp_path / "s"
    base = ["er", "5", "4", "15d_fusion2", "8", "1", "--device", "cpu", "--trials", "2",
            "--kernel", "torch"]
    monkeypatch.setenv("SDDMM_TORCH_RUNSTORE", str(root))
    assert cli.main(base) == 0
    assert cli.main([*base, "--trace", str(tmp_path / "t.jsonl")]) == 0
    capsys.readouterr()
    untraced, traced = (RunStore(root).get(r["run_id"]) for r in RunStore(root).index())
    assert "manifest" not in untraced and traced["manifest"]["backend"] == "cpu:local"
    assert untraced["backend"] == traced["backend"] == "cpu:local"
    assert untraced["key"] == traced["key"]
    assert traced["phases"]["fusedSpMM"]["calls"] == 3  # the warmup pair is traced too
    assert regress.gate(RunStore(root), traced, threshold=1e9)[0] == 0


# ------------------------------------------------------------- the CLI


def test_er_writes_one_doc_and_no_runstore_none(tmp_path, monkeypatch, capsys):
    root = tmp_path / "s"
    base = ["er", "5", "4", "15d_fusion2", "8", "1", "--device", "cpu", "--trials", "1",
            "--kernel", "torch"]
    monkeypatch.setenv("SDDMM_TORCH_RUNSTORE", str(root))
    assert cli.main(base) == 0
    rows = RunStore(root).index()
    assert len(rows) == 1 and rows[0]["algorithm"] == "15d_fusion2"
    assert rows[0]["backend"] == "cpu:local" and rows[0]["kernel"] == "torch"
    assert store._active is None  # the command turned its store off again
    assert cli.main([*base, "--no-runstore"]) == 0
    assert len(RunStore(root).index()) == 1
    assert cli.main(["heatmap", "5", "4", "1", "--alg", "15d_fusion2", "--r-values", "4",
                     "8", "--device", "cpu", "--trials", "1", "--kernel", "torch"]) == 0
    assert [r["R"] for r in RunStore(root).index()] == [8, 4, 8]
    capsys.readouterr()


def test_env_knob_vetoes_and_relocates_the_default_root(tmp_path, monkeypatch, capsys):
    """Unset: the default root (here a canary). ``0``/``off``: nothing. A
    path: that root. A store a caller enabled wins, and stays enabled."""
    canary = tmp_path / "default_root"
    monkeypatch.setattr(store, "DEFAULT_ROOT", canary)
    base = ["er", "5", "4", "15d_fusion2", "8", "1", "--device", "cpu", "--trials", "1",
            "--kernel", "torch"]
    for veto in ("0", "off", "no"):
        monkeypatch.setenv("SDDMM_TORCH_RUNSTORE", veto)
        assert cli.main(base) == 0
    assert not canary.exists()
    monkeypatch.delenv("SDDMM_TORCH_RUNSTORE")
    assert cli.main(base) == 0
    assert len(RunStore(canary).index()) == 1
    monkeypatch.setenv("SDDMM_TORCH_RUNSTORE", str(tmp_path / "elsewhere"))
    assert cli.main(base) == 0
    assert len(RunStore(tmp_path / "elsewhere").index()) == 1
    assert len(RunStore(canary).index()) == 1
    mine = store.enable(tmp_path / "mine")
    assert cli.main(base) == 0 and store.active() is mine
    assert len(RunStore(tmp_path / "mine").index()) == 1
    assert cli.main([*base, "--no-runstore"]) == 0 and store.active() is mine
    assert len(RunStore(tmp_path / "mine").index()) == 1
    store.disable()
    # The library default: off unless the environment names a store.
    monkeypatch.setattr(store, "_env_checked", False)
    monkeypatch.delenv("SDDMM_TORCH_RUNSTORE")
    S = HostCOO.rmat(5, 4, seed=0)
    harness.benchmark_algorithm(S, "15d_fusion2", None, True, R=8, trials=1, device="cpu")
    assert len(RunStore(canary).index()) == 1
    capsys.readouterr()


def test_slice_index_rows_equal_the_jax_clis(tmp_path, monkeypatch, capsys):
    """One ``er`` through both CLIs at p = 8 on the same R-mat, each into
    its own store: the same index fields, the same values but
    ``BY_DESIGN`` (the timings only positive)."""
    from distributed_sddmm_tpu.bench import cli as jax_cli
    from distributed_sddmm_tpu.programs import store as jax_programs

    argv = ["er", "6", "4", "15d_fusion2", "8", "2", "--trials", "2"]
    monkeypatch.setenv("DSDDMM_RUNSTORE", str(tmp_path / "jax"))
    monkeypatch.setenv("DSDDMM_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.setenv("DSDDMM_PROGRAMS", "0")
    monkeypatch.setattr(jax_programs, "_active", None)
    monkeypatch.setattr(jax_programs, "_env_checked", False)
    assert jax_cli.main([*argv, "--kernel", "xla"]) == 0
    monkeypatch.setenv("SDDMM_TORCH_RUNSTORE", str(tmp_path / "port"))
    monkeypatch.setenv("SDDMM_TORCH_LOCAL_RANKS", "8")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli.main([*argv, "--device", "cpu"]) == 0
    capsys.readouterr()
    (want,), (got,) = jax_store.RunStore(tmp_path / "jax").index(), RunStore(
        tmp_path / "port").index()
    assert set(got) == set(want) == set(store._INDEX_FIELDS)
    assert {k: v for k, v in got.items() if k not in BY_DESIGN} == {
        k: v for k, v in want.items() if k not in BY_DESIGN}
    assert got["comm_bytes"] > 0 and got["c"] == 2 and got["wire"] == "f32"
    assert (got["kernel"], want["kernel"]) == ("cuda-f32", "xla")
    assert (got["backend"], want["backend"]) == ("cpu:local", "cpu")
    assert got["key"] != want["key"] and got["elapsed"] > 0 and got["overall_throughput"] > 0
    # The record's program-store and dynamic-structure sections fill them.
    assert (got["live_compiles"], got["dynstruct_rebinds"]) == (0, 0) == (
        want["live_compiles"], want["dynstruct_rebinds"])
    # Both packages' documents in one directory: the port's gate of the port
    # run finds the JAX run of the same problem in no baseline.
    mixed = RunStore(tmp_path / "port")
    mixed.ingest_prebuilt(jax_store.RunStore(tmp_path / "jax").get(want["run_id"]))
    port_doc = mixed.get(got["run_id"])
    assert mixed.matching(port_doc) == []
    assert regress.gate(mixed, port_doc)[0] == regress.GATE_NO_DATA == 3
    assert jax_regress.gate(jax_store.RunStore(tmp_path / "port"), port_doc)[0] == 3


def test_jax_and_port_docs_of_one_problem_never_pool(tmp_path):
    """Records of one problem and configuration, one from each package, in
    one directory: ``gate`` of either exits 3, in both packages."""
    rec = _record(kernel="xla")
    jax_doc = jax_store.build_run_doc(dict(rec, run_id="jax-run"))
    port_doc = store.build_run_doc(dict(rec, run_id="port-run"))
    RunStore(tmp_path).put(jax_doc)
    RunStore(tmp_path).put(port_doc)
    for doc in (jax_doc, port_doc):
        assert regress.gate(RunStore(tmp_path), doc)[0] == 3
        assert jax_regress.gate(jax_store.RunStore(tmp_path), doc)[0] == 3
    # The same record twice from the port does pool.
    RunStore(tmp_path).put(store.build_run_doc(dict(rec, run_id="port-run-2")))
    assert regress.gate(RunStore(tmp_path), port_doc)[0] == 0


def test_backfilled_tpu_rounds_never_enter_a_card_baseline(tmp_path, monkeypatch):
    """Backfilled rounds list in ``history`` with their own backend and no
    key; a card run of the headline problem (R-mat 2^16, 32 a row, R 128)
    gates with no baseline. Unlike the JAX backfill, the port's gives no
    backfilled round a key at all."""
    s = RunStore(tmp_path)
    docs = store.backfill_historical(s, root=ROOT)
    want = jax_store.backfill_historical(jax_store.RunStore(tmp_path / "jax"), root=ROOT)
    assert [d["run_id"] for d in docs] == [d["run_id"] for d in want]
    for ours, theirs in zip(docs, want):
        assert ours["record"] == theirs["record"] and ours["backend"] == theirs["backend"]
        assert ours["created_epoch"] == theirs["created_epoch"] and ours["key"] is None
    assert {d["backend"] for d in docs} >= {"tpu"}
    monkeypatch.setattr(store, "_live_backend", lambda: CARD)
    M = 1 << 16
    card = s.ingest_record(_record(run_id="card", R=128, p=1,
                                   alg_info={"m": M, "n": M, "nnz": 32 * M, "p": 1}))
    assert card["backend"] == CARD and card["key"]
    assert s.matching(card) == [] and regress.gate(s, card)[0] == 3
    assert s.resolve("latest")["run_id"] == "card"
    assert len(s.history()) == len(docs) + 1
    # Idempotent.
    assert len(store.backfill_historical(s, root=ROOT)) == len(docs)
    assert len(s.index()) == len(docs) + 1


def test_corrupt_index_is_rebuilt_on_read(tmp_path):
    s = RunStore(tmp_path)
    for i in range(3):
        s.put(_doc(f"r{i}"))
    s.index_path.write_text("{not json")
    assert [r["run_id"] for r in s.index()] == ["r0", "r1", "r2"]
    assert json.loads(s.index_path.read_text())[0]["run_id"] == "r0"
    s.index_path.write_text("[1, 2")
    s.put(_doc("r3"))  # a put over a torn index keeps the other rows
    assert [r["run_id"] for r in s.index()] == ["r0", "r1", "r2", "r3"]
    (s.runs_dir / "r1.json").write_text("{torn")
    assert [r["run_id"] for r in s.rebuild_index()] == ["r0", "r2", "r3"]


def test_two_processes_ingesting_keep_both_rows(tmp_path):
    """The flock: two processes, 25 ingests each, started together."""
    code = (
        "import sys\n"
        "from distributed_sddmm_tpu_torch.obs.store import RunStore\n"
        "s = RunStore(sys.argv[1])\n"
        "for i in range(25):\n"
        "    s.ingest_record({'run_id': f'{sys.argv[2]}-{i}', 'algorithm': 'a', 'R': 8,\n"
        "                     'alg_info': {'m': 8, 'n': 8, 'nnz': 8, 'p': 1}})\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), tag], cwd=ROOT,
                              env=env) for tag in ("p", "q")]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    ids = {r["run_id"] for r in RunStore(tmp_path).index()}
    assert ids == {f"{t}-{i}" for t in "pq" for i in range(25)}


def test_autotune_trials_leave_no_doc(tmp_path, monkeypatch):
    """``measure_candidates`` hides the active store: the trials (here the
    harness on the CPU) see no store and leave no document, and the store is
    back afterwards."""
    active = store.enable(tmp_path)
    S = HostCOO.rmat(5, 4, seed=0)
    seen = []

    def trial(S_, problem, cand, trials, warmup):
        seen.append(store.active())
        return harness.benchmark_algorithm(S_, cand.algorithm, None, True, R=problem.R,
                                           c=cand.c, trials=trials, warmup=warmup,
                                           device="cpu")

    cands = [Candidate("15d_fusion2", 1, "cuda-f32"), Candidate("15d_sparse", 1, "cuda-f32")]
    out = measure_candidates(S, Problem.from_coo(S, 8), cands, trial_fn=trial, device="cpu")
    assert len(out) == 2 and seen == [None, None]
    assert store.active() is active and active.index() == []
    harness.benchmark_algorithm(S, "15d_fusion2", None, True, R=8, trials=1, device="cpu")
    assert len(active.index()) == 1
    store.disable()


def test_a_failed_ingest_costs_the_history_not_the_run(tmp_path, monkeypatch, capsys):
    s = store.enable(tmp_path)

    def boom(record, source="bench"):
        raise OSError("disk full")

    monkeypatch.setattr(s, "ingest_record", boom)
    S = HostCOO.rmat(5, 4, seed=0)
    rec = harness.benchmark_algorithm(S, "15d_fusion2", None, True, R=8, trials=1,
                                      device="cpu")
    assert rec["overall_throughput"] > 0
    assert "run-store ingest failed" in capsys.readouterr().err
    store.disable()
