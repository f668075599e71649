"""The port's program store (``programs/``) against the JAX package's, on
the same inputs.

* Keys: every builder and parser of ``programs/keys.py`` gives the JAX
  string character for character (the capacity, wire, variant, params,
  signature and process segments included), and ``matrix_content_key``
  the JAX digest of the same matrix.
* The store: a strategy's set-up saved and loaded back gives the same
  outputs bit for bit; each kind of bad entry (truncated, garbled,
  another schema, a foreign key, another backend, a set-up the build
  refuses) reads as a miss, is evicted and is rebuilt; the index is
  rebuilt when corrupt or missing; two processes race on one store; the
  ``write:`` fault hook applies; the counters and trace events; the
  ``SDDMM_TORCH_PROGRAMS`` grammar.
* Binding: ``Plan.instantiate`` looks the set-up up before building it
  and binds the strategy; a warm second process of ``er ... auto``
  reports ``live_compiles == 0`` and the same outputs; a spilled rebind
  of a bound strategy builds its replacement through the store.

The JAX store's own round-trip and warm-start tests are not used as
oracles here: they fail on this machine.
"""

import json
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_sddmm_tpu.programs import keys as jax_keys
from distributed_sddmm_tpu.programs import store as jax_store
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch import dynstruct, programs
from distributed_sddmm_tpu_torch.autotune.fingerprint import models_code_hash
from distributed_sddmm_tpu_torch.autotune.plan import Plan
from distributed_sddmm_tpu_torch.obs import metrics, trace
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.programs import keys
from distributed_sddmm_tpu_torch.programs import store as store_mod
from distributed_sddmm_tpu_torch.programs.store import ProgramStore
from distributed_sddmm_tpu_torch.resilience import faults
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

from _torch_strategy_cases import run_ops

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKEND = "cpu:local"
COUNTERS = ("program_store_hits", "program_store_misses", "live_compiles")


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """No active store or tracer, the environment unread, no fault plan."""
    monkeypatch.setattr(store_mod, "_active", None)
    monkeypatch.setattr(store_mod, "_env_checked", True)
    trace.disable()
    faults.clear()
    yield
    trace.disable()
    faults.clear()


def _counts() -> dict:
    return {k: metrics.GLOBAL.get(k) for k in COUNTERS}


def _delta(before: dict) -> dict:
    return {k: metrics.GLOBAL.get(k) - v for k, v in before.items()}


def _matrix(seed=0, M=64, N=48):
    return HostCOO(*(lambda S: (S.rows, S.cols, S.vals, S.M, S.N))(
        JaxCOO.erdos_renyi(M, N, 4, seed=seed, values="normal")))


def _plan(alg="15d_fusion2", c=2, variant=None, key="fp0123456789abcd"):
    return Plan(alg, c, kernel="cuda-f32", variant=variant, fingerprint_key=key)


def _instantiate(plan, S, store):
    return plan.instantiate(S, 8, world=LocalWorld(8), device="cpu", program_store=store)


def _ints(S, seed=1, R=8):
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, (S.M, R)).astype(np.float32),
            rng.integers(-3, 4, (S.N, R)).astype(np.float32),
            rng.integers(-2, 3, S.nnz).astype(np.float32))


def _assert_same(got: dict, want: dict) -> None:
    for op in want:
        np.testing.assert_array_equal(got[op], want[op], err_msg=op)


# --------------------------------------------------------------------- #
# Keys
# --------------------------------------------------------------------- #

PLAN_CASES = [
    ("fp", "DenseShift15D-c1-cuda-f32-setup-xabc", "sig0", "cpu", "code0", None),
    ("f" * 16, "op with spaces:and:colons", "s", "cuda:NVIDIA H100 80GB HBM3:local", "c", None),
    ("fp", "op", "sig", "tpu", "deadbeefcafe", "d4.p3"),
    ("fp", "op", "sig", "cpu", "c", "d1.p0"),
]


@pytest.mark.parametrize("args", PLAN_CASES)
def test_plan_key_equals_jax(args):
    fp, op, sig, backend, code, dist = args
    got = keys.plan_program_key(fp, op, sig, backend, code=code, dist=dist)
    assert got == jax_keys.plan_program_key(fp, op, sig, backend, code=code, dist=dist)
    assert keys.parse_plan_key(got) == jax_keys.parse_plan_key(got)
    assert keys.parse_key(got) == jax_keys.parse_key(got)
    assert keys.safe_stem(got) == jax_keys.safe_stem(got)


SERVE_CASES = [
    {},
    {"params": "k8.l0.1", "sig": "abc"},
    {"variant": "v1.rb8.rm"},
    {"wire": "f32"},
    {"wire": "bf16", "cap": "w4.n128", "dist": "d2.p1"},
    {"params": "p", "sig": "s", "variant": "v", "wire": "bf16.reduce=f32", "cap": "c1",
     "dist": "d8.p7"},
]


@pytest.mark.parametrize("extra", SERVE_CASES)
def test_serve_key_equals_jax(extra):
    args = ("als", 4, 16, 64, "cpu")
    got = keys.serve_program_key(*args, code="c0ffee", **extra)
    assert got == jax_keys.serve_program_key(*args, code="c0ffee", **extra)
    assert keys.parse_serve_key(got) == jax_keys.parse_serve_key(got)
    assert keys.parse_key(got) == jax_keys.parse_key(got)
    if extra.get("cap"):
        assert keys.parse_serve_key(got)["cap"] == extra["cap"]


def test_parsers_and_segments_equal_jax():
    bench = "bench:distgap_16_32_128_t5_abc:fused:20:tpu"
    for key in (bench, "bench:a:b:x:tpu", "plan:a:b", "serve:x:b1:i2:r3:cpu:c:zz",
                "nonsense", "plan:a:b:c:d:e:notdist"):
        assert keys.parse_key(key) == jax_keys.parse_key(key)
        assert keys.parse_bench_key(key) == jax_keys.parse_bench_key(key)
    for n, k in ((1, 0), (4, 2), (16, 15)):
        assert keys.dist_segment(n, k) == jax_keys.dist_segment(n, k)
    with pytest.raises(ValueError) as got:
        keys.dist_segment(4, None)
    with pytest.raises(ValueError) as want:
        jax_keys.dist_segment(4, None)
    assert str(got.value) == str(want.value)
    for seg in ("d4.p2", "d4", "x", "d1.p0"):
        assert keys.parse_dist_segment(seg) == jax_keys.parse_dist_segment(seg)
    # The port reads the process segment off its world.
    assert keys.dist_segment(world=LocalWorld(8)) == "" == keys.dist_segment()
    arrays = [np.zeros((3, 4), np.float32), np.ones(5, np.int64), np.zeros((2, 2))]
    assert keys.sig_for_args(arrays) == jax_keys.sig_for_args(arrays)
    assert keys.sig_for_args(arrays[:2]) != keys.sig_for_args(arrays[1:])


def test_package_exports_the_jax_names():
    """``programs`` exports the JAX package's names but the ones left out
    by design (the bench AOT key, the per-call wrapper of an executable,
    the XLA cost log), plus the port's set-up binding."""
    import distributed_sddmm_tpu.programs as jax_programs

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(mod))}

    left_out = {"bench_aot_key", "StoredProgram", "stored", "cost_log_len",
                "xla_cost_summary"}
    port_only = {"SetupConfig", "build_bound", "dist_segment", "parse_dist_segment"}
    assert public(programs) == (public(jax_programs) - left_out) | port_only


def test_matrix_content_key_equals_jax():
    S_j = JaxCOO.erdos_renyi(64, 48, 4, seed=3, values="normal")
    S = HostCOO(S_j.rows, S_j.cols, S_j.vals, S_j.M, S_j.N)
    assert store_mod.matrix_content_key(S) == jax_store.matrix_content_key(S_j)
    other = HostCOO(S.rows, S.cols, S.vals + 1.0, S.M, S.N)
    assert store_mod.matrix_content_key(other) != store_mod.matrix_content_key(S)
    assert len(models_code_hash()) == 12


# --------------------------------------------------------------------- #
# The store
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("alg,variant", [("15d_fusion2", None), ("15d_fusion2", "v1.rb4.rs"),
                                         ("15d_sparse", None),
                                         ("25d_dense_replicate", "v1.rb4.rs"),
                                         ("25d_sparse_replicate", None)])
def test_save_load_roundtrip(tmp_path, alg, variant):
    """A plan's strategy built cold (a miss, a live build, one entry), then
    again from the entry (a hit, no build): the same tiles, and every op
    equal bit for bit on integer data."""
    store, S, plan = ProgramStore(tmp_path), _matrix(), _plan(alg, variant=variant)
    before = _counts()
    cold = _instantiate(plan, S, store)
    assert _delta(before) == {"program_store_hits": 0, "program_store_misses": 1,
                              "live_compiles": 1}
    (row,) = store.index()
    assert row["bytes"] > 0 and row["meta"]["content"] == store_mod.matrix_content_key(S)
    assert row["backend"] == BACKEND
    before = _counts()
    warm = _instantiate(plan, S, store)
    assert _delta(before) == {"program_store_hits": 1, "program_store_misses": 0,
                              "live_compiles": 0}
    assert warm.kernel_variant_realized == cold.kernel_variant_realized
    for name in cold.SETUP_TILE_SETS:
        a, b = getattr(cold, name), getattr(warm, name)
        for f in ("rows", "cols", "mask", "row_ptr"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
        np.testing.assert_array_equal(a.host_to_flat, b.host_to_flat)
    ints = _ints(S)
    _assert_same(run_ops(warm, *ints), run_ops(cold, *ints))
    assert warm._program_store_meta["config"] == store_mod.strategy_config_tag(warm)


def _write_other_backend(store, key):
    entry = torch.load(store.path(key), weights_only=True)
    entry["backend"] = "cuda:Another:local"
    torch.save(entry, store.path(key))


def _write_foreign_key(store, key):
    entry = torch.load(store.path(key), weights_only=True)
    entry["key"] = key + "x"
    torch.save(entry, store.path(key))


def _write_old_schema(store, key):
    entry = torch.load(store.path(key), weights_only=True)
    entry["schema"] = store_mod.SCHEMA_VERSION + 1
    torch.save(entry, store.path(key))


def _write_refused(store, key):
    entry = torch.load(store.path(key), weights_only=True)
    entry["payload"]["S_tiles"]["nnz"] += 1
    torch.save(entry, store.path(key))


BAD_ENTRIES = {
    "truncated": lambda store, key: store.path(key).write_bytes(
        store.path(key).read_bytes()[:200]),
    "garbled": lambda store, key: store.path(key).write_bytes(b"not a torch file" * 40),
    "schema": _write_old_schema,
    "foreign_key": _write_foreign_key,
    "wrong_backend": _write_other_backend,
    "refused": _write_refused,
}


@pytest.mark.parametrize("kind", sorted(BAD_ENTRIES))
def test_bad_entry_is_a_miss_evicted_and_rebuilt(tmp_path, kind):
    store, S, plan = ProgramStore(tmp_path), _matrix(), _plan()
    cold = _instantiate(plan, S, store)
    (row,) = store.index()
    BAD_ENTRIES[kind](store, row["key"])
    before = _counts()
    rebuilt = _instantiate(plan, S, store)
    assert _delta(before) == {"program_store_hits": 0, "program_store_misses": 1,
                              "live_compiles": 1}
    # Evicted and written anew: the next process hits again.
    (again,) = store.index()
    assert again["key"] == row["key"] and again["bytes"] == row["bytes"]
    assert store._read_entry_file(store.path(row["key"]))["backend"] == BACKEND
    ints = _ints(S)
    _assert_same(run_ops(rebuilt, *ints), run_ops(cold, *ints))
    before = _counts()
    _instantiate(plan, S, store)
    assert _delta(before)["program_store_hits"] == 1


def test_absent_key_is_a_miss_without_droppings(tmp_path):
    store = ProgramStore(tmp_path)
    assert store.load("plan:a:b:c:d:e") is None
    assert store.misses == 1 and not (tmp_path / "entries").exists()


@pytest.mark.parametrize("how", ["corrupt", "missing", "not_a_list"])
def test_index_is_rebuilt_when_corrupt_or_missing(tmp_path, how):
    store = ProgramStore(tmp_path)
    for seed in (0, 1):
        _instantiate(_plan(), _matrix(seed), store)
    want = store.index()
    assert len(want) == 2
    if how == "missing":
        store.index_path.unlink()
    else:
        store.index_path.write_text("{torn" if how == "corrupt" else '{"a": 1}')
    assert [r["key"] for r in store.index()] == [r["key"] for r in want]
    assert json.loads(store.index_path.read_text()) == want


def _race_worker(root, seed, q):
    os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
    store = ProgramStore(root)
    S = _matrix(seed % 3)
    for _ in range(3):
        _instantiate(_plan(), S, store)
    q.put(store.stats())


def test_two_processes_race_on_one_store(tmp_path):
    """Two processes building and loading the same three matrices at once:
    neither fails, the index ends with every entry once, and every entry
    loads."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_race_worker, args=(str(tmp_path), s, q)) for s in (0, 1, 2, 3)]
    for p in procs:
        p.start()
    stats = [q.get(timeout=240) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    store = ProgramStore(tmp_path)
    rows = store.index()
    assert len(rows) == len({r["key"] for r in rows}) == 3
    assert all(store._read_entry_file(store.path(r["key"])) is not None for r in rows)
    assert sum(s["hits"] + s["live_compiles"] for s in stats) == 12


def test_write_fault_hook_applies(tmp_path):
    """A ``write:`` fault cuts the entry as it lands: the next build reads
    the cut file as a miss, evicts it and writes it whole."""
    store, S, plan = ProgramStore(tmp_path), _matrix(), _plan()
    cold = _instantiate(plan, S, store)
    (row,) = store.index()
    key_stem = store.path(row["key"]).name
    store.evict(row["key"])
    faults.install(faults.FaultPlan([faults.FaultSpec(f"write:{key_stem}", "truncate",
                                                       at=(0,), param=0.5)]))
    try:
        _instantiate(plan, S, store)
        fired = list(faults.active().events)
    finally:
        faults.clear()
    assert [(site, kind) for site, kind, _ in fired] == [(f"write:{key_stem}", "truncate")]
    assert store._read_entry_file(store.path(row["key"])) is None
    before = _counts()
    rebuilt = _instantiate(plan, S, store)
    assert _delta(before) == {"program_store_hits": 0, "program_store_misses": 1,
                              "live_compiles": 1}
    ints = _ints(S)
    _assert_same(run_ops(rebuilt, *ints), run_ops(cold, *ints))


def test_counters_and_trace_events(tmp_path):
    store, S, plan = ProgramStore(tmp_path), _matrix(), _plan()
    path = tmp_path / "t.jsonl"
    trace.enable(str(path))
    try:
        _instantiate(plan, S, store)
        _instantiate(plan, S, store)
    finally:
        trace.disable()
    from distributed_sddmm_tpu_torch.tools import tracereport

    events = [e for e in tracereport.load_trace(path)["events"]
              if e["name"].startswith("program_store")]
    (key,) = [r["key"] for r in store.index()]
    assert [e["name"] for e in events] == ["program_store_compile", "program_store_hit"]
    assert all(e["attrs"]["key"] == key for e in events)
    assert events[0]["attrs"]["compile_s"] > 0 and events[1]["attrs"]["load_s"] > 0
    assert store.stats() == {"hits": 1, "misses": 1, "live_compiles": 1}
    summary = tracereport.aggregate(tracereport.load_trace(path))["program_store"]
    assert (summary["disk_hits"], summary["live_compiles"]) == (1, 1)


def test_env_grammar(tmp_path, monkeypatch):
    """``SDDMM_TORCH_PROGRAMS``: unset selects the default root, ``0``/``off``
    disables, a path relocates; ``enable`` wins, ``disable`` turns off."""
    for spec, want in ((None, store_mod.DEFAULT_ROOT), ("0", None), ("off", None),
                       ("1", store_mod.DEFAULT_ROOT), (str(tmp_path / "s"), tmp_path / "s")):
        if spec is None:
            monkeypatch.delenv("SDDMM_TORCH_PROGRAMS", raising=False)
        else:
            monkeypatch.setenv("SDDMM_TORCH_PROGRAMS", spec)
        monkeypatch.setattr(store_mod, "_env_checked", False)
        monkeypatch.setattr(store_mod, "_active", None)
        got = store_mod.active()
        assert (got.root if got else None) == want, spec
    assert store_mod.DEFAULT_ROOT == ROOT / "artifacts" / "programs_torch"
    assert store_mod.enable(tmp_path / "e").root == tmp_path / "s"
    store_mod.disable()
    assert store_mod.active() is None
    assert store_mod.enable(tmp_path / "e").root == tmp_path / "e"


# --------------------------------------------------------------------- #
# Binding
# --------------------------------------------------------------------- #


def test_plan_instantiate_binds(tmp_path):
    """The store's binding: the config tag (class, c, family, realized
    variant, wire segment), the meta, and no binding without a store or a
    fingerprint; ``chained_program`` hands its function back."""
    store, S = ProgramStore(tmp_path), _matrix()
    alg = _instantiate(_plan(variant="v1.rb4.rs"), S, store)
    meta = alg._program_store_meta
    assert meta["store"] is store and meta["fingerprint_key"] == "fp0123456789abcd"
    assert meta["config"] == "DenseShift15D-c2-cuda-f32-v1.rb4.rs"
    assert meta["backend"] == BACKEND and meta["dist"] == ""
    assert meta["content"] == store_mod.matrix_content_key(S)
    assert alg._program_binder is not None
    bf16 = Plan("15d_sparse", 2, kernel="cuda-f32", wire="bf16", fingerprint_key="fp")
    assert _instantiate(bf16, S, store)._program_store_meta["config"] == (
        "SparseShift15D-c2-cuda-f32-wbf16")
    sparse = Plan("25d_sparse_replicate", 2, kernel="cuda-f32", variant="v1.rb4.rs",
                  fingerprint_key="fp")
    assert _instantiate(sparse, S, store)._program_store_meta["config"] == (
        "CannonSparse25D-c2-cuda-f32")
    assert not hasattr(_instantiate(_plan(key=""), S, store), "_program_store_meta")
    assert not hasattr(_instantiate(_plan(), S, None), "_program_store_meta")
    fn = object()
    assert store_mod.chained_program(alg, "cgStep", fn) is fn


def test_spilled_rebind_builds_through_the_store(tmp_path):
    """A bound dynamic-structure strategy that outgrows its row rung builds
    its replacement through the store (a live build, saved), bound again;
    the same spill in a later process loads it (a hit)."""
    store, S = ProgramStore(tmp_path), _matrix(M=60)
    kernel = CudaTileKernel("f32", device="cpu")

    def bound():
        alg = dynstruct.build("15d_fusion2", S, 8, 2, kernel=kernel, world=LocalWorld(8),
                              device="cpu")
        assert store_mod.bind_strategy(alg, "fpdyn", store=store)
        return alg

    grown = HostCOO(S.rows.copy(), S.cols.copy(), S.vals.copy(), S.M, S.N)
    grown.append_rows([[1, 2]] * 5, [[1.0, 2.0]] * 5)
    before = _counts()
    up = dynstruct.rebind(bound(), grown)
    assert up.spilled and _delta(before) == {"program_store_hits": 0,
                                             "program_store_misses": 1, "live_compiles": 1}
    assert up.alg._program_store_meta["fingerprint_key"] == "fpdyn"
    (row,) = store.index()
    assert "-cap=r128h1-" in row["key"]
    before = _counts()
    again = dynstruct.rebind(bound(), grown)
    assert _delta(before) == {"program_store_hits": 1, "program_store_misses": 0,
                              "live_compiles": 0}
    assert again.alg.S_tiles.dyn_cap == up.alg.S_tiles.dyn_cap
    assert again.alg._dynstruct.floors == up.alg._dynstruct.floors
    ints = _ints(grown)
    _assert_same(run_ops(again.alg, *ints), run_ops(up.alg, *ints))


def _er_auto(tmp_path, n: int) -> subprocess.CompletedProcess:
    env = {**os.environ, "SDDMM_TORCH_PROGRAMS": str(tmp_path / "store"),
           "SDDMM_TORCH_PLAN_CACHE": str(tmp_path / "plans"), "SDDMM_TORCH_RUNSTORE": "0",
           "SDDMM_TORCH_LOCAL_RANKS": "4", "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    env = {k: v for k, v in env.items() if not k.startswith(("JAX_", "XLA_"))}
    code = ("import sys, json\n"
            "from distributed_sddmm_tpu_torch.bench import cli, harness\n"
            "from distributed_sddmm_tpu_torch.utils import verify\n"
            "built = []\n"
            "real = harness.make_algorithm\n"
            "def keep(name, S, *a, **k):\n"
            "    alg = real(name, S, *a, **k); built.append((S, alg)); return alg\n"
            "harness.make_algorithm = keep\n"
            "rc = cli.main(sys.argv[1:])\n"
            "S, alg = built[-1]\n"
            "print(json.dumps(verify.fingerprint_algorithm(alg, S)))\n"
            "sys.exit(rc)\n")
    return subprocess.run(
        [sys.executable, "-c", code, "er", "6", "4", "auto", "8", "1", "--device", "cpu",
         "--kernel", "cuda-f32", "--trials", "1", "--warmup", "0",
         "-o", str(tmp_path / f"r{n}.jsonl")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def test_warm_second_process_has_no_live_build(tmp_path):
    """``er 6 4 auto ...`` twice in fresh processes over one store: the
    first record shows a live build and no hit, the second no live build
    and a hit, and the two strategies' verify fingerprints are equal."""
    runs = [_er_auto(tmp_path, n) for n in (1, 2)]
    for run in runs:
        assert run.returncode == 0, run.stderr[-3000:]
    recs = [json.loads((tmp_path / f"r{n}.jsonl").read_text()) for n in (1, 2)]
    assert recs[0]["program_store"] == {"program_store_hits": 0, "program_store_misses": 1,
                                        "live_compiles": 1}
    assert recs[1]["program_store"] == {"program_store_hits": 1, "program_store_misses": 0,
                                        "live_compiles": 0}
    assert recs[0]["dynstruct"] == recs[1]["dynstruct"] == {
        "dynstruct_rebinds": 0, "dynstruct_bucket_spills": 0, "structure_retraces": 0}
    fps = [json.loads(run.stdout.strip().splitlines()[-1]) for run in runs]
    assert fps[0] == fps[1]
    assert recs[0]["plan"] == recs[1]["plan"]


def test_setup_replay_refuses_another_build(tmp_path):
    """A stored set-up handed to another strategy's build raises
    ``SetupMismatch``: the store reads it as a refused entry."""
    from distributed_sddmm_tpu_torch.parallel.sharding import SetupMismatch

    S = _matrix()
    alg = DenseShift15D(S, R=8, c=2, world=LocalWorld(8), device="cpu",
                        kernel=CudaTileKernel("f32", device="cpu"))
    setup = alg.export_setup()
    with pytest.raises(SetupMismatch):
        DenseShift15D.from_setup(lambda: DenseShift15D(
            S, R=8, c=4, world=LocalWorld(8), device="cpu",
            kernel=CudaTileKernel("f32", device="cpu")), setup, "cpu")
    again = DenseShift15D.from_setup(lambda: DenseShift15D(
        S, R=8, c=2, world=LocalWorld(8), device="cpu",
        kernel=CudaTileKernel("f32", device="cpu")), setup, "cpu")
    ints = _ints(S)
    _assert_same(run_ops(again, *ints), run_ops(alg, *ints))
