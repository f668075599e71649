"""The port's multi-process layer (``distributed_sddmm_tpu_torch/dist/``)
against the JAX package's ``dist/``: identity resolution, records, keys,
the runner's arguments, the pod grid pieces, and pods of gloo processes
on the CPU through ``python -m distributed_sddmm_tpu_torch.dist.run``.

The JAX package's ``dist/hlo.py`` gate scans compiled XLA for collectives
whose groups cross hosts. Its counterpart here is a check on the port's
own run: a 4-process gloo pod labelled as 2 hosts of 2 ranks
(``SDDMM_TORCH_DIST_RANKS_PER_HOST=2``) at (p, c) = (4, 1) and (4, 2),
where each worker's record names the axes that cross hosts
(``process_spans``) and counts the collectives on each axis, and how many
ran over a group spanning both hosts (``comm.axis_counts``); then the
same pod twice over one program store, the second run warm on every slot
(JAX ``tests/test_multihost_gate.py``'s warm start).
"""

import datetime
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

from distributed_sddmm_tpu.dist import init as jinit
from distributed_sddmm_tpu.dist import run as jrun
from distributed_sddmm_tpu.parallel import mesh as jmesh
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO
from distributed_sddmm_tpu_torch.dist import init as pinit
from distributed_sddmm_tpu_torch.dist import run as prun
from distributed_sddmm_tpu_torch.dist.elastic import free_port
from distributed_sddmm_tpu_torch.parallel import mesh as pmesh
from distributed_sddmm_tpu_torch.programs import keys as keys_mod
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: JAX's label -> the port's.
ENV = {"DSDDMM_DIST_COORDINATOR": "SDDMM_TORCH_DIST_COORDINATOR",
       "DSDDMM_DIST_NPROCS": "SDDMM_TORCH_DIST_NPROCS",
       "DSDDMM_DIST_PROC_ID": "SDDMM_TORCH_DIST_PROC_ID"}


@pytest.fixture
def labels(monkeypatch):
    """Set one pod-label combination for both packages (None: unset)."""
    for k in (*ENV, *ENV.values(), "SDDMM_TORCH_DIST_RANKS_PER_HOST", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)

    def put(**values):
        for short, v in values.items():
            jax_name = f"DSDDMM_DIST_{short.upper()}"
            for name in (jax_name, ENV[jax_name]):
                if v is None:
                    monkeypatch.delenv(name, raising=False)
                else:
                    monkeypatch.setenv(name, v)
    return put


def _mapped(jax_kwargs: dict) -> dict:
    """JAX's ``jax.distributed.initialize`` kwargs as ``init_process_group``'s."""
    out = {}
    for k, v in jax_kwargs.items():
        if k == "coordinator_address":
            out["init_method"] = f"tcp://{v}"
        elif k == "num_processes":
            out["world_size"] = v
        elif k == "process_id":
            out["rank"] = v
        else:
            out["timeout"] = datetime.timedelta(seconds=v)
    return out


# ------------------------------------------------------------- identity

INIT_CASES = [
    ({}, ()),
    ({}, ("10.0.0.1:1234", 4, 2, 30)),
    ({}, ("h:1",)),
    ({"coordinator": "h:9", "nprocs": "3", "proc_id": "1"}, ()),
    ({"coordinator": "h:9", "nprocs": "3", "proc_id": "1"}, ("x:1", 2, 0)),
    ({"nprocs": "2"}, ()),
    ({}, (None, 2)),
    ({}, (None, None, 1)),
    ({"coordinator": ""}, ()),
]


@pytest.mark.parametrize("env,args", INIT_CASES)
def test_resolve_init_kwargs_matches_jax(labels, env, args):
    labels(**env)
    try:
        want = _mapped(jinit.resolve_init_kwargs(*args))
    except ValueError:
        with pytest.raises(ValueError, match="coordinator"):
            pinit.resolve_init_kwargs(*args)
        return
    assert pinit.resolve_init_kwargs(*args) == want


POD_CASES = [
    {},
    {"nprocs": "2", "proc_id": "1", "coordinator": "c:1"},
    {"nprocs": "1"},
    {"nprocs": "4"},
    {"nprocs": "4", "proc_id": ""},
    {"nprocs": "2", "proc_id": "2"},
    {"nprocs": "2", "proc_id": "-1"},
    {"coordinator": "c:7"},
    {"nprocs": "", "proc_id": "3"},
]


@pytest.mark.parametrize("env", POD_CASES)
def test_pod_info_matches_jax(labels, env):
    labels(**env)
    try:
        want = jinit.pod_info()
    except ValueError:
        with pytest.raises(ValueError, match="SDDMM_TORCH_DIST_(NPROCS|PROC_ID)"):
            pinit.pod_info()
        return
    got = pinit.pod_info()
    assert got.as_dict() == want.as_dict()
    assert got.record_fields() == want.record_fields()
    assert got.is_multi_host == want.is_multi_host


@pytest.mark.parametrize("ctx", [(1, 0, None), (2, 1, "c:1"), (4, 3, None)])
def test_record_fields_match_jax(ctx):
    assert pinit.PodContext(*ctx).record_fields() == jinit.PodContext(*ctx).record_fields()


def test_probe_trivially_true_in_one_process():
    assert pinit.cross_process_probe() == (True, None)


def test_initialize_over_gloo_at_world_size_one(labels, tmp_path):
    """``initialize`` opens a gloo group from a coordinator, is idempotent,
    exports the coordinator, and ``world_from_env`` then gives a
    ``DistWorld`` although no ``WORLD_SIZE`` is set."""
    import torch.distributed as dist

    from distributed_sddmm_tpu_torch.parallel.comm import DistWorld, world_from_env

    coord = f"127.0.0.1:{free_port()}"
    try:
        ctx = pinit.initialize(coord, 1, 0, device="cpu")
        assert ctx == pinit.PodContext(1, 0, coord)
        assert pinit.initialize(coord, 1, 0, device="cpu") == ctx
        assert os.environ["SDDMM_TORCH_DIST_COORDINATOR"] == coord
        assert "SDDMM_TORCH_DIST_NPROCS" not in os.environ
        assert pinit.pod_info().record_fields() == {
            "num_processes": 1, "process_index": 0, "coordinator": coord}
        assert isinstance(world_from_env("cpu"), DistWorld)
        assert pinit.cross_process_probe() == (True, None)
    finally:
        dist.destroy_process_group()
        os.environ.pop("SDDMM_TORCH_DIST_COORDINATOR", None)


# --------------------------------------------------------------- records


def _jax_record(S):
    from distributed_sddmm_tpu.bench.harness import benchmark_algorithm

    return benchmark_algorithm(S, "15d_fusion2", None, fused=True, R=8, c=1, trials=1,
                               warmup=0)


def _port_record(S):
    from distributed_sddmm_tpu_torch.bench.harness import benchmark_algorithm
    from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld

    return benchmark_algorithm(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), "15d_fusion2",
                               None, fused=True, R=8, c=1, trials=1, warmup=0,
                               device="cpu", world=LocalWorld(1))


@pytest.mark.parametrize("env", [{}, {"nprocs": "2", "proc_id": "1", "coordinator": "c:5"}])
def test_bench_record_identity_matches_jax(labels, monkeypatch, env):
    monkeypatch.setenv("DSDDMM_RUNSTORE", "0")
    monkeypatch.setenv("DSDDMM_PROGRAMS", "0")
    labels(**env)
    S = JaxCOO.erdos_renyi(32, 32, 2, seed=0)
    want, got = _jax_record(S), _port_record(S)
    keys = ("num_processes", "process_index", "coordinator")
    assert {k: got[k] for k in keys if k in got} == {k: want[k] for k in keys if k in want}
    if not env:
        assert "coordinator" not in got and "pod" not in got


def test_manifest_records_pod_identity(labels):
    from distributed_sddmm_tpu_torch.obs import manifest

    labels(nprocs="2", proc_id="1", coordinator="coord:77")
    m = manifest.build("run-x", device="cpu")
    assert (m["num_processes"], m["process_index"], m["coordinator"]) == (2, 1, "coord:77")
    assert m["env"]["SDDMM_TORCH_DIST_COORDINATOR"] == "coord:77"


def test_bound_strategy_keys_carry_pod_slot(labels, tmp_path):
    """A process labelled as slot 0 of a 2-process pod keys its store
    entries ``:d2.p0``; the same bind unlabelled writes single-process keys
    (JAX ``tests/test_dist.py:156``)."""
    from distributed_sddmm_tpu_torch.autotune.plan import Plan
    from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
    from distributed_sddmm_tpu_torch.programs import ProgramStore

    S = HostCOO(*(lambda s: (s.rows, s.cols, s.vals, s.M, s.N))(
        JaxCOO.erdos_renyi(48, 40, 4, seed=2, values="normal")))

    def bound_keys(root):
        store = ProgramStore(root)
        Plan("15d_fusion2", 2, kernel="cuda-f32", fingerprint_key="fpkey").instantiate(
            S, 8, world=LocalWorld(2), device="cpu", program_store=store)
        return [r["key"] for r in store.index()]

    labels(nprocs="2", proc_id="0")
    assert keys_mod.dist_segment() == "d2.p0"
    pod = bound_keys(tmp_path / "pod")
    assert pod and all(k.endswith(":d2.p0") for k in pod)
    labels(nprocs=None, proc_id=None)
    assert keys_mod.dist_segment() == ""
    solo = bound_keys(tmp_path / "solo")
    assert solo and all("num_processes" not in keys_mod.parse_plan_key(k) for k in solo)
    assert not set(pod) & set(solo)


# ---------------------------------------------------------------- runner


def test_dry_run_matches_jax(labels, capsys):
    argv = ["--dry-run", "er", "12", "4", "15d_fusion2", "8", "1"]
    assert prun.main(argv) == 0
    assert "dry-run ok: init_process_group({})" in capsys.readouterr().out
    assert jrun.main(argv) == 0
    argv = ["--dry-run", "--coordinator", "h:1", "--num-processes", "2", "--process-id", "1",
            "er", "12", "4", "15d_fusion2", "8", "1", "--device", "cpu"]
    assert prun.main(argv) == 0
    assert "'init_method': 'tcp://h:1', 'world_size': 2, 'rank': 1" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--dry-run", "--num-processes", "2", "er", "12", "4", "15d_fusion2", "8", "1"],
    ["--dry-run", "--process-id", "1", "er", "12", "4", "15d_fusion2", "8", "1"],
    ["--dry-run", "er", "12", "4", "no_such_alg_flag", "--bogus"],
])
def test_bad_combinations_exit_like_jax(labels, argv):
    with pytest.raises(SystemExit) as got:
        prun.main(argv)
    with pytest.raises(SystemExit) as want:
        jrun.main(argv)
    assert got.value.code == want.value.code != 0


def test_admin_port_injection_matches_jax(monkeypatch):
    cases = [(["serve", "--app", "als"], 2), (["serve", "--admin-port", "7"], 2),
             (["serve", "--admin-port=7"], 1), (["er", "12"], 2), (["serve"], 0)]
    for base in ("9100", None, "0"):
        for name, env in (("DSDDMM_POD_ADMIN_BASE", jrun), (prun.ADMIN_BASE_ENV, prun)):
            if base is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, base)
        for args, k in cases:
            assert prun._inject_admin_port(list(args), k) == jrun._inject_admin_port(
                list(args), k)
    monkeypatch.setenv(prun.ADMIN_BASE_ENV, "9100")
    assert prun._inject_admin_port(["serve", "--app", "als"], 2) == [
        "serve", "--app", "als", "--admin-port", "9102"]


# ------------------------------------------------------------- pod grid


def _jax_spans(grid, hosts):
    """JAX ``process_spans`` over a stand-in mesh whose device at each
    coordinate reports its host (JAX ``make_grid``'s placement)."""
    devs = np.empty(grid.dims, dtype=object)
    for i, j, k in grid.coords():
        devs[i, j, k] = types.SimpleNamespace(process_index=hosts[grid.flat_rank(i, j, k)])
    return jmesh.process_spans(jmesh.GridSpec(mesh=types.SimpleNamespace(devices=devs),
                                              nr=grid.nr, nc=grid.nc, nh=grid.nh,
                                              adjacency=grid.adjacency))


@pytest.mark.parametrize("dims", [(4, 1, 1), (2, 2, 1), (4, 2, 1), (2, 2, 2), (1, 4, 2)])
@pytest.mark.parametrize("adjacency", [1, 3, 6])
@pytest.mark.parametrize("per_host", [1, 2, 4])
def test_process_spans_match_jax(monkeypatch, dims, adjacency, per_host):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setenv(pmesh.RANKS_PER_HOST_ENV, str(per_host))
    grid = pmesh.make_pod_grid(*dims, adjacency=adjacency)
    hosts = pmesh.rank_hosts(grid.p)
    assert hosts == tuple(r // per_host for r in range(grid.p))
    assert pmesh.process_spans(grid) == _jax_spans(grid, hosts)


def test_pod_grid_on_one_host(monkeypatch):
    for k in ("LOCAL_WORLD_SIZE", pmesh.RANKS_PER_HOST_ENV):
        monkeypatch.delenv(k, raising=False)
    g = pmesh.make_pod_grid(4, 2, 1, adjacency=1)
    assert g == pmesh.make_grid(4, 2, 1, adjacency=1)
    assert pmesh.process_spans(g) == {"rows": False, "cols": False, "layers": False}
    order = pmesh.pod_device_order(8)
    assert [(s.host, s.rank) for s in order] == sorted((s.host, s.rank) for s in order)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv(pmesh.RANKS_PER_HOST_ENV, "4")
    assert [s.host for s in pmesh.pod_device_order(4)] == [0, 0, 1, 1]


# ------------------------------------------------------------------ pods


def _pod_env(tmp_path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "DSDDMM_", "SDDMM_TORCH_DIST_"))
           and k not in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(ROOT), SDDMM_TORCH_RUNSTORE="0", SDDMM_TORCH_PROGRAMS="0",
               SDDMM_TORCH_PLAN_CACHE=str(tmp_path / "plans"), CUDA_VISIBLE_DEVICES="")
    env.update(extra)
    return env


def _run_pod(n: int, bench: list, env: dict, out: pathlib.Path) -> list:
    """``n`` processes of ``dist.run`` over one coordinator, each appending
    its record to its own file; returns ``(stdout, stderr, record)`` a
    worker."""
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_sddmm_tpu_torch.dist.run", "--coordinator", coord,
         "--num-processes", str(n), "--process-id", str(k), *bench,
         "-o", str(out / f"rec{k}.jsonl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(n)]
    res = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=240)
            assert p.returncode == 0, e[-3000:]
            res.append((o, e))
    finally:
        for p in procs:
            p.kill()
    return [(o, e, json.loads((out / f"rec{k}.jsonl").read_text().splitlines()[-1]))
            for k, (o, e) in enumerate(res)]


def test_two_process_gloo_pod_through_the_runner(tmp_path):
    """Two gloo processes: each record carries its slot and the
    coordinator, the probe passes, and worker 0 merges both trace shards."""
    from distributed_sddmm_tpu_torch.obs import tracemerge

    trace = tmp_path / "pod.jsonl"
    env = _pod_env(tmp_path, SDDMM_TORCH_TRACE=str(trace))
    res = _run_pod(2, ["er", "10", "8", "15d_fusion2", "16", "1", "--device", "cpu"], env,
                   tmp_path)
    recs = [r for _, _, r in res]
    assert [(r["num_processes"], r["process_index"]) for r in recs] == [(2, 0), (2, 1)]
    assert len({r["coordinator"] for r in recs}) == 1
    assert "pod up: 2 processes over gloo, probe ok" in res[0][0]
    assert "pod trace merged:" in res[0][0] and "(2 shards)" in res[0][0]
    shards = [f for f in tracemerge.discover(tmp_path / "pod.shards")]
    assert len(shards) == 2
    merged = [f for f in (tmp_path / "pod.shards").glob("merged-*.jsonl")]
    assert len(merged) == 1
    assert {r["pod"]["process_spans"]["rows"] for r in recs} == {False}


def _crosses(label: str, spans: dict) -> bool:
    return any(spans[a] for a in label.split("+"))


@pytest.mark.parametrize("c,crossing", [(1, "rows"), (2, "cols")])
def test_four_process_two_host_pod_crosses_hosts_on_the_named_axes(tmp_path, c, crossing):
    """2 hosts of 2 ranks: ``process_spans`` names the one axis whose
    groups span both hosts, and every collective on that axis (and only
    there) ran over a group spanning both."""
    env = _pod_env(tmp_path, SDDMM_TORCH_DIST_RANKS_PER_HOST="2")
    res = _run_pod(4, ["er", "10", "8", "15d_fusion2", "16", str(c), "--device", "cpu"], env,
                   tmp_path)
    want = pmesh.process_spans(pmesh.make_grid(4 // c, c, 1, adjacency=1), (0, 0, 1, 1))
    assert want == {"rows": crossing == "rows", "cols": crossing == "cols", "layers": False}
    for k, (_o, _e, rec) in enumerate(res):
        pod = rec["pod"]
        assert (rec["num_processes"], rec["process_index"]) == (4, k)
        assert pod["ranks_per_host"] == 2 and pod["process_spans"] == want
        assert pod["collectives"][crossing], pod
        for label, kinds in pod["collectives"].items():
            for kind, n in kinds.items():
                assert n["count"] > 0
                assert n["cross_host"] == (n["count"] if _crosses(label, want) else 0), (
                    label, kind, n)


def test_four_process_pod_warm_starts_every_slot(tmp_path):
    """The same ``auto`` pod twice over one program store: the first run
    builds each slot's set-up under its own ``:d4.pK`` key, the second
    loads each (a hit a slot, ``live_compiles`` 0) for the same plan."""
    store = tmp_path / "programs"
    env = _pod_env(tmp_path, SDDMM_TORCH_DIST_RANKS_PER_HOST="2",
                   SDDMM_TORCH_PROGRAMS=str(store))
    bench = ["er", "10", "8", "auto", "16", "1", "--device", "cpu", "--kernel", "cuda-f32",
             "--plan-mode", "model"]
    (tmp_path / "cold").mkdir()
    (tmp_path / "warm").mkdir()
    cold = [r for _, _, r in _run_pod(4, bench, env, tmp_path / "cold")]
    warm = [r for _, _, r in _run_pod(4, bench, env, tmp_path / "warm")]
    for k, (a, b) in enumerate(zip(cold, warm)):
        assert a["program_store"]["live_compiles"] > 0 and a["program_store"][
            "program_store_hits"] == 0
        assert b["program_store"]["live_compiles"] == 0, b["program_store"]
        assert b["program_store"]["program_store_hits"] >= 1
        assert (b["algorithm"], b["c"], b["process_index"]) == (a["algorithm"], a["c"], k)
    from distributed_sddmm_tpu_torch.programs import ProgramStore

    keys = [r["key"] for r in ProgramStore(store).index()]
    assert sorted(k.rsplit(":", 1)[1] for k in keys) == [f"d4.p{k}" for k in range(4)]
