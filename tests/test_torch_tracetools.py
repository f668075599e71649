"""The port's trace tools (``tools/tracereport.py``, ``obs/tracemerge.py``,
``obs/traceexport.py``), charts (``tools/charts.py``) and
``utils/atomic.py::atomic_write_lines`` against the JAX package's, on the
same files.

The traces: the JAX tests' synthetic ones (``tests/test_trace_export.py``'s
nested spans with tied timestamps, ``tests/test_trace_merge.py``'s shards
with skewed clock origins and its router and replica fleet shards), and
traces the port's CLI writes on the CPU (one run; two processes sharing one
``--trace`` file, the second rerouted into the shard directory). Each goes
through both packages:

* ``validate_record``, ``load_trace``, ``aggregate`` and ``render``: equal
  (no trace here has ``xla_flops``, the one column the port leaves out);
* ``merge``: the merged records equal, the merged id included;
* ``to_chrome``: the JSON equal but ``metadata.exporter``, which names the
  package;
* the charts: the same series data (the calls each package's chart
  functions make on a recording axes), not pixels. The kernel chart differs
  by design: the port's families are ``cuda-f32``, ``cuda-bf16``, ``torch``.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_trace_export import _synthetic_trace
from test_trace_merge import _replica_shard, _router_shard, _shard

from distributed_sddmm_tpu.bench import cli as jax_cli
from distributed_sddmm_tpu.obs import trace as jax_trace
from distributed_sddmm_tpu.obs import traceexport as jax_export
from distributed_sddmm_tpu.obs import tracemerge as jax_merge
from distributed_sddmm_tpu.tools import charts as jax_charts
from distributed_sddmm_tpu.tools import tracereport as jax_report

from distributed_sddmm_tpu_torch.bench import cli
from distributed_sddmm_tpu_torch.obs import trace, traceexport, tracemerge
from distributed_sddmm_tpu_torch.resilience import faults
from distributed_sddmm_tpu_torch.tools import charts, tracereport
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_lines

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _tracers_off(monkeypatch):
    for name in ("SDDMM_TORCH_TRACE", "DSDDMM_TRACE"):
        monkeypatch.delenv(name, raising=False)
    trace.disable()
    jax_trace.disable()
    yield
    trace.disable()
    jax_trace.disable()


def _skewed_shards(tmp_path):
    a = _shard(tmp_path / "s" / "a.jsonl", "ra", 1000.0, 11,
               spans=[("bench", 0.0, 2.0), ("fusedSpMM", 0.5, 1.0)],
               events=[("strategy", 0.1)])
    b = _shard(tmp_path / "s" / "b.jsonl", "rb", 1000.75, 22,
               spans=[("bench", 0.0, 1.0), ("fusedSpMM", 0.25, 0.5)],
               events=[("fault_fired", 0.3)])
    return [a, b]


def _fleet_shards(tmp_path):
    return [_router_shard(tmp_path / "f" / "rt.jsonl"),
            _replica_shard(tmp_path / "f" / "rp.jsonl")]


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    """Traces of the port's CLI on the CPU: ``one.jsonl`` from one run at
    p = 4, and ``P.jsonl`` shared by two processes, the second rerouted into
    ``P.shards/`` while the first (a process that stays alive) owns the
    file."""
    d = tmp_path_factory.mktemp("port_traces")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "SDDMM_TORCH_TRACE"))}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", SDDMM_TORCH_RUNSTORE="0",
               SDDMM_TORCH_LOCAL_RANKS="4")
    run = ["-m", "distributed_sddmm_tpu_torch.bench", "er", "6", "4", "15d_fusion2", "8",
           "2", "--device", "cpu", "--trials", "2", "--kernel", "torch", "--trace"]
    subprocess.run([sys.executable, *run, str(d / "one.jsonl")], cwd=ROOT, env=env,
                   check=True, capture_output=True, timeout=120)
    # The first process holds P.jsonl open (alive) while the second runs.
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import sys\n"
         "from distributed_sddmm_tpu_torch.bench import cli\n"
         f"cli.main([*{run[2:]!r}, {str(d / 'P.jsonl')!r}])\n"
         "print('ran', flush=True)\n"
         "sys.stdin.readline()\n"],
        cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        # "ran" comes after the run's summary line.
        assert any(line.strip() == "ran" for line in iter(holder.stdout.readline, ""))
        proc = subprocess.run([sys.executable, *run, str(d / "P.jsonl")], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    finally:
        try:
            holder.communicate("\n", timeout=60)
        finally:
            holder.kill()
    return d


def _load_both(path, strict=True):
    return tracereport.load_trace(path, strict=strict), jax_report.load_trace(path, strict=strict)


# ---------------------------------------------------------------- reader


BAD_RECORDS = [
    "not a dict", {"type": "nope"}, {"type": "span", "name": "x"},
    {"type": "begin", "schema": 2, "run_id": "r", "t0_epoch": 0.0},
    {"type": "span", "name": "x", "id": 1, "tid": 1, "t0": 2.0, "t1": 1.0, "dur_s": -1.0,
     "attrs": {}},
    {"type": "span", "name": "x", "id": 1, "tid": 1, "t0": 0.0, "t1": 1.0, "dur_s": 1.0,
     "attrs": []},
    {"type": "event", "name": "e", "id": 1, "tid": 1, "t": 0.0, "attrs": 3},
    {"type": "begin", "schema": 1, "run_id": "r", "t0_epoch": 0.0},
]


def test_validate_record_equals_jax():
    for rec in BAD_RECORDS:
        assert tracereport.validate_record(rec) == jax_report.validate_record(rec), rec


@pytest.mark.parametrize("which", ["synthetic", "merged-skewed", "merged-fleet", "port-one",
                                   "port-shared", "malformed"])
def test_aggregate_and_render_equal_jax(which, tmp_path, port_traces):
    strict = True
    if which == "synthetic":
        path = _synthetic_trace(tmp_path)
    elif which == "merged-skewed":
        path, _ = jax_merge.write_merged(_skewed_shards(tmp_path), tmp_path / "m.jsonl")
    elif which == "merged-fleet":
        path, _ = jax_merge.write_merged(_fleet_shards(tmp_path), tmp_path / "m.jsonl")
    elif which == "port-one":
        path = port_traces / "one.jsonl"
    elif which == "port-shared":
        path = port_traces / "P.jsonl"
    else:
        path = tmp_path / "mixed.jsonl"
        path.write_text((port_traces / "one.jsonl").read_text() + "not json\n{\"type\": 1}\n")
        strict = False
        with pytest.raises(ValueError):
            tracereport.load_trace(path, strict=True)
    got, want = _load_both(path, strict)
    assert got == want
    assert tracereport.aggregate(got) == jax_report.aggregate(want)
    assert tracereport.render(tracereport.aggregate(got)) == jax_report.render(
        jax_report.aggregate(want))
    chains = tracereport.request_chains(got), jax_report.request_chains(want)
    assert chains[0] == chains[1]
    assert tracereport.fleet_request_chains(got) == jax_report.fleet_request_chains(want)


def test_port_trace_aggregate_has_the_model_column(port_traces):
    agg = tracereport.aggregate(tracereport.load_trace(port_traces / "one.jsonl"))
    fused = agg["phases"]["fusedSpMM"]
    assert fused["calls"] == 3 and fused["comm_words"] > 0 and fused["flops"] > 0
    assert fused["model_words"] > 0 and fused["model_ratio"] is not None
    assert agg["strategy"]["p"] == 4 and agg["phases"]["bench"]["calls"] == 1


def test_report_trace_cli_exit_codes_equal_jax(tmp_path, port_traces, capsys):
    good = port_traces / "one.jsonl"
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "span", "name": "x"}\n')
    mixed = tmp_path / "mixed.jsonl"
    mixed.write_text(good.read_text() + "not json\n")
    for argv in ([str(good)], [str(good), "--json"], [str(bad)],
                 [str(tmp_path / "absent.jsonl")], [str(mixed)], [str(mixed), "--no-strict"]):
        got = cli.main(["report-trace", *argv])
        ours = capsys.readouterr()
        want = jax_cli.main(["report-trace", *argv])
        theirs = capsys.readouterr()
        assert got == want, argv
        if got == 0 and "--json" in argv:
            mine, jax_doc = json.loads(ours.out), json.loads(theirs.out)
            # The manifest lifts each package's own version fields.
            assert mine.pop("manifest")["torch_version"]
            jax_doc.pop("manifest")
            assert mine == jax_doc
        elif got == 0:
            assert ours.out == theirs.out


# ----------------------------------------------------------------- merge


@pytest.mark.parametrize("which", ["skewed", "fleet", "port-dir", "port-shared"])
def test_merge_equals_jax(which, tmp_path, port_traces):
    if which == "skewed":
        specs = _skewed_shards(tmp_path)
    elif which == "fleet":
        specs = _fleet_shards(tmp_path)
    elif which == "port-dir":
        d = tmp_path / "shards"
        d.mkdir()
        for i, name in enumerate(("one.jsonl", "P.jsonl")):
            (d / f"{i}.jsonl").write_text((port_traces / name).read_text())
        specs = [d]
    else:
        specs = [port_traces / "P.jsonl"]
    paths = [p for s in specs for p in tracemerge.discover(s)]
    assert paths == [p for s in specs for p in jax_merge.discover(s)]
    got, want = tracemerge.merge(paths), jax_merge.merge(paths)
    assert got == want and got["begin"]["run_id"].startswith("merged-")
    out, merged = tracemerge.write_merged(paths, tmp_path / "port-merged.jsonl")
    jax_out, _ = jax_merge.write_merged(paths, tmp_path / "jax-merged.jsonl")
    assert out.read_text() == jax_out.read_text()
    jax_report.load_trace(out, strict=True)
    if which == "port-shared":
        # Both processes' bench spans, one from the rerouted shard.
        assert len(paths) == 2 and paths[1].parent.name == "P.shards"
        assert len(merged["begin"]["shards"]) == 2
        assert sum(sp["name"] == "bench" for sp in merged["spans"]) == 2


def test_trace_merge_cli_equals_jax(tmp_path, port_traces, capsys):
    stem = port_traces / "P.jsonl"
    assert cli.main(["trace-merge", str(stem), "-o", str(tmp_path / "a.jsonl")]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_cli.main(["trace-merge", str(stem), "-o", str(tmp_path / "b.jsonl")]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert ours.pop("merged").endswith("a.jsonl") and theirs.pop("merged").endswith("b.jsonl")
    assert ours == theirs and ours["shards"] == 2
    bad = tmp_path / "bad" / "x.jsonl"
    bad.parent.mkdir()
    bad.write_text('{"type": "span"}\n')
    for argv in ([str(bad)], [str(tmp_path / "absent.jsonl")], [str(bad.parent)]):
        assert cli.main(["trace-merge", *argv]) == jax_cli.main(["trace-merge", *argv]) == 2
    capsys.readouterr()


# ---------------------------------------------------------------- export


@pytest.mark.parametrize("which", ["synthetic", "merged-fleet", "port-one", "port-merged"])
def test_to_chrome_equals_jax(which, tmp_path, port_traces):
    if which == "synthetic":
        path = _synthetic_trace(tmp_path)
    elif which == "merged-fleet":
        path, _ = jax_merge.write_merged(_fleet_shards(tmp_path), tmp_path / "m.jsonl")
    elif which == "port-one":
        path = port_traces / "one.jsonl"
    else:
        path, _ = tracemerge.write_merged(tracemerge.discover(port_traces / "P.jsonl"),
                                          tmp_path / "m.jsonl")
    got = traceexport.to_chrome(tracereport.load_trace(path))
    want = jax_export.to_chrome(jax_report.load_trace(path))
    assert got["metadata"].pop("exporter") == "distributed_sddmm_tpu_torch trace-export"
    want["metadata"].pop("exporter")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    spans = tracereport.load_trace(path)["spans"]
    phs = [e["ph"] for e in got["traceEvents"]]
    assert phs.count("B") == phs.count("E") == len(spans)


def test_trace_export_cli_equals_jax(tmp_path, port_traces, capsys):
    src = port_traces / "one.jsonl"
    assert cli.main(["trace-export", str(src), "-o", str(tmp_path / "a.json")]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_cli.main(["trace-export", str(src), "-o", str(tmp_path / "b.json")]) == 0
    theirs = json.loads(capsys.readouterr().out)
    for doc in (ours, theirs):
        doc.pop("exported"), doc.pop("exporter")
    assert ours == theirs
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "span"}\n')
    for argv in ([str(bad)], [str(tmp_path / "absent.jsonl")], [str(bad), "--no-strict"]):
        assert cli.main(["trace-export", *argv]) == jax_cli.main(["trace-export", *argv])
    capsys.readouterr()


# ---------------------------------------------------------------- charts


class _Recorder:
    """An axes stand-in recording every call with its arguments (numpy
    arrays as lists), so two packages' charts compare as data."""

    def __init__(self):
        self.calls = []
        self.figure = self
        self.spines = self

    def __getitem__(self, _):
        return self

    def __getattr__(self, name):
        def record(*args, **kw):
            self.calls.append((name, _plain(args), _plain(kw)))
            if name == "bar":
                return [_Rect(x, h) for x, h in zip(args[0], args[1])]
            return self
        return record


class _Rect:
    def __init__(self, x, h):
        self.x = x

    def get_x(self):
        return self.x

    def get_width(self):
        return 0.0


def _plain(v):
    if isinstance(v, _Recorder):
        return "<axes>"
    if isinstance(v, np.ndarray):
        return [None if np.isnan(x) else x for x in v.reshape(-1).tolist()]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, range):
        return list(v)
    return v


def _records():
    recs = []
    for R in (64, 128, 256):
        for alg, fused, gf in (("15d_fusion2", True, 10.0), ("15d_sparse", False, 7.0),
                               ("25d_dense_replicate", True, 12.0)):
            recs.append({"algorithm": alg, "fused": fused, "R": R, "app": "vanilla",
                         "overall_throughput": gf * R / 64 + (alg == "15d_sparse") * R / 20,
                         "alg_info": {"c": 2},
                         "perf_stats": {"fusedSpMM": 0.5, "replication": 0.1,
                                        "shift": 0.2, "fusedSpMM_total": 1.0}})
    recs.append({"algorithm": "15d_fusion2", "app": "gat", "R": 24, "overall_throughput": 3.0})
    return recs


@pytest.mark.parametrize("chart", ["throughput_chart", "breakdown_chart", "heatmap_chart"])
def test_chart_series_equal_jax(chart):
    got, want = _Recorder(), _Recorder()
    r1 = getattr(charts, chart)(_records(), got)
    r2 = getattr(jax_charts, chart)(_records(), want)
    assert r1 == r2 and got.calls == want.calls and got.calls
    assert charts.heatmap_winner(_records()) == jax_charts.heatmap_winner(_records())


def test_trend_chart_series_equal_jax():
    series = {"fusedSpMM": [(0, 0.5), (1, 0.6), (2, None)], "cgStep": [(0, 1.0)]}
    got, want = _Recorder(), _Recorder()
    assert charts.trend_chart(got, series) == jax_charts.trend_chart(want, series) is True
    assert got.calls == want.calls
    assert charts.trend_chart(_Recorder(), {"x": [(0, 1.0)]}) is False


def test_kernel_chart_reads_the_port_sweep():
    """The port's ``bench kernels`` records (``KERNELS_CUDA.jsonl``) grouped
    by (log2 M, nnz/row, R), one bar series a kernel family."""
    recs = charts.load_records(ROOT / "KERNELS_CUDA.jsonl")
    points = charts._kernel_points(recs)
    assert points and all(set(v) <= {"cuda-f32", "cuda-bf16", "torch"}
                          for v in points.values())
    best = {}
    for r in recs:
        key = (r["M"].bit_length() - 1, round(r["nnz"] / r["M"]), r["R"])
        best[key, r["kernel"]] = max(best.get((key, r["kernel"]), 0.0),
                                     r["fused_pair_gflops"])
    assert {(k, kern): g for k, v in points.items() for kern, g in v.items()} == best
    ax = _Recorder()
    assert charts.kernels_chart(recs, ax)
    labels = [kw["label"] for name, _, kw in ax.calls if name == "bar"]
    assert labels == [k for k in ("cuda-f32", "cuda-bf16", "torch")
                      if any(k in v for v in points.values())]
    assert not charts.kernels_chart([{"kernel": "xla", "fused_pair_gflops": 1.0}], ax)


def test_charts_cli_without_matplotlib_exits_2(tmp_path, monkeypatch, capsys):
    import builtins

    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert charts.main([str(path), "-o", str(tmp_path / "out")]) == 2
    assert "matplotlib" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------- atomic


def test_atomic_write_lines_streams_and_takes_the_write_hook(tmp_path):
    path = tmp_path / "d" / "m.jsonl"
    atomic_write_lines(path, (json.dumps({"i": i}) for i in range(5)))
    assert [json.loads(x)["i"] for x in path.read_text().splitlines()] == list(range(5))
    assert [p.name for p in path.parent.iterdir()] == ["m.jsonl"]  # no temp file left
    faults.install(faults.FaultPlan.from_spec(
        [{"site": "write:m.jsonl", "kind": "truncate", "at": [0], "param": 0.5}]))
    try:
        atomic_write_lines(path, (json.dumps({"i": i}) for i in range(5)))
        assert [e[:2] for e in faults.active().events] == [("write:m.jsonl", "truncate")]
    finally:
        faults.clear()
    assert len(path.read_text()) < len("".join(json.dumps({"i": i}) + "\n" for i in range(5)))

    def boom():
        yield "first"
        raise OSError("disk full")

    with pytest.raises(OSError):
        atomic_write_lines(tmp_path / "e" / "x.jsonl", boom())
    assert list((tmp_path / "e").iterdir()) == []
