"""The port's regression gate and HTML report (``obs/regress.py``,
``obs/report.py``) against the JAX package's, on the same documents.

The documents are the JAX tests' synthetic ones (``tests/test_obs_regress.py``:
``make_doc``, ``make_fleet_doc``, ``make_trace_doc``) plus serving,
dynamic-structure, tuner and wire-volume documents built here. Both
packages' ``phase_stats``, ``compare`` and ``gate`` reports and their
rendered text must be equal, exactly: the floats go through the same
``statistics.median`` in the same order. The JAX module's
``xla:<op>_flops`` axes are left out of the port by design (no XLA
programs), so every document here carries no ``xla_cost``.

The HTML report: both packages' ``build_html`` over one store directory
give the same section headings and table rows once the title, the
generated-at line and the embedded PNGs are stripped.
"""

import copy
import os
import re

import pytest

from test_obs_regress import make_doc, make_fleet_doc, make_trace_doc

from distributed_sddmm_tpu.obs import regress as jax_regress
from distributed_sddmm_tpu.obs import report as jax_report
from distributed_sddmm_tpu.obs.store import RunStore as JaxStore

from distributed_sddmm_tpu_torch.obs import regress, report
from distributed_sddmm_tpu_torch.obs.store import RunStore

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"


def _serve_doc(run_id, p99=12.0, burn=0.5, shed=0.01, tenant_burn=0.2):
    doc = make_doc(run_id)
    doc["record"].update({
        "requests": 200, "latency_ms": {"p50": 3.0, "p99": p99},
        "shed_rate": shed, "burn_rate": burn,
        "tenant": {"premium": {"requests": 50, "burn_rate": tenant_burn},
                   "free": {"requests": 150}},
    })
    return doc


def _dyn_doc(run_id, retraces=0):
    doc = make_doc(run_id)
    doc["record"]["dynstruct"] = {"dynstruct_rebinds": 8, "dynstruct_bucket_spills": 2,
                                  "structure_retraces": retraces}
    return doc


def _tuner_doc(run_id, adapt=4.0):
    doc = make_doc(run_id)
    doc["record"].update({"time_to_adapt_s": adapt, "tuner": {"promotions": [1, 2]}})
    return doc


def _bytes_doc(run_id, nbytes=4000.0, scale=1.0):
    doc = make_doc(run_id, scale)
    doc["record"]["metrics"]["fusedSpMM"]["comm_bytes"] = nbytes
    return doc


def _traced_doc(run_id, scale=1.0):
    doc = make_doc(run_id, scale, phases=("fusedSpMM", "sddmmA"))
    doc["phases"] = {
        "fusedSpMM": {"calls": 4, "total_s": 2.0, "kernel_s": 1.8, "overhead_s": 0.2,
                      "retries": 1, "comm_words": 50.0, "flops": 1e6, "pairs": 4.0,
                      "model_words": 500.0, "model_ratio": 0.1},
        "als:step": {"calls": 2, "total_s": 1.0, "kernel_s": 1.0, "overhead_s": 0.0,
                     "retries": 0, "comm_words": 0.0, "flops": 0.0},
    }
    return doc


#: (case id, new doc, reference doc, baseline docs or None, threshold).
CASES = [
    ("regression", make_doc("b", 2.0), make_doc("a", 1.0), None, 0.15),
    ("noise", make_doc("b", 1.05), make_doc("a", 1.0), None, 0.15),
    ("improvement", make_doc("b", 0.5), make_doc("a", 1.0), None, 0.15),
    ("missing", make_doc("b", 1.0), make_doc("a", 1.0, phases=("fusedSpMM", "cgStep")),
     None, 0.15),
    ("new", make_doc("b", 1.0, phases=("fusedSpMM", "cgStep")), make_doc("a", 1.0), None,
     0.15),
    ("overhead", make_doc("b", 1.0, overhead_s=1.0), make_doc("a", 1.0), None, 0.15),
    ("comm", make_doc("b", 2.0, comm_words=2000.0), make_doc("a", 1.0), None, 0.15),
    ("rolling", make_doc("new", 2.0), None,
     [make_doc(f"b{i}", s) for i, s in enumerate([1.0, 1.02, 5.0, 0.98, 1.01])], 0.15),
    ("rolling-ok", make_doc("new", 1.04), None,
     [make_doc(f"b{i}", s) for i, s in enumerate([1.0, 1.02, 5.0, 0.98, 1.01])], 0.15),
    ("other-key", make_doc("b", 1.0, key="key-b"), make_doc("a", 1.0), None, 0.15),
    ("wide-band", make_doc("b", 2.0), make_doc("a", 1.0), None, 2.0),
    ("traced", _traced_doc("b", 1.5), _traced_doc("a"), None, 0.15),
    ("traced-vs-untraced", make_doc("b", 1.0), _traced_doc("a"), None, 0.15),
    ("fleet-mismatch", make_fleet_doc("b", audit_mismatches=1), make_fleet_doc("a"), None,
     0.15),
    ("fleet-new-mismatch", make_fleet_doc("b", audit_mismatches=2), make_doc("a"), None,
     0.15),
    ("fleet-hedges", make_fleet_doc("c", hedges=100, hedge_wins=50),
     make_fleet_doc("a", hedges=100, hedge_wins=5), None, 0.15),
    ("fleet-availability", make_fleet_doc("b", availability=0.9), make_fleet_doc("a"),
     None, 0.15),
    ("trace-coverage", make_trace_doc("b", coverage=0.98), make_trace_doc("a"), None, 0.15),
    ("trace-coverage-ok", make_trace_doc("b"), make_trace_doc("a"), None, 0.15),
    ("serve", _serve_doc("b", p99=30.0, burn=2.0, tenant_burn=1.5), _serve_doc("a"), None,
     0.15),
    ("serve-not-measured", make_doc("b"), _serve_doc("a"), None, 0.15),
    ("dynstruct", _dyn_doc("b", retraces=3), _dyn_doc("a"), None, 0.15),
    ("tuner", _tuner_doc("b", adapt=9.0), _tuner_doc("a"), None, 0.15),
    ("comm-bytes", _bytes_doc("b", nbytes=2000.0), _bytes_doc("a"), None, 0.15),
    ("comm-bytes-gone", make_doc("b"), _bytes_doc("a"), None, 0.15),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compare_and_render_equal_jax(case):
    _, new, ref, baseline, threshold = case
    args = [copy.deepcopy(x) for x in (new, ref, baseline)]
    want = jax_regress.compare(new, doc_a=ref, baseline_docs=baseline, threshold=threshold)
    got = regress.compare(*args[:1], doc_a=args[1], baseline_docs=args[2],
                          threshold=threshold)
    assert got == want
    if case[0] == "fleet-new-mismatch":
        # A hard axis that regresses with no baseline row: the JAX renderer
        # reads the missing A row and raises; the port prints '-' there.
        with pytest.raises(AttributeError):
            jax_regress.render_compare(want)
        row = [ln for ln in regress.render_compare(got).splitlines()
               if ln.startswith("fleet:audit_mismatch")]
        assert len(row) == 1 and "regression" in row[0] and "fleet" in row[0]
    else:
        assert regress.render_compare(got) == jax_regress.render_compare(want)
    for doc in (new, ref, *(baseline or ())):
        if doc is not None:
            assert regress.phase_stats(doc) == jax_regress.phase_stats(doc)


@pytest.mark.parametrize("scales,new,min_runs,k", [
    ([1.0, 1.01, 0.99], 1.05, 1, 5),
    ([1.0, 1.01, 0.99], 2.0, 1, 5),
    ([1.0, 1.01, 0.99], 2.0, 1, 1),
    ([], 1.0, 1, 5),
    ([1.0, 1.01], 1.0, 3, 5),
    ([1.0, 0.5, 3.0, 1.1, 0.9, 1.3], 1.2, 1, 4),
], ids=["pass", "regression", "last-one", "no-data", "min-runs", "noisy"])
def test_gate_on_one_store_directory_equals_jax(tmp_path, scales, new, min_runs, k):
    """Both packages' stores over one directory: the same baseline, the same
    exit code and report; a foreign key and the explicit baseline too."""
    seed = JaxStore(tmp_path)
    for i, s in enumerate(scales):
        seed.put(make_doc(f"run-{i}", s))
    seed.put(make_doc("foreign", 0.1, key="key-z"))
    seed.put(make_doc("new", new))
    ours, theirs = RunStore(tmp_path), JaxStore(tmp_path)
    got = regress.gate(ours, ours.get("new"), k=k, min_runs=min_runs)
    want = jax_regress.gate(theirs, theirs.get("new"), k=k, min_runs=min_runs)
    assert got == want
    if scales:
        got = regress.gate(ours, ours.get("new"), baseline_doc=ours.get("run-0"))
        want = jax_regress.gate(theirs, theirs.get("new"), baseline_doc=theirs.get("run-0"))
        assert got == want and got[0] in (0, 2)
        if got[1].get("phases"):
            assert regress.render_compare(got[1]) == jax_regress.render_compare(want[1])
    assert (regress.GATE_PASS, regress.GATE_REGRESSION, regress.GATE_NO_DATA) == (0, 2, 3)


def test_render_history_equals_jax(tmp_path):
    seed = JaxStore(tmp_path)
    for i, s in enumerate([1.0, 2.0, 0.5]):
        seed.put(make_doc(f"run-{i}", s))
    seed.put(_serve_doc("serve-run"))
    seed.put(dict(make_doc("cardrun"), backend="cuda:NVIDIA H100 80GB HBM3:local"))
    rows = RunStore(tmp_path).history()
    assert rows == JaxStore(tmp_path).history()
    assert regress.render_history(rows) == jax_regress.render_history(rows)
    assert regress.render_history(rows[-2:]) == jax_regress.render_history(rows[-2:])


def _tables(html: str) -> list:
    """The report's headings and table rows, without the title, the
    generated-at line and the embedded PNGs (and the headings of charts,
    which depend on matplotlib being importable)."""
    html = re.sub(r"<h1>.*?</h1>", "", html)
    html = re.sub(r"<p class=meta>store: .*?</p>", "", html)
    html = re.sub(r"<title>.*?</title>", "", html)
    html = re.sub(r'<img src="data:image/png;base64,[^"]*"[^>]*>', "<img>", html)
    return re.findall(r"<h2>.*?</h2>|<tr[^>]*>.*?</tr>|<img>|<p class=meta>.*?</p>",
                      html)


def test_report_html_tables_equal_jax(tmp_path):
    root = tmp_path / "store"
    seed = JaxStore(root)
    for i, s in enumerate([1.0, 1.02, 0.98]):
        seed.put(make_doc(f"run-{i}", s))
    seed.put(make_doc("run-new", 2.0))
    seed.put(dict(_serve_doc("serve-run"), key="key-s"))
    anomalous = make_doc("anom-run", key="key-q")
    anomalous["record"]["anomalies"] = {"anomalies": [{
        "kind": "step_time_spike", "op": "fusedSpMM", "count": 2,
        "first": {"snapshot_path": "/x/flight.json"}}]}
    anomalous["anomalies"] = anomalous["record"]["anomalies"]
    seed.put(anomalous)
    attention = make_doc("attn-run", key="key-att")
    attention["record"].update({"app": "attention", "mask": "window:16",
                                "attention_hbm": {"fused_bytes": 100, "unfused_bytes": 300,
                                                  "savings_frac": 2 / 3}})
    seed.put(attention)
    fleet = make_fleet_doc("fleet-run", hedges=10, hedge_wins=1)
    fleet["record"]["fleet"].update({"replicas": 3, "chaos": "kill-replica", "ok": 99})
    seed.put(fleet)
    ours = report.build_html(RunStore(root), out_path=tmp_path / "port.html", key="key-a")
    theirs = jax_report.build_html(JaxStore(root), out_path=tmp_path / "jax.html", key="key-a")
    got, want = _tables(ours.read_text()), _tables(theirs.read_text())
    assert got == want
    assert any("Latest compare" in x for x in got)  # the compare table is in
    assert sum(x.startswith("<tr") for x in got) > 15
    assert "distributed_sddmm_tpu_torch run history" in ours.read_text()
    assert "http://" not in ours.read_text() and "https://" not in ours.read_text()


def test_report_html_renders_not_measured_rows(tmp_path):
    """The newest run lacks an optional axis its baseline has (a serving
    record's burn rate): the JAX report's compare table reads the missing B
    row and raises; the port's shows the row as not measured."""
    seed = RunStore(tmp_path)
    seed.put(_serve_doc("serve-old"))
    seed.put(_serve_doc("serve-new", burn=None))
    with pytest.raises(TypeError):
        jax_report.build_html(JaxStore(tmp_path), out_path=tmp_path / "jax.html")
    html = report.build_html(seed, out_path=tmp_path / "r.html").read_text()
    row = re.search(r'<tr class="not-measured"><td class=l>serve:burn_rate</td>.*?</tr>',
                    html)
    assert row and "<td>not-measured</td>" in row.group(0)


def test_report_html_keeps_its_tables_without_matplotlib(tmp_path, monkeypatch):
    """The card's machine has no matplotlib: the report then carries no
    chart and every table."""
    import builtins

    seed = RunStore(tmp_path)
    for i, s in enumerate([1.0, 1.01, 2.0]):
        seed.put(make_doc(f"run-{i}", s))
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    html = report.build_html(seed, out_path=tmp_path / "r.html").read_text()
    assert "<img" not in html
    assert "Latest compare" in html and "run-2" in html and "fusedSpMM" in html
