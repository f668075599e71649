"""Static HTML report over the run store (counterpart of ``obs/report.py``).

``bench report-html`` writes one self-contained HTML file (no external
assets; charts embedded as base64 PNGs), to attach to a CI artifact or open
from a copied checkout without a server. Sections:

* **Runs**: every stored run (backfilled rounds included), newest last,
  with backend, throughput and anomaly counts;
* **Per-phase trends**: seconds a call of each phase and the throughput
  across the runs of the focus key (the newest run's by default);
* **Latest compare**: the newest run against its rolling baseline, from
  :func:`.regress.compare`, with its verdicts and attribution columns;
* the anomaly, attention, serving and fleet sections where such runs
  exist.

Charts go through ``tools/charts.py`` and matplotlib. Without matplotlib
(the card's machine has none) the report keeps its tables: the numbers
are the contract, not the pictures.
"""

from __future__ import annotations

import base64
import html
import io
import pathlib
import time

from distributed_sddmm_tpu_torch.obs import regress
from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_text

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2em auto; max-width: 72em; color: #222; }
h1, h2 { font-weight: 600; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 2em; }
table { border-collapse: collapse; font-size: 0.82em; width: 100%; }
th, td { padding: 3px 8px; text-align: right; border-bottom: 1px solid #eee; }
th { background: #f6f6f6; position: sticky; top: 0; }
td.l, th.l { text-align: left; font-family: ui-monospace, monospace; }
tr.regression td { background: #fdecea; }
tr.improvement td { background: #eaf7ed; }
tr.missing td, tr.new td { background: #fff8e1; }
.meta { color: #777; font-size: 0.8em; }
.verdict-ok { color: #1a7f37; font-weight: 600; }
.verdict-regression { color: #c0392b; font-weight: 600; }
.verdict-improvement { color: #1a7f37; font-weight: 600; }
.verdict-no_data { color: #b8860b; font-weight: 600; }
img { max-width: 100%; }
"""


def _esc(v) -> str:
    return html.escape("-" if v is None else str(v))


def _fmt(v, nd: int = 3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _chart_png(draw) -> str | None:
    """Run ``draw(ax)`` on a fresh figure, return a data-URI PNG (None
    when matplotlib is absent or nothing was drawn)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(9.5, 4.0))
    try:
        if draw(ax) is False:
            return None
        fig.tight_layout()
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=120)
    finally:
        plt.close(fig)
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _history_table(rows: list[dict]) -> str:
    cells = [
        "<table><tr><th class=l>run_id</th><th class=l>source</th>"
        "<th class=l>algorithm</th><th>app</th><th>R</th><th>c</th>"
        "<th class=l>variant</th>"
        "<th>backend</th><th>elapsed&nbsp;s</th><th>GFLOP/s</th>"
        "<th>cold&nbsp;compiles</th>"
        "<th>p99&nbsp;ms</th><th>burn</th>"
        "<th>anomalies</th><th class=l>key</th></tr>"
    ]
    for r in rows:
        anom = r.get("anomaly_count", 0)
        burn = r.get("burn_rate")
        style = (
            ' class="regression"'
            if anom or (burn is not None and burn > 1.0) else ""
        )
        live = r.get("live_compiles")
        p99 = r.get("hist_p99_ms")
        if p99 is None:
            p99 = r.get("latency_p99_ms")
        cells.append(
            f"<tr{style}><td class=l>{_esc(r.get('run_id'))}</td>"
            f"<td class=l>{_esc(r.get('source'))}</td>"
            f"<td class=l>{_esc(r.get('algorithm'))}</td>"
            f"<td>{_esc(r.get('app'))}</td><td>{_esc(r.get('R'))}</td>"
            f"<td>{_esc(r.get('c'))}</td>"
            f"<td class=l>{_esc(r.get('kernel_variant') or '-')}</td>"
            f"<td>{_esc(r.get('backend'))}</td>"
            f"<td>{_fmt(r.get('elapsed'))}</td>"
            f"<td>{_fmt(r.get('overall_throughput'))}</td>"
            f"<td>{'-' if live is None else int(live)}</td>"
            f"<td>{_fmt(p99, 1)}</td>"
            f"<td>{_fmt(burn, 2)}</td>"
            f"<td>{anom or ''}</td>"
            f"<td class=l>{_esc((r.get('key') or '')[:16])}</td></tr>"
        )
    cells.append("</table>")
    return "".join(cells)


def _flight_record_rows(store, rows: list[dict]) -> list[tuple]:
    """(run_id, kind, op, count, snapshot_path) for every anomaly group
    of every run that recorded any — ``snapshot_path`` present when the
    flight recorder was armed, letting the dashboard jump from
    an anomaly row straight to the span-ring dump that explains it."""
    out = []
    for r in rows:
        if not r.get("anomaly_count"):
            continue
        doc = store.get(r["run_id"])
        anom = ((doc or {}).get("record") or {}).get("anomalies") or {}
        for g in anom.get("anomalies") or ():
            out.append((
                r["run_id"], g.get("kind"), g.get("op"),
                g.get("count", 1),
                (g.get("first") or {}).get("snapshot_path"),
            ))
    return out


def _flight_table(rows: list[tuple]) -> str:
    cells = [
        "<table><tr><th class=l>run_id</th><th class=l>anomaly</th>"
        "<th class=l>op</th><th>count</th>"
        "<th class=l>flight record</th></tr>"
    ]
    for run_id, kind, op, count, path in rows:
        link = (
            f'<a href="file://{_esc(path)}">{_esc(path)}</a>'
            if path else "-"
        )
        cells.append(
            f'<tr class="regression"><td class=l>{_esc(run_id)}</td>'
            f"<td class=l>{_esc(kind)}</td><td class=l>{_esc(op)}</td>"
            f"<td>{count}</td><td class=l>{link}</td></tr>"
        )
    cells.append("</table>")
    return "".join(cells)


def _compare_table(report: dict) -> str:
    cells = [
        "<table><tr><th class=l>phase</th><th>calls</th>"
        "<th>t/call base</th><th>t/call new</th><th>Δ%</th>"
        "<th>GF/s base</th><th>GF/s new</th><th>Mwords/call</th>"
        "<th>MB/call</th>"
        "<th>words/model</th><th>verdict</th><th>blame</th></tr>"
    ]
    for name, row in report["phases"].items():
        v = row["verdict"]
        a, b = row.get("a"), row.get("b")
        if v in ("missing", "new", "not-measured"):
            cells.append(
                f'<tr class="{v}"><td class=l>{_esc(name)}</td>'
                + "<td>-</td>" * 9
                + f"<td>{v}</td><td></td></tr>"
            )
            continue
        mwords = b["comm_words"] / b["calls"] / 1e6 if b["calls"] else 0.0
        # Wire-aware volume; None where not counted,
        # rendered as '-' (not measured), never as zero traffic.
        mbytes = (
            b["comm_bytes"] / b["calls"] / 1e6
            if b["calls"] and b.get("comm_bytes") is not None else None
        )
        cells.append(
            f'<tr class="{v if v != "ok" else ""}">'
            f"<td class=l>{_esc(name)}</td><td>{b['calls']}</td>"
            f"<td>{_fmt(row.get('baseline_median_t_call'), 6)}</td>"
            f"<td>{_fmt(b['t_call'], 6)}</td>"
            f"<td>{_fmt(row.get('delta_pct'), 1)}</td>"
            f"<td>{_fmt(a.get('gflops'))}</td><td>{_fmt(b.get('gflops'))}</td>"
            f"<td>{_fmt(mwords)}</td>"
            f"<td>{_fmt(mbytes)}</td>"
            f"<td>{_fmt(b.get('model_ratio'))}</td>"
            f"<td>{v}</td><td>{_esc(row.get('attribution', ''))}</td></tr>"
        )
    cells.append("</table>")
    return "".join(cells)


def _latency_series(store, rows: list[dict]) -> dict:
    """Serving latency trend (ms) across every stored ``bench serve``
    run in ``rows`` — p50/p99 plus the shed count scaled into view via
    its own series label. Rows without ``latency_ms`` (offline runs)
    contribute nothing, so the panel only renders when serving history
    exists."""
    series: dict[str, list] = {}
    for x, r in enumerate(rows):
        if r.get("latency_p99_ms") is None:
            continue
        doc = store.get(r["run_id"])
        lat = ((doc or {}).get("record") or {}).get("latency_ms") or {}
        for pct in ("p50", "p99"):
            if lat.get(pct) is not None:
                series.setdefault(f"latency {pct} (ms)", []).append(
                    (x, lat[pct])
                )
    return series


def _burn_series(rows: list[dict]) -> dict:
    """SLO error-budget burn-rate trend (from the index's ``burn_rate``
    column). Rows without it carry None and contribute nothing: the panel
    renders only when measured history exists."""
    series: dict[str, list] = {}
    for x, r in enumerate(rows):
        if r.get("burn_rate") is not None:
            series.setdefault("error-budget burn rate", []).append(
                (x, r["burn_rate"])
            )
    return series


def _attention_rows(store, rows: list[dict]) -> list[tuple]:
    """(run_id, mask, R, fused, throughput, hbm fused/unfused/savings)
    for every attention run (``app == "attention"``); the HBM columns
    come from the run doc's counted ``attention_hbm`` record."""
    out = []
    for r in rows:
        if r.get("app") != "attention":
            continue
        doc = store.get(r["run_id"]) or {}
        hbm = (doc.get("record") or {}).get("attention_hbm") or {}
        out.append((
            r.get("run_id"), r.get("mask"), r.get("R"), r.get("fused"),
            r.get("overall_throughput"), hbm.get("fused_bytes"),
            hbm.get("unfused_bytes"), hbm.get("savings_frac"),
        ))
    return out


def _attention_table(rows: list[tuple]) -> str:
    head = (
        "<tr><th class=l>run</th><th class=l>mask</th><th>R</th>"
        "<th>fused</th><th>GFLOP/s</th><th>HBM fused</th>"
        "<th>HBM unfused</th><th>HBM cut</th></tr>"
    )
    body = []
    for run, mask, R, fused, gf, fb, ub, sf in rows:
        body.append(
            f"<tr><td class=l>{_esc((run or '')[:24])}</td>"
            f"<td class=l>{_esc(mask or '-')}</td><td>{_fmt(R, 0)}</td>"
            f"<td>{'yes' if fused else 'no'}</td><td>{_fmt(gf)}</td>"
            f"<td>{_fmt(fb, 0)}</td><td>{_fmt(ub, 0)}</td>"
            f"<td>{_fmt(sf * 100, 1) + '%' if sf is not None else '-'}"
            f"</td></tr>"
        )
    return f"<table>{head}{''.join(body)}</table>"


def _fleet_rows(store, rows: list[dict]) -> list[tuple]:
    """(run_id, replicas, chaos, availability, ok, shed+deferred,
    losses, mismatches, replacement live compiles, worst tenant burn)
    for every ``bench fleet`` run — the serving-fleet ops panel."""
    out = []
    for r in rows:
        doc = store.get(r["run_id"]) or {}
        rec = doc.get("record") or {}
        fleet = rec.get("fleet") or {}
        if fleet.get("availability") is None:
            continue
        worst = None
        for name, cell in (rec.get("tenant") or {}).items():
            b = cell.get("burn_rate")
            if b is not None and (worst is None or b > worst[1]):
                worst = (name, b)
        out.append((
            r.get("run_id"), fleet.get("replicas"), fleet.get("chaos"),
            fleet.get("availability"), fleet.get("ok"),
            (fleet.get("shed_with_retry") or 0)
            + (fleet.get("deferred") or 0),
            fleet.get("losses"), fleet.get("mismatches"),
            fleet.get("replacement_live_compiles"), worst,
        ))
    return out


def _fleet_table(rows: list[tuple]) -> str:
    head = (
        "<tr><th class=l>run</th><th>replicas</th><th class=l>chaos</th>"
        "<th>availability</th><th>ok</th><th>shed/deferred</th>"
        "<th>losses</th><th>mismatches</th><th>respawn compiles</th>"
        "<th class=l>worst tenant burn</th></tr>"
    )
    body = []
    for run, n, chaos, avail, ok, shed, losses, mism, rlc, worst in rows:
        body.append(
            f"<tr><td class=l>{_esc((run or '')[:24])}</td>"
            f"<td>{_fmt(n, 0)}</td><td class=l>{_esc(chaos or '-')}</td>"
            f"<td>{_fmt(avail * 100, 2) + '%' if avail is not None else '-'}"
            f"</td><td>{_fmt(ok, 0)}</td><td>{_fmt(shed, 0)}</td>"
            f"<td>{_fmt(losses, 0)}</td><td>{_fmt(mism, 0)}</td>"
            f"<td>{_fmt(rlc, 0)}</td>"
            f"<td class=l>{_esc(f'{worst[0]} ({worst[1]:.2f}x)') if worst else '-'}"
            f"</td></tr>"
        )
    return f"<table>{head}{''.join(body)}</table>"


def _trend_series(store, rows: list[dict]) -> tuple[dict, dict]:
    """(per-phase t/call series, headline series) across ``rows``."""
    per_phase: dict[str, list] = {}
    headline: dict[str, list] = {"GFLOP/s": []}
    for x, r in enumerate(rows):
        if r.get("overall_throughput"):
            headline["GFLOP/s"].append((x, r["overall_throughput"]))
        doc = store.get(r["run_id"])
        if not doc:
            continue
        for name, ph in regress.phase_stats(doc).items():
            per_phase.setdefault(name, []).append((x, ph["t_call"]))
    return per_phase, headline


def build_html(
    store,
    out_path: str | pathlib.Path | None = None,
    limit: int = 100,
    key: str | None = None,
    threshold: float = 0.15,
) -> pathlib.Path:
    """Render the dashboard; returns the written path (default
    ``<store root>/report.html``)."""
    from distributed_sddmm_tpu_torch.tools import charts

    out_path = pathlib.Path(out_path) if out_path else store.root / "report.html"
    all_rows = store.history(limit=limit)
    # Focus key for trends/compare: the most recent run's key unless
    # pinned — trends across different problems would be meaningless.
    if key is None:
        for r in reversed(all_rows):
            if r.get("key"):
                key = r["key"]
                break
    focus_rows = [r for r in all_rows if key and r.get("key") == key]

    sections = [
        "<h1>distributed_sddmm_tpu_torch run history</h1>",
        f'<p class=meta>store: {_esc(store.root)} · generated '
        f'{time.strftime("%Y-%m-%d %H:%M:%S")} · {len(all_rows)} runs shown'
        f" · focus key: {_esc((key or '')[:16])}</p>",
        "<h2>Runs</h2>", _history_table(all_rows),
    ]

    flights = _flight_record_rows(store, all_rows)
    if flights:
        sections += [
            "<h2>Anomalies &amp; flight records</h2>",
            "<p class=meta>Watchdog anomalies per run; when the flight "
            "recorder was armed, each links to the span-ring snapshot "
            "written at the moment it fired.</p>",
            _flight_table(flights),
        ]

    per_phase, headline = _trend_series(store, focus_rows)
    png = _chart_png(lambda ax: charts.trend_chart(ax, per_phase))
    if png:
        sections += ["<h2>Per-phase seconds/call (focus key)</h2>",
                     f'<img src="{png}" alt="per-phase trend">']
    png = _chart_png(
        lambda ax: charts.trend_chart(
            ax, headline, ylabel="GFLOP/s", logy=False)
    )
    if png:
        sections += ["<h2>Headline throughput (focus key)</h2>",
                     f'<img src="{png}" alt="throughput trend">']

    attn = _attention_rows(store, all_rows)
    if attn:
        sections += [
            "<h2>Sparse attention (all attention runs)</h2>",
            "<p class=meta>Fused SDDMM → masked-softmax → SpMM runs per "
            "mask family; the HBM columns are the counted program-I/O "
            "traffic of the fused pair vs the three-program unfused "
            "sequence.</p>",
            _attention_table(attn),
        ]

    lat_series = _latency_series(store, all_rows)
    png = _chart_png(
        lambda ax: charts.trend_chart(
            ax, lat_series, ylabel="latency (ms)", logy=False)
    )
    if png:
        sections += ["<h2>Serving latency trend (all serve runs)</h2>",
                     f'<img src="{png}" alt="serving latency trend">']

    burn_series = _burn_series(all_rows)
    png = _chart_png(
        lambda ax: charts.trend_chart(
            ax, burn_series, ylabel="burn rate (x budget)", logy=False)
    )
    if png:
        sections += [
            "<h2>SLO error-budget burn rate (all serve runs)</h2>",
            "<p class=meta>1.0 = burning exactly at budget; above the "
            "line the SLO will be violated if the window holds.</p>",
            f'<img src="{png}" alt="burn rate trend">',
        ]

    fleet = _fleet_rows(store, all_rows)
    if fleet:
        sections += [
            "<h2>Serving fleet (all fleet runs)</h2>",
            "<p class=meta>Replica pool behind the front router: "
            "availability = (answered + shed-with-retry + deferred) / "
            "offered through the chaos window; mismatches compare every "
            "reply bit-for-bit against the single-engine oracle; "
            "respawn compiles must be 0 (warm-start from the shared "
            "program store).</p>",
            _fleet_table(fleet),
        ]

    if len(focus_rows) >= 2:
        newest = store.get(focus_rows[-1]["run_id"])
        baseline = store.matching(newest, limit=5) if newest else []
        if newest and baseline:
            rep = regress.compare(
                newest, baseline_docs=baseline, threshold=threshold
            )
            sections += [
                f"<h2>Latest compare — verdict "
                f'<span class="verdict-{rep["verdict"]}">'
                f'{rep["verdict"]}</span></h2>',
                f"<p class=meta>{_esc(rep['run_a'])} → "
                f"{_esc(rep['run_b'])} (baseline n={rep['baseline_n']}, "
                f"threshold ±{threshold * 100:.0f}%)</p>",
                _compare_table(rep),
            ]

    doc = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>distributed_sddmm_tpu_torch runs</title>"
        f"<style>{_CSS}</style></head><body>"
        + "".join(sections)
        + "</body></html>"
    )
    # Atomic: a dashboard refresh must never serve a half-written page.
    atomic_write_text(out_path, doc)
    return out_path
