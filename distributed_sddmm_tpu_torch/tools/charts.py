"""Charts from benchmark records (counterpart of ``tools/charts.py``).

The offline analysis of the reference's ``ipdps_chart_generator.ipynb``
over the JSON-lines files the harness appends (``-o``):

* throughput bars by configuration;
* the {Replication, Propagation, Computation} breakdown by algorithm (the
  notebook's mapping of the perf counters, cell 2);
* the R-sweep winner heatmap (cell 21) where heatmap records exist;
* with ``--kernels``, the local-kernel sweep of ``bench kernels`` (e.g.
  ``KERNELS_CUDA.jsonl``) by kernel family: ``cuda-f32``, ``cuda-bf16`` and
  ``torch``.

The chart functions draw on an axes they are given and import no plotting
library; only :func:`main` needs matplotlib, which the card's machine does
not have. Without it the command exits 2 and says so, and the HTML report
(``obs/report.py``) keeps its tables.

Usage: ``python -m distributed_sddmm_tpu_torch.tools.charts results.jsonl -o out/``
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

# Perf-counter name -> breakdown category (notebook cell 2 mapping).
_CATEGORY = {
    "sddmmA": "Computation",
    "sddmmB": "Computation",
    "spmmA": "Computation",
    "spmmB": "Computation",
    "fusedSpMM": "Computation",
    "replication": "Replication",
    "allgather": "Replication",
    "shift": "Propagation",
    "ppermute": "Propagation",
}


def load_records(path: str) -> list:
    """Load JSON-lines records, skipping malformed lines — the producers
    append under hard-kill timeouts, so a truncated tail line is normal."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                print(f"skipping malformed line: {line[:60]!r}", file=sys.stderr)
    return records


def _alg_label(rec: dict) -> str:
    alg = rec.get("algorithm", rec.get("baseline", "?"))
    fused = rec.get("fused")
    return f"{alg}{'/fused' if fused else ''}"


def throughput_chart(records, ax) -> None:
    labels, values = [], []
    for rec in records:
        if "overall_throughput" in rec:
            labels.append(f"{_alg_label(rec)}\nR={rec.get('R', rec.get('r', '?'))}")
            values.append(rec["overall_throughput"])
    ax.bar(range(len(values)), values)
    ax.set_xticks(range(len(labels)), labels, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("GFLOP/s")
    ax.set_title("Throughput by configuration")


def breakdown_chart(records, ax) -> None:
    """Stacked {Computation, Replication, Propagation} seconds per algorithm.

    Bias note (consumers of these bars, read this): the region counters come
    from ``base.measure_breakdown``'s collective ablation, whose "local"
    variant replaces the replication ``all_gather`` with a concat of c local
    copies (``parallel/loops.py``). That keeps shapes but adds memory
    traffic the true program does not have, so at c > 1 the Computation bar
    is mildly INFLATED and the Replication bar correspondingly deflated —
    the same first-order altitude as the reference's barrier-separated
    timers (`distributed_sparse.h:205-261`), not an exact decomposition.
    """
    per_alg: dict = collections.defaultdict(lambda: collections.defaultdict(float))
    for rec in records:
        stats = rec.get("perf_stats") or {}
        for name, secs in stats.items():
            if name.endswith("_total"):
                continue  # whole-call duplicates of the region counters
            cat = _CATEGORY.get(name, "Computation")
            per_alg[_alg_label(rec)][cat] += secs
    if not per_alg:
        ax.set_axis_off()
        return
    algs = sorted(per_alg)
    cats = ["Computation", "Replication", "Propagation"]
    bottoms = [0.0] * len(algs)
    for cat in cats:
        vals = [per_alg[a].get(cat, 0.0) for a in algs]
        ax.bar(range(len(algs)), vals, bottom=bottoms, label=cat)
        bottoms = [b + v for b, v in zip(bottoms, vals)]
    ax.set_xticks(range(len(algs)), algs, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("seconds")
    ax.set_title("Time breakdown (ablation estimate; c>1 inflates Computation)",
                 fontsize=9)
    ax.legend(fontsize=7)


def heatmap_chart(records, ax) -> bool:
    """R x algorithm throughput heatmap (the notebook's winner-heatmap
    figure, cell 21). Returns False when the records span < 2 R values."""
    cells: dict = {}
    for rec in records:
        if "overall_throughput" not in rec or "algorithm" not in rec:
            continue
        if rec.get("app", "vanilla") != "vanilla":
            continue  # gat/als records carry mutated/app-specific R
        R = rec.get("R") or rec.get("alg_info", {}).get("r")
        cells[(_alg_label(rec), R)] = max(
            cells.get((_alg_label(rec), R), 0.0), rec["overall_throughput"]
        )
    algs = sorted({k[0] for k in cells})
    rs = sorted({k[1] for k in cells})
    if len(rs) < 2 or not algs:
        ax.set_axis_off()
        return False
    import numpy as np

    grid = np.full((len(algs), len(rs)), np.nan)
    for (a, r), v in cells.items():
        grid[algs.index(a), rs.index(r)] = v
    im = ax.imshow(grid, aspect="auto", cmap="viridis")
    ax.set_xticks(range(len(rs)), [str(r) for r in rs])
    ax.set_yticks(range(len(algs)), algs, fontsize=7)
    ax.set_xlabel("R")
    ax.set_title("GFLOP/s by (algorithm, R); * = winner")
    winners = np.nanargmax(np.where(np.isnan(grid), -1, grid), axis=0)
    for j, i in enumerate(winners):
        if not np.isnan(grid[i, j]):
            ax.text(j, i, "*", ha="center", va="center", color="w",
                    fontsize=14)
    ax.figure.colorbar(im, ax=ax, shrink=0.8)
    return True


def heatmap_winner(records) -> dict:
    """(R, c) -> winning algorithm by throughput (notebook cell 21)."""
    best: dict = {}
    for rec in records:
        if "overall_throughput" not in rec or "algorithm" not in rec:
            continue
        key = (rec.get("R"), rec.get("alg_info", {}).get("c", rec.get("c")))
        if key not in best or rec["overall_throughput"] > best[key][1]:
            best[key] = (_alg_label(rec), rec["overall_throughput"])
    return {f"R={k[0]},c={k[1]}": v[0] for k, v in sorted(best.items(), key=str)}


#: Fixed colours a kernel family (colourblind-safe), by entity, never by
#: position in the file.
_KERNEL_COLORS = {"cuda-f32": "#4477AA", "cuda-bf16": "#EE7733", "torch": "#228833"}


def _kernel_points(records) -> dict:
    """(log2 M, nnz/row, R) -> {kernel family: best fused-pair GFLOP/s} from
    ``bench kernels`` records (``M``, ``nnz``, ``R``, ``kernel``), skipping
    partial lines and other families."""
    points: dict = collections.OrderedDict()
    for rec in records:
        g = rec.get("fused_pair_gflops")
        kern = rec.get("kernel")
        M, nnz = rec.get("M"), rec.get("nnz")
        if g is None or kern not in _KERNEL_COLORS or not M or nnz is None:
            continue
        key = (int(M).bit_length() - 1, round(nnz / M), rec.get("R"))
        # The best record a (grid point, kernel): sweeps rerun configurations.
        points.setdefault(key, {})
        points[key][kern] = max(points[key].get(kern, 0.0), g)
    return points


def kernels_chart(records, ax, points=None) -> bool:
    """Fused-pair GFLOP/s of each kernel family, grouped by sweep point (the
    reference's ``local_kernel_benchmark.cpp:264-267`` table)."""
    if points is None:
        points = _kernel_points(records)
    if not points:
        return False
    keys = sorted(points)
    kerns = [k for k in _KERNEL_COLORS if any(k in points[p] for p in keys)]
    width = 0.8 / len(kerns)
    for i, kern in enumerate(kerns):
        xs = [k + (i - (len(kerns) - 1) / 2) * width for k in range(len(keys))]
        ys = [points[k].get(kern, 0.0) for k in keys]
        bars = ax.bar(xs, ys, width=width * 0.94, color=_KERNEL_COLORS[kern],
                      label=kern, zorder=2)
        for rect, y in zip(bars, ys):
            if y:
                ax.annotate(f"{y:.0f}", (rect.get_x() + rect.get_width() / 2, y),
                            ha="center", va="bottom", fontsize=6, color="#444444")
    ax.set_xticks(range(len(keys)),
                  [f"2^{m}\n{n}/row\nR={r}" for m, n, r in keys], fontsize=7)
    ax.set_ylabel("fused-pair GFLOP/s")
    ax.set_title("Local kernel sweep by kernel family (one card)")
    ax.legend(frameon=False)
    ax.grid(axis="y", color="#dddddd", linewidth=0.6, zorder=0)
    ax.spines[["top", "right"]].set_visible(False)
    return True


def trend_chart(ax, series: dict, ylabel: str = "s/call",
                logy: bool = True) -> bool:
    """Per-phase trend lines over a run sequence (the run-store
    dashboard's history figure). ``series`` maps label -> list of
    (x, y) points; x is the run's position in history. Returns False
    when nothing plottable was passed (axis is blanked)."""
    plotted = False
    for label in sorted(series):
        pts = [(x, y) for x, y in series[label] if y is not None and y > 0]
        if len(pts) < 2:
            continue
        ax.plot([p[0] for p in pts], [p[1] for p in pts],
                marker="o", markersize=3, linewidth=1.2, label=label)
        plotted = True
    if not plotted:
        ax.set_axis_off()
        return False
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("run (oldest → newest)")
    ax.set_ylabel(ylabel)
    ax.grid(color="#dddddd", linewidth=0.6, zorder=0)
    ax.spines[["top", "right"]].set_visible(False)
    ax.legend(fontsize=7, frameon=False)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("results", help="JSON-lines results file from the harness")
    ap.add_argument("-o", "--out-dir", default="charts")
    ap.add_argument("--kernels", action="store_true",
                    help="results file is a `bench kernels` sweep (e.g. "
                         "KERNELS_CUDA.jsonl); draw the kernel families instead")
    args = ap.parse_args(argv)

    records = load_records(args.results)
    if not records:
        print("no records found", file=sys.stderr)
        return 1
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("charts need matplotlib, which is not installed; the records and "
              "`bench report-html`'s tables carry the numbers", file=sys.stderr)
        return 2

    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if args.kernels:
        points = _kernel_points(records)
        fig, ax = plt.subplots(figsize=(max(6.0, 1.6 * len(points)), 4.5))
        if not kernels_chart(records, ax, points):
            print("no kernel-sweep records found", file=sys.stderr)
            return 1
        fig.tight_layout()
        fig.savefig(out / "kernels.png", dpi=150)
        print(f"wrote {out / 'kernels.png'}")
        return 0

    fig, axes = plt.subplots(1, 3, figsize=(17, 5))
    throughput_chart(records, axes[0])
    breakdown_chart(records, axes[1])
    heatmap_chart(records, axes[2])
    fig.tight_layout()
    fig.savefig(out / "benchmark.png", dpi=150)
    print(f"wrote {out / 'benchmark.png'}")

    winners = heatmap_winner(records)
    if winners:
        from distributed_sddmm_tpu_torch.utils.atomic import atomic_write_json

        atomic_write_json(out / "winners.json", winners, indent=2, sort_keys=False)
        print(f"wrote {out / 'winners.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
