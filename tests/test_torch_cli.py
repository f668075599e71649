"""The port's benchmark command line, ``python -m
distributed_sddmm_tpu_torch.bench er ...``, on the CPU: one JSON summary
line per run, the full record appended to ``-o``, unported flags and apps
refused."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from distributed_sddmm_tpu_torch.bench import cli

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "distributed_sddmm_tpu_torch.bench",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


def test_er_attention_subprocess_prints_one_json_line():
    proc = _run("er", "6", "4", "15d_fusion2", "8", "1", "--app", "attention",
                "--mask", "window:4", "--device", "cpu", "--kernel", "torch")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert summary["algorithm"] == "15d_fusion2" and summary["fused"] is True
    assert summary["GFLOPs"] > 0


def test_er_refuses_flags_that_are_not_ported():
    proc = _run("er", "6", "4", "15d_fusion2", "8", "1", "--device", "cpu",
                "--trace")
    assert proc.returncode == 2 and "--trace" in proc.stderr


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


def test_er_unported_app_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A items 8-9"):
        cli.main(["er", "5", "4", "15d_fusion2", "4", "1", "--device", "cpu",
                  "--app", "als"])
