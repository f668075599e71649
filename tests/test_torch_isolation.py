"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse a missing CUDA card instead of falling back, and
``chip_smoke.py`` fails without a card.

The import checks run in a fresh interpreter, because this test process
has JAX loaded already (``tests/conftest.py``).
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_sddmm_tpu_torch.autotune import Problem, get_plan
from distributed_sddmm_tpu_torch.bench import cli, harness
from distributed_sddmm_tpu_torch.bench import kernels as kernel_bench
from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel
from distributed_sddmm_tpu_torch.models.als import DistributedALS
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.serve import AttentionTokenScore, build_als_engine
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.interop import state_from_reference
from distributed_sddmm_tpu_torch.utils.verify import verify_algorithms

# Benchmarks here write no run document into the checkout's default store.
os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_sddmm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "distributed_sddmm_tpu")


def _port_modules() -> list[str]:
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def _clean_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_and_chip_smoke_import_no_jax_in_subprocess():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps({'bad': bad, 'n': len(" f"{mods!r}" ")}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "n": len(mods)}
    assert len(mods) > 15  # every module of the slice was imported
    for mod in ("parallel.sparse_shift_15d", "parallel.cannon_dense_25d",
                "parallel.cannon_sparse_25d", "tools.costmodel", "bench.kernels",
                "bench.baseline", "utils.coo", "utils.verify", "parallel.wire",
                "resilience.retry", "obs.metrics", "autotune.fingerprint",
                "autotune.candidates", "autotune.measure", "autotune.cache",
                "autotune.plan", "autotune", "obs.clock", "obs.trace", "obs.log",
                "obs.manifest", "obs.profiler", "obs.watchdog", "obs.flightrec",
                "resilience.faults", "obs.store", "obs.regress", "obs.report",
                "obs.tracemerge", "obs.traceexport", "tools.tracereport", "tools.charts",
                "utils.buckets", "programs", "programs.keys", "programs.store",
                "dynstruct", "dynstruct.capacity", "dynstruct.rebind", "serve",
                "serve.queue", "serve.slo", "serve.workloads", "serve.engine",
                "obs.telemetry", "ops.serve_kernels", "obs.httpexp", "tuner", "tuner.signals",
                "tuner.retune", "tuner.shadow", "tuner.loop"):
        assert f"distributed_sddmm_tpu_torch.{mod}" in mods


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_ast_scan_finds_no_forbidden_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & set(FORBIDDEN))
                 for f in files}
    assert {k: v for k, v in offenders.items() if v} == {}
    # And every import the port makes is one the card's machine has
    # (matrix-market files go through ``scipy.io``).
    allowed = {"torch", "numpy", "scipy", "distributed_sddmm_tpu_torch",
               "__future__", "abc", "argparse", "base64", "collections", "contextlib",
               "ctypes", "dataclasses", "enum", "errno", "fcntl", "fnmatch", "functools",
               "hashlib", "html", "http", "importlib", "inspect", "io", "itertools", "json",
               "logging", "math",
               "multiprocessing", "os", "pathlib", "random", "re", "shutil", "signal",
               "statistics", "subprocess", "sys", "tempfile", "threading", "time", "typing",
               "urllib", "zipfile"}
    used = set().union(*(_guarded_roots(f, keep=False) for f in files))
    assert used <= allowed, used - allowed
    # The card's machine has no matplotlib: the charts import it only under a
    # ``try`` that handles its ImportError.
    optional = set().union(*(_guarded_roots(f, keep=True) for f in files))
    assert optional <= {"matplotlib", "fcntl"}, optional


def _guarded_roots(path: pathlib.Path, keep: bool) -> set:
    """The imported roots of ``path`` inside (``keep``) or outside a ``try``
    whose handlers catch ImportError."""
    tree = ast.parse(path.read_text())
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                isinstance(h.type, ast.Name) and h.type.id == "ImportError"
                for h in node.handlers):
            for stmt in node.body:
                guarded |= {id(n) for n in ast.walk(stmt)}
    roots = set()
    for node in ast.walk(tree):
        if (id(node) in guarded) != keep:
            continue
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a machine without one")
    S = HostCOO(np.array([0, 1]), np.array([1, 0]), np.ones(2), 2, 2)
    for build in (
        lambda: DenseShift15D(S, R=4),
        lambda: harness.make_algorithm("15d_fusion2", S, 4),
        lambda: harness.make_algorithm("15d_sparse", S, 4),
        lambda: harness.make_algorithm("25d_dense_replicate", S, 4),
        lambda: harness.make_algorithm("25d_sparse_replicate", S, 4),
        lambda: CudaTileKernel(),
        lambda: BankedCudaKernel("v1.rb4.rs"),
        lambda: state_from_reference(S.rows, S.cols, S.vals, 2, 2, np.zeros((2, 4)),
                                     np.zeros((2, 4)), S.vals),
        lambda: kernel_bench.bench_one(S, 4, "torch", 1, None),
        lambda: verify_algorithms(S=S, R=4),
        lambda: cli.main(["verify"]),
        lambda: cli.main(["er", "4", "2", "15d_fusion2", "4", "1"]),
        lambda: HostCOO.rmat(4, 2, device="cuda"),
        lambda: cli.main(["er", "4", "2", "auto", "4", "1", "--plan-mode", "model"]),
        lambda: get_plan(Problem.from_coo(S, 4), mode="model"),
        lambda: DistributedALS.from_plan(S, 4),
        lambda: cli.main(["serve"]),
        lambda: build_als_engine(S, R=4),
        lambda: AttentionTokenScore(np.zeros((4, 4), np.float32)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = _clean_env()
    env["PYTHONPATH"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
