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

from distributed_sddmm_tpu_torch.bench import harness
from distributed_sddmm_tpu_torch.codegen import BankedCudaKernel
from distributed_sddmm_tpu_torch.ops.cuda_kernels import CudaTileKernel
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.interop import state_from_reference

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
                "parallel.cannon_sparse_25d", "tools.costmodel"):
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
    # And every import the port makes is one the card's machine has.
    allowed = {"torch", "numpy", "scipy", "distributed_sddmm_tpu_torch",
               "__future__", "abc", "argparse", "contextlib", "ctypes", "dataclasses", "enum",
               "functools", "hashlib", "importlib", "inspect", "io", "json", "logging", "math",
               "multiprocessing", "os", "pathlib", "re", "shutil", "subprocess", "sys",
               "tempfile", "time", "typing", "zipfile"}
    used = set().union(*(_imported_roots(f) for f in files))
    assert used <= allowed, used - allowed


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
