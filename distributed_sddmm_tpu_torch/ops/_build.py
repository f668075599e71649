"""Build the hand-written CUDA tile kernels at first use.

``nvcc`` compiles each ``ops/csrc/*.cu`` to an object, one process per
source, all started together, and links them into one shared library with
a plain C interface under ``distributed_sddmm_tpu_torch/_build/``, named
by a hash of the sources and flags; ``ctypes`` loads it. Nothing is built
at import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: Flags of each source's compile; the link adds ``-shared``.
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of every C entry point in ``ops/csrc/``.
SIGNATURES = {
    # tile_kernels.cu (row_ids null: every tile row; else a band's rows)
    "sddmm_tile": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "spmm_tile": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_tile": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # attn_kernels.cu
    "attn_stats_tile": [_P, _P, _P, _P, _P, _P, _I, _P],
    "attn_norm_tile": [_P, _P, _P, _P, _P, _P, _I, _P],
    # banked_kernels.cu
    "sddmm_split": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "spmm_split": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_split": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _P],
    "split_reduce": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "attn_stats_split": [_P, _P, _P, _P, _P, _P, _I, _P],
    "attn_stats_merge": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = pathlib.Path(home) / "bin" / "nvcc"
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA tile "
            "kernels cannot be built"
        )
    return nvcc


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Named by a hash of the flags, the sources and the shared headers
    (``*.cuh``), so an edit to either cannot load a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"tile_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise on the first that fails. Returns
    their output, concatenated."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build() -> dict:
    """Compile the kernels unless a library for these sources exists.
    Returns ``{"path", "seconds", "cached", "log"}``; ``log`` is nvcc's
    ptxas report (registers, spills) of the build, kept beside the library
    so that a cached build returns it too."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.is_file() and log_path.is_file():
        return {"path": str(out), "seconds": 0.0, "cached": True,
                "log": log_path.read_text()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [pathlib.Path(tmpdir) / f"{src.stem}.o" for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(_sources(), objs)])
        tmp = pathlib.Path(tmpdir) / out.name
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        (pathlib.Path(tmpdir) / log_path.name).write_text(log)
        os.replace(pathlib.Path(tmpdir) / log_path.name, log_path)
        os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "cached": False, "log": log}


def ptxas_report(log: str) -> dict:
    """Per function of ``log`` (``nvcc -Xptxas -v``), by mangled name:
    ``{"registers", "stack", "spill_stores", "spill_loads"}`` (the keys
    ptxas printed for it)."""
    report: dict = {}
    name = None
    for line in log.splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            name = m.group(1)
            report.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name is not None:
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            report[name]["registers"] = int(m.group(1))
    return report


_LIB = None


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tile_error_string.argtypes = [ctypes.c_int]
        lib.tile_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
