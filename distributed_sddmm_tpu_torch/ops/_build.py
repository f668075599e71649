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
    "sddmm_tile": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "spmm_tile": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_tile": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "attn_stats_tile": [_P, _P, _P, _P, _P, _I, _P],
    "attn_norm_tile": [_P, _P, _P, _P, _P, _P, _I, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
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
    ptxas report (registers, spills) of a fresh build."""
    out = library_path()
    if out.is_file():
        return {"path": str(out), "seconds": 0.0, "cached": True, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [pathlib.Path(tmpdir) / f"{src.stem}.o" for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(_sources(), objs)])
        tmp = pathlib.Path(tmpdir) / out.name
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "cached": False, "log": log}


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
