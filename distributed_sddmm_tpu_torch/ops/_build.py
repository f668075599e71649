"""Build the hand-written CUDA tile kernels at first use.

``nvcc`` compiles ``ops/csrc/*.cu`` into a shared library with a plain C
interface under ``distributed_sddmm_tpu_torch/_build/``, named by a hash
of the sources and flags, and ``ctypes`` loads it. Nothing is built at
import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of every C entry point in ``tile_kernels.cu``.
SIGNATURES = {
    "sddmm_tile": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "spmm_tile": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_tile": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
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


def build() -> dict:
    """Compile the kernels unless a library for these sources exists.
    Returns ``{"path", "seconds", "cached", "log"}``; ``log`` is nvcc's
    ptxas report (registers, spills) of a fresh build."""
    out = library_path()
    if out.is_file():
        return {"path": str(out), "seconds": 0.0, "cached": True, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "cached": False,
            "log": proc.stdout + proc.stderr}


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
