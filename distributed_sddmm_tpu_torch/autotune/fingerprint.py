"""Canonical problem fingerprints for plan-cache lookup (counterpart of
``autotune/fingerprint.py``).

A fingerprint is everything that decides which plan is best: the problem
(M, N, nnz, the nnz/row bucket, the heaviest row's bucket, R, type), the
machine (world size, the device kind and world kind, the kernel families
on offer) and the code (a hash of the sources that shape what a plan
runs). Two processes given the same inputs produce the same key: a
SHA-256 of the canonical JSON of the fields, never ``hash()``.

The nnz/row term is bucketed to the nearest power of two (regime
boundaries of the winner map are octave-scale); M, N and nnz stay exact.
The heaviest row's bucket is the port's own term: the banked kernels'
cost factor (``codegen/variants.py``) reads the heaviest row, so a plan
for a uniform matrix must not answer for a skewed one.

Only :func:`machine_signature` touches torch's runtime; the rest is plain
arithmetic on arguments.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import pathlib

import numpy as np

from distributed_sddmm_tpu_torch.utils.buckets import pow2_at_least, pow2_bucket

_PKG = pathlib.Path(__file__).resolve().parents[1]

#: Fingerprint field-schema generation. Bump when the field set or a
#: bucketing rule changes, so stale cache entries cannot alias new keys.
FINGERPRINT_VERSION = 1

#: The sources a plan's execution depends on: the strategies, the comm
#: and wire layers, the kernels (the CUDA sources too: a kernel edit
#: changes what a plan runs) and the banked variants.
CODE_GLOBS = ("ops/*.py", "ops/csrc/*.cu", "ops/csrc/*.cuh", "parallel/*.py",
              "codegen/*.py")


@dataclasses.dataclass(frozen=True)
class Problem:
    """One SDDMM+SpMM workload: shape, nonzeros, inner dimension, type
    and, when known, the nonzeros of its heaviest row (0: unknown)."""

    M: int
    N: int
    nnz: int
    R: int
    dtype: str = "float32"
    row_max: int = 0

    @classmethod
    def from_coo(cls, S, R: int, dtype: str = "float32") -> "Problem":
        """Build from a :class:`~distributed_sddmm_tpu_torch.utils.coo.HostCOO`."""
        rows = np.asarray(S.rows)
        row_max = int(np.bincount(rows, minlength=1).max()) if rows.size else 0
        return cls(M=int(S.M), N=int(S.N), nnz=int(S.nnz), R=int(R), dtype=dtype,
                   row_max=row_max)

    @property
    def nnz_per_row(self) -> float:
        return self.nnz / max(self.M, 1)

    @property
    def npr_bucket(self) -> int:
        """nnz/row rounded to the nearest power of two (>= 1), by the
        shared rule the variant selector also uses."""
        return pow2_bucket(self.nnz_per_row)


def code_hash(root=None) -> str:
    """Hash of the sources of :data:`CODE_GLOBS` under the package
    ``root`` (default: this package, hashed once a process). The autotune
    modules, the apps and the benchmark are left out: editing selection
    logic does not change what an (algorithm, c, kernel) plan runs."""
    return _package_hash() if root is None else _hash_tree(pathlib.Path(root))


@functools.lru_cache(maxsize=1)
def _package_hash() -> str:
    return _hash_tree(_PKG)


def _hash_tree(base: pathlib.Path) -> str:
    h = hashlib.sha256()
    for pattern in CODE_GLOBS:
        for f in sorted(base.glob(pattern)):
            h.update(f.relative_to(base).as_posix().encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:12]


@functools.lru_cache(maxsize=1)
def models_code_hash() -> str:
    """Hash of the ``models/`` sources: what an app's step adds on top of
    a strategy, which :func:`code_hash` leaves out on purpose."""
    return _hash_globs(("models/*.py",))


@functools.lru_cache(maxsize=1)
def serve_code_hash() -> str:
    """Hash of the ``serve/`` sources, the code generation of a serving
    key (``programs/keys.py::serve_program_key``)."""
    return _hash_globs(("serve/*.py",))


def _hash_globs(patterns: tuple) -> str:
    h = hashlib.sha256()
    for pattern in patterns:
        for f in sorted(_PKG.glob(pattern)):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Canonical signature and stable key. ``fields`` is the exact tuple
    the key hashes; cached plans store it beside themselves."""

    fields: tuple
    key: str

    def as_dict(self) -> dict:
        return dict(self.fields)


def kernel_families(device, kernel: str | None = None) -> tuple[str, ...]:
    """The kernel families a plan may name on ``device``. On a card: the
    CUDA tile kernel at the precision ``kernel`` names (default
    ``cuda-bf16``, the port's), and nothing else: the tuner never trades
    precision for speed, and the plain ``torch`` kernel runs nothing of
    the main path where a card is. On the CPU: the CUDA family (default
    ``cuda-f32``, whose plain versions run there) and ``torch``, or
    ``torch`` alone when ``kernel`` names it."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if kernel == "torch":
            raise ValueError("the plain torch kernel is not a plan family on a card")
        return (kernel or "cuda-bf16",)
    if kernel == "torch":
        return ("torch",)
    return (kernel or "cuda-f32", "torch")


def machine_signature(world, device, kernel: str | None = None) -> tuple:
    """``(p, backend, kernel families)`` of a live world on ``device``.
    ``backend`` names the device kind and the world kind, e.g.
    ``cuda:NVIDIA H100 80GB HBM3:local`` (logical ranks on one card),
    ``cuda:NVIDIA H100 80GB HBM3:nccl`` or ``cpu:gloo``: a plan measured
    over logical ranks never answers for processes, nor for another
    card."""
    from distributed_sddmm_tpu_torch.obs.manifest import backend_name

    return world.p, backend_name(device, world), kernel_families(device, kernel)


def make_fingerprint(problem: Problem, p: int, backend: str,
                     kernels: tuple = ("cuda-f32", "torch"),
                     code: str | None = None,
                     capacity_bucket: bool = False) -> Fingerprint:
    """The canonical fingerprint of (problem, machine, code).

    ``capacity_bucket=True`` fingerprints the problem at its nnz's pow2
    capacity rung and adds a ``capacity_mode`` marker: every pattern whose
    nnz lands in one rung shares the plan of a capacity-sized build
    (``dynstruct/``), and such a fingerprint never collides with an exact
    one. Off, every field and key is as before."""
    fields = (
        ("fingerprint_version", FINGERPRINT_VERSION),
        ("M", problem.M),
        ("N", problem.N),
        ("nnz", pow2_at_least(problem.nnz) if capacity_bucket else problem.nnz),
        ("npr_bucket", problem.npr_bucket),
        ("row_max_bucket", pow2_bucket(problem.row_max) if problem.row_max else 0),
        ("R", problem.R),
        ("dtype", problem.dtype),
        ("p", int(p)),
        ("backend", str(backend)),
        ("kernels", tuple(sorted(kernels))),
        ("code_hash", code if code is not None else code_hash()),
    )
    if capacity_bucket:
        fields += (("capacity_mode", "pow2"),)
    blob = json.dumps(
        [[k, list(v) if isinstance(v, tuple) else v] for k, v in fields],
        separators=(",", ":"),
    )
    return Fingerprint(fields=fields, key=hashlib.sha256(blob.encode()).hexdigest()[:16])
