"""Program-store keys: one grammar for every persistent cache of the
port (counterpart of ``programs/keys.py``).

The rules are the plan cache's (``autotune/fingerprint.py``):

* a key is a pure function of (problem, machine, code generation): the
  same inputs in two processes give the same key, which cross-process
  reuse depends on;
* the code generation is in the key (``code_hash`` for what ``ops/``,
  ``parallel/`` and ``codegen/`` shape, ``serve_code_hash`` for serving),
  so a stale entry never answers for new code;
* a signature of the arguments (:func:`sig_for_args`) is in the key.

Keys are colon-joined printable segments, file-name safe after
:func:`safe_stem`; every builder has a parser, and a key built from the
same inputs is the JAX package's, character for character. The bench AOT
key of the JAX package has no port: the port's nvcc build is keyed by its
sources already (``ops/_build.py``).

Standard library only, but for :func:`dist_segment`'s look at the pod
identity (``dist/init.py``).
"""

from __future__ import annotations

import hashlib
import re

_SEG_RE = re.compile(r"^[A-Za-z0-9._=+-]+$")


def _seg(value) -> str:
    """One key segment: printable and colon-free, or content-hashed."""
    s = str(value)
    if _SEG_RE.match(s):
        return s
    return "h" + hashlib.sha256(s.encode()).hexdigest()[:12]


def sig_for_args(args) -> str:
    """Short stable hash of the arguments' shapes and dtypes, in order:
    anything with ``shape`` and ``dtype`` (numpy arrays, tensors)."""
    parts = []
    for a in args:
        shape = tuple(getattr(a, "shape", ()))
        dtype = str(getattr(a, "dtype", type(a).__name__))
        parts.append(f"{shape}{dtype}")
    return hashlib.sha256(";".join(parts).encode()).hexdigest()[:10]


# --------------------------------------------------------------------- #
# Plan-routed strategy set-ups (autotune Plan.instantiate)
# --------------------------------------------------------------------- #


def dist_segment(num_processes: int | None = None,
                 process_index: int | None = None, world=None) -> str:
    """The multi-process key segment: ``dN.pK`` for process ``K`` of an
    ``N``-process pod, ``""`` in one process (so single-process keys have
    no trailing segment). A process's set-up is its own ranks', so process
    K of an N-process pod warm-starts only from entries that process K of
    an N-process pod wrote. The defaults come from ``world`` (a
    ``LocalWorld`` or ``DistWorld`` of ``parallel/comm.py``) when it spans
    processes, else from ``dist.init.pod_info`` (a live group of more
    than one rank, else the pod launcher's labels, else one process)."""
    if num_processes is None:
        if world is not None and world.num_processes > 1:
            num_processes, process_index = world.num_processes, world.process_index
        else:
            from distributed_sddmm_tpu_torch.dist.init import pod_info

            ctx = pod_info()
            num_processes, process_index = ctx.num_processes, ctx.process_index
    if not num_processes or int(num_processes) <= 1:
        return ""
    if process_index is None:
        # A default slot would give every caller 'dN.p0': the aliasing
        # this segment exists to prevent.
        raise ValueError(
            "dist_segment: multi-process segment needs an explicit "
            "process_index"
        )
    return f"d{int(num_processes)}.p{int(process_index)}"


def parse_dist_segment(seg: str) -> dict | None:
    """``dN.pK`` -> ``{"num_processes", "process_index"}`` (None when
    the segment is not dist-shaped)."""
    m = re.match(r"^d(\d+)\.p(\d+)$", seg)
    if not m:
        return None
    return {"num_processes": int(m.group(1)),
            "process_index": int(m.group(2))}


def plan_program_key(
    fingerprint_key: str,
    op: str,
    sig: str,
    backend: str,
    code: str | None = None,
    dist: str | None = None,
) -> str:
    """Key of one strategy's set-up under an autotune plan.

    ``fingerprint_key`` is the plan's fingerprint (problem, machine and
    code hashed in); ``op`` names what is stored (the strategy's
    configuration and set-up segments); ``sig`` is :func:`sig_for_args`
    over the arguments. ``code`` defaults to ``autotune.fingerprint.
    code_hash()``, written out although the fingerprint covers it, so a
    key read back from the store names its generation. ``dist`` is the
    :func:`dist_segment` of the writing process, appended only with more
    than one process.
    """
    if code is None:
        from distributed_sddmm_tpu_torch.autotune.fingerprint import code_hash

        code = code_hash()
    key = ":".join(
        ("plan", _seg(fingerprint_key), _seg(op), _seg(sig),
         _seg(backend), _seg(code))
    )
    if dist:
        key += f":{_seg(dist)}"
    return key


def parse_plan_key(key: str) -> dict | None:
    parts = key.split(":")
    if len(parts) not in (6, 7) or parts[0] != "plan":
        return None
    out = dict(zip(
        ("family", "fingerprint_key", "op", "sig", "backend", "code_hash"),
        parts[:6],
    ))
    if len(parts) == 7:
        dist = parse_dist_segment(parts[6])
        if dist is None:
            return None
        out["dist"] = parts[6]
        out.update(dist)
    return out


# --------------------------------------------------------------------- #
# Serving bucket cells
# --------------------------------------------------------------------- #


def serve_program_key(
    workload: str,
    batch_bucket: int,
    inner_bucket: int,
    r,
    backend: str,
    code: str | None = None,
    params: str | None = None,
    sig: str | None = None,
    variant: str | None = None,
    wire: str | None = None,
    cap: str | None = None,
    dist: str | None = None,
) -> str:
    """Key of one serving bucket cell, ``serve:<workload>:b<bb>:i<ib>:
    r<R>:<backend>:<serve_code_hash>``, with optional trailing segments:
    ``p<params>`` (workload constants that change the program without
    changing an argument's shape), ``s<sig>`` (the arguments' signature),
    ``v<variant>`` (the codegen kernel variant), ``w<wire>`` (the warm
    strategy's wire-policy label, ``WirePolicy.label``, which keeps role
    overrides apart; None and "f32" append nothing), ``c<cap>`` (the capacity
    rungs of a dynamic-structure workload; static workloads append
    nothing, so a capacity key never aliases an exact one) and the
    :func:`dist_segment` of the writing process."""
    if code is None:
        from distributed_sddmm_tpu_torch.autotune.fingerprint import serve_code_hash

        code = serve_code_hash()
    key = (
        f"serve:{_seg(workload)}:b{int(batch_bucket)}:i{int(inner_bucket)}"
        f":r{_seg(r)}:{_seg(backend)}:{_seg(code)}"
    )
    if params:
        key += f":p{_seg(params)}"
    if sig:
        key += f":s{_seg(sig)}"
    if variant:
        key += f":v{_seg(variant)}"
    if wire and wire != "f32":
        key += f":w{_seg(wire)}"
    if cap:
        key += f":c{_seg(cap)}"
    if dist:
        key += f":{_seg(dist)}"
    return key


def parse_serve_key(key: str) -> dict | None:
    parts = key.split(":")
    if not (7 <= len(parts) <= 13) or parts[0] != "serve":
        return None
    if not (parts[2].startswith("b") and parts[3].startswith("i")
            and parts[4].startswith("r")):
        return None
    out = {
        "family": "serve",
        "workload": parts[1],
        "batch_bucket": int(parts[2][1:]),
        "inner_bucket": int(parts[3][1:]),
        "r": parts[4][1:],
        "backend": parts[5],
        "code_hash": parts[6],
    }
    for extra in parts[7:]:
        dist = parse_dist_segment(extra)
        if dist is not None:
            out["dist"] = extra
            out.update(dist)
        elif extra.startswith("p"):
            out["params"] = extra[1:]
        elif extra.startswith("s"):
            out["sig"] = extra[1:]
        elif extra.startswith("v"):
            out["variant"] = extra[1:]
        elif extra.startswith("w"):
            out["wire"] = extra[1:]
        elif extra.startswith("c"):
            out["cap"] = extra[1:]
        else:
            return None
    return out


# --------------------------------------------------------------------- #
# Bench keys (parsed only: the port writes none)
# --------------------------------------------------------------------- #


def parse_bench_key(key: str) -> dict | None:
    parts = key.split(":")
    if len(parts) != 5 or parts[0] != "bench":
        return None
    try:
        n = int(parts[3])
    except ValueError:
        return None
    return {"family": "bench", "stem": parts[1], "name": parts[2],
            "n": n, "backend": parts[4]}


# --------------------------------------------------------------------- #


def parse_key(key: str) -> dict | None:
    """Parse any store key; None when the grammar is unrecognized."""
    for parser in (parse_plan_key, parse_serve_key, parse_bench_key):
        out = parser(key)
        if out is not None:
            return out
    return None


def safe_stem(key: str) -> str:
    """Key -> file-name stem: colon separators become ``__``; anything
    else path-unsafe is hashed away by :func:`_seg` at build time. A
    trailing short hash of the FULL key disambiguates the (theoretical)
    collision of two keys mapping to one sanitized stem."""
    body = key.replace(":", "__")
    body = "".join(c if (c.isalnum() or c in "._=+-") else "_" for c in body)
    return f"{body[:140]}-{hashlib.sha256(key.encode()).hexdigest()[:8]}"
