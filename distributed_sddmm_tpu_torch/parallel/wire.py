"""Wire precision: reduced-precision payload types for the collectives
(counterpart of ``parallel/wire.py``).

The 1.5D/2.5D strategies are bandwidth-bound by design (the whole ``c``
tradeoff of ``tools/costmodel.py`` is a words-moved argument), yet a
float32 payload crosses the link at 4 bytes an element. A
:class:`WirePolicy` names the type each collective ROLE uses **on the
wire only**: payloads are cast down at the collective boundary and cast
back right after (``parallel/loops.py``), and every accumulation stays
float32.

Roles -- the policy's unit is what a payload IS, not which collective
carries it:

``gather``
    Stationary-operand replication (``all_gather``). Input data; one
    rounding in all.
``ring``
    Ring-shifted payloads that the body only READS (the dense-shift
    moving operand, the sparse shift's mask and values, Cannon's rotating
    inputs). bf16 rounding is idempotent, so a payload that rides k hops
    is rounded ONCE, not k times.
``ring_accum``
    Traveling accumulators (the sparse shift's in-flight SDDMM dots,
    Cannon's rotating output). A downcast a hop would re-round a changing
    partial sum and compound with ring length, so the default bf16 policy
    keeps them f32 (override explicitly to trade exactness for bytes).
``reduce``
    Reduce-scatter partial sums. The reduction accumulates in the wire
    type, so the default bf16 policy keeps it f32; an explicit override
    buys the bf16 bytes at bf16 accumulation precision.

Always exact whatever the policy: integer tile structure (the casts only
touch float32 tensors) and the attention row-stat max/sum merge.

The f32 default is the identity: no cast runs, the key segment is empty
and results are bit-identical to a strategy built without ``wire=``. bf16
runs are deterministic (pure rounding).

Imports: stdlib only.
"""

from __future__ import annotations

import dataclasses
import os

#: Collective payload roles (module doc): replication gather, read-only
#: ring payloads, traveling accumulators, reduce-scatter partials.
ROLES = ("gather", "ring", "ring_accum", "reduce")

#: Wire types the policy understands, with their byte widths. f32 is the
#: identity wire; bf16 halves every payload it is applied to.
WIRE_DTYPES = {"f32": 4, "bf16": 2}

#: Environment variables of the process default (:func:`wire_policy`).
WIRE_ENV = "SDDMM_TORCH_WIRE"
WIRE_OVERRIDES_ENV = "SDDMM_TORCH_WIRE_OVERRIDES"

#: Roles the ``bf16`` comm_dtype applies to by default. Accumulating
#: payloads (``ring_accum``, ``reduce``) stay f32 unless overridden.
_BF16_DEFAULT_ROLES = ("gather", "ring")


def wire_bytes(dtype: str) -> int:
    """Bytes an element of one wire type name."""
    return WIRE_DTYPES[dtype]


@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """Per-role wire types for one strategy's collectives.

    ``comm_dtype`` is the headline request (``f32`` | ``bf16``);
    ``overrides`` pins single roles, e.g. ``(("reduce", "bf16"),)`` to
    push the reduce-scatter down too, or ``(("ring", "f32"),)`` to keep
    the ring exact under an otherwise bf16 policy.
    """

    comm_dtype: str = "f32"
    overrides: tuple = ()

    def __post_init__(self):
        if self.comm_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unknown comm_dtype {self.comm_dtype!r}; "
                f"expected one of {sorted(WIRE_DTYPES)}"
            )
        for role, dt in self.overrides:
            if role not in ROLES:
                raise ValueError(
                    f"unknown wire role {role!r}; expected one of {ROLES}"
                )
            if dt not in WIRE_DTYPES:
                raise ValueError(
                    f"unknown wire dtype {dt!r} for role {role!r}"
                )

    def dtype_for(self, role: str) -> str:
        """The wire type one role realizes under this policy."""
        if role not in ROLES:
            raise ValueError(
                f"unknown wire role {role!r}; expected one of {ROLES}"
            )
        for r, dt in self.overrides:
            if r == role:
                return dt
        if self.comm_dtype == "bf16" and role in _BF16_DEFAULT_ROLES:
            return "bf16"
        return "f32"

    def bytes_for(self, role: str) -> int:
        """Bytes a float element of one role pays on the wire."""
        return wire_bytes(self.dtype_for(role))

    def realized(self) -> dict:
        """``{role: dtype}``: the whole resolved map."""
        return {role: self.dtype_for(role) for role in ROLES}

    @property
    def name(self) -> str:
        """Coarse display label: ``f32`` when every role resolves f32,
        else the requested comm_dtype (``mixed`` for an f32 base with a
        bf16 override). Records use :attr:`label`, which keeps overrides
        apart."""
        if all(self.dtype_for(r) == "f32" for r in ROLES):
            return "f32"
        return self.comm_dtype if self.comm_dtype != "f32" else "mixed"

    @property
    def label(self) -> str:
        """The policy's identity in records: ``f32`` for the identity
        wire, else :meth:`key_segment` without its ``w`` prefix, role
        overrides included, so two policies with different numerics
        (``bf16`` and ``bf16.reduce=bf16``) never share a label."""
        seg = self.key_segment()
        return seg[1:] if seg else "f32"

    def key_segment(self) -> str:
        """Cache-key segment: ``""`` for the identity (f32 everywhere)
        policy, else ``w<dtype>`` plus the role overrides that differ from
        the comm_dtype's default map, dot-joined (printable, colon-free)."""
        realized = self.realized()
        if all(dt == "f32" for dt in realized.values()):
            return ""
        base = WirePolicy(self.comm_dtype)
        diff = [
            f"{role}={dt}" for role, dt in realized.items()
            if dt != base.dtype_for(role)
        ]
        seg = f"w{self.comm_dtype}"
        if diff:
            seg += "." + ".".join(sorted(diff))
        return seg


#: The identity policy (every payload f32).
F32 = WirePolicy("f32")
#: The standard reduced-precision policy: bf16 gather and ring payloads,
#: f32 accumulation everywhere.
BF16 = WirePolicy("bf16")


def _env_default() -> WirePolicy:
    """The process default: ``SDDMM_TORCH_WIRE`` names the comm dtype,
    ``SDDMM_TORCH_WIRE_OVERRIDES`` pins roles (a ``role=dtype`` comma
    list). Unset: the f32 identity wire."""
    dt = os.environ.get(WIRE_ENV, "f32").strip() or "f32"
    spec = os.environ.get(WIRE_OVERRIDES_ENV, "").strip()
    overrides = []
    if spec:
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            role, _, val = part.partition("=")
            overrides.append((role.strip(), val.strip()))
    return WirePolicy(dt, tuple(overrides))


def wire_policy(spec=None) -> WirePolicy:
    """Anything a ``wire=`` parameter takes, as a :class:`WirePolicy`: a
    policy passes through, a type name (``"f32"``/``"bf16"``) builds the
    standard policy, and None reads the environment defaults (the
    identity wire when unset)."""
    if spec is None:
        return _env_default()
    if isinstance(spec, WirePolicy):
        return spec
    if isinstance(spec, str):
        return WirePolicy(spec)
    raise TypeError(
        f"wire= expects a WirePolicy, a dtype name or None; got {spec!r}"
    )
