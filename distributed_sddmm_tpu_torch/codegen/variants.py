"""The kernel-variant space and its fingerprint-keyed selector
(counterpart of ``codegen/variants.py``).

A :class:`KernelVariant` names how a tile's rows are split into nnz/row
bands, each launched on its own. Variants are pure functions of the
problem's nnz/row bucket and R, so an id means the same row partition in
both packages and in every process.

The id grammar is ``v1.rb<thr>.<regime>``:

* ``v1`` -- the variant generation; any change to what an id derives
  bumps it, and an id of another generation raises.
* ``rb<thr>`` -- the short-band threshold: rows with nnz <= thr form the
  short band, rows with nnz <= 8*thr the mid band, the rest the heavy
  band. ``rb0`` is no banding.
* ``<regime>`` -- the R regime: ``rs`` (R <= 64), ``rm`` (up to 1023),
  ``rl`` (R >= 1024).

On the card a band is a list of tile rows (and, for the heavy band, the
rows cut into segments), not a TPU block. :class:`BandSpec` keeps the
JAX package's fields so that the two packages' variants compare equal:
``npr_max`` and ``body`` are what the port reads; ``block_rows``,
``block_cols``, ``group`` and ``max_block_cols`` are TPU chunk geometry
that the port carries and does not use.
"""

from __future__ import annotations

import dataclasses
import re

from distributed_sddmm_tpu_torch.utils.buckets import pow2_bucket

#: Bump on any change to what a variant id derives.
VARIANT_VERSION = 1

#: Per R regime, the TPU heavy band's (block_rows, block_cols, group).
_REGIMES = {
    "rs": (512, 512, 4),
    "rm": (512, 512, 4),
    "rl": (256, 256, 2),
}

#: Per R regime, the TPU cap on an auto-width band's column block.
_MAX_BAND_COLS = {
    "rs": 16384,
    "rm": 2048,
    "rl": 512,
}


def r_regime(R: int) -> str:
    """The R regime name of an inner dimension."""
    if R <= 64:
        return "rs"
    if R < 1024:
        return "rm"
    return "rl"


@dataclasses.dataclass(frozen=True)
class BandSpec:
    """One row band: rows with nnz <= ``npr_max`` (None: the residual
    heavy band) and the requested kernel-body style. ``block_rows``,
    ``block_cols``, ``group`` and ``max_block_cols`` are the TPU chunk
    geometry of the JAX package, carried and not used here."""

    npr_max: int | None
    block_rows: int
    block_cols: int
    group: int
    body: str  # "walk" | "batched" | "single"
    max_block_cols: int = 0


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """A resolved variant: its id and its band specs."""

    variant_id: str
    bands: tuple[BandSpec, ...]

    @property
    def banked(self) -> bool:
        return len(self.bands) > 1


def _bands_for(thr: int, regime: str) -> tuple[BandSpec, ...]:
    bm, bn, group = _REGIMES[regime]
    heavy = BandSpec(npr_max=None, block_rows=bm, block_cols=bn,
                     group=group, body="walk")
    if thr <= 0:
        return (heavy,)
    cap = _MAX_BAND_COLS[regime]
    short = BandSpec(npr_max=thr, block_rows=bm, block_cols=0,
                     group=1, body="batched", max_block_cols=cap)
    mid = BandSpec(npr_max=8 * thr, block_rows=bm, block_cols=0,
                   group=1, body="walk", max_block_cols=cap)
    return (short, mid, heavy)


_ID_RE = re.compile(r"^v(\d+)\.rb(\d+)\.(rs|rm|rl)$")


def variant_from_id(variant_id: str) -> KernelVariant:
    """The variant an id names. An id that does not parse, or of another
    generation, raises ``ValueError``."""
    m = _ID_RE.match(variant_id)
    if not m:
        raise ValueError(f"unparseable kernel variant id {variant_id!r}")
    version, thr, regime = int(m.group(1)), int(m.group(2)), m.group(3)
    if version != VARIANT_VERSION:
        raise ValueError(
            f"kernel variant generation v{version} != current "
            f"v{VARIANT_VERSION} ({variant_id!r})"
        )
    return KernelVariant(variant_id=variant_id, bands=_bands_for(thr, regime))


def select_variant(problem) -> KernelVariant:
    """The variant of one :class:`~distributed_sddmm_tpu_torch.autotune.
    fingerprint.Problem`: the short-band threshold is its nnz/row bucket;
    a bucket of 128 or more stops banding (``rb0``)."""
    thr = pow2_bucket(problem.nnz_per_row)
    if thr >= 128:
        thr = 0
    regime = r_regime(problem.R)
    vid = f"v{VARIANT_VERSION}.rb{thr}.{regime}"
    return KernelVariant(variant_id=vid, bands=_bands_for(thr, regime))


def variant_ids_for(problem) -> tuple[str, ...]:
    """Variant ids worth registering as tuning candidates: the selected
    one, unless it is a non-banked ``rs``/``rm`` variant, whose geometry
    is the generic kernel's."""
    v = select_variant(problem)
    if not v.banked and not v.variant_id.endswith(".rl"):
        return ()
    return (v.variant_id,)
