"""Fingerprint-keyed banked kernels (counterpart of ``codegen/``).

* ``codegen.variants`` -- the variant space: nnz/row band thresholds from
  the shared pow2 bucketing and the R regime, as stable ids
  ``v1.rb<thr>.<regime>`` that mean the same in both packages.
* ``codegen.banded`` -- each tile's rows split into the variant's bands,
  the heavy band's rows cut into segments.
* ``codegen.kernel`` -- :class:`BankedCudaKernel`, one CUDA launch per
  band with the split's two passes for the heavy band.

The JAX package's ``codegen.hlo`` structural gate checks compiled TPU HLO
and has no counterpart here; the port shows its launches by the kernel
wrappers' launch counts.
"""

from distributed_sddmm_tpu_torch.codegen.variants import (  # noqa: F401
    BandSpec,
    KernelVariant,
    select_variant,
    variant_from_id,
    variant_ids_for,
)
from distributed_sddmm_tpu_torch.codegen.banded import (  # noqa: F401
    SPLIT,
    Banding,
    RowBand,
    build_banded,
)
from distributed_sddmm_tpu_torch.codegen.kernel import (  # noqa: F401
    BankedCudaKernel,
    make_banked_kernel,
)
