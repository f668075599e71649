"""The tuning-relevant description of a problem (counterpart of
``Problem`` in ``autotune/fingerprint.py``).

Only the problem terms are ported: the codegen variant selector keys on
them. The fingerprint keys, the code hash and the machine signature come
with the autotune subsystem.
"""

from __future__ import annotations

import dataclasses

from distributed_sddmm_tpu_torch.utils.buckets import pow2_bucket


@dataclasses.dataclass(frozen=True)
class Problem:
    """One SDDMM+SpMM workload: shape, nonzeros, inner dimension, type."""

    M: int
    N: int
    nnz: int
    R: int
    dtype: str = "float32"

    @classmethod
    def from_coo(cls, S, R: int, dtype: str = "float32") -> "Problem":
        """Build from a :class:`~distributed_sddmm_tpu_torch.utils.coo.HostCOO`."""
        return cls(M=int(S.M), N=int(S.N), nnz=int(S.nnz), R=int(R), dtype=dtype)

    @property
    def nnz_per_row(self) -> float:
        return self.nnz / max(self.M, 1)

    @property
    def npr_bucket(self) -> int:
        """nnz/row rounded to the nearest power of two (>= 1), by the
        shared rule the variant selector also uses."""
        return pow2_bucket(self.nnz_per_row)
