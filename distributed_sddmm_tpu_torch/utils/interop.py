"""State carried across from the JAX package, as numpy arrays.

The JAX package exposes its state in host order: the sparse matrix as
``HostCOO`` fields, the dense operands through ``alg.host_a`` /
``alg.host_b`` and the nonzero values through ``alg.gather_s_values``.
:func:`state_from_reference` turns those arrays into the port's objects, so
both packages compute on identical inputs. Nothing here imports the JAX
package: only numpy arrays cross the boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.utils.coo import HostCOO


@dataclasses.dataclass
class CarriedState:
    S: HostCOO
    A: torch.Tensor       # [M, R] float32, host row order
    B: torch.Tensor       # [N, R] float32
    s_vals: torch.Tensor  # [nnz] float32, S's nonzero order


def state_from_reference(rows, cols, vals, M: int, N: int, A_host, B_host,
                         s_vals_host, device=None) -> CarriedState:
    dev = resolve_device(device)

    def dense(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    S = HostCOO(np.asarray(rows), np.asarray(cols), np.asarray(vals), M, N)
    s_vals = dense(s_vals_host)
    if s_vals.shape != (S.nnz,):
        raise ValueError(f"expected ({S.nnz},) values, got {tuple(s_vals.shape)}")
    return CarriedState(S=S, A=dense(A_host), B=dense(B_host), s_vals=s_vals)
