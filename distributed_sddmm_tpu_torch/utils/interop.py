"""State carried across from the JAX package, as numpy arrays.

The JAX package exposes its state in host order: the sparse matrix as
``HostCOO`` fields, the dense operands through ``alg.host_a`` /
``alg.host_b`` and the nonzero values through ``alg.gather_s_values``.
:func:`state_from_reference` turns those arrays into the port's objects, so
both packages compute on identical inputs; :func:`als_state_from_reference`
and :func:`gat_weights_from_reference` do the same for the apps, whose
random draws (``jax.random`` there, ``torch.Generator`` here) cannot agree.
The arrays are in host order (global rows and columns), so they land in
any strategy's layout through its ``put_a`` / ``put_b`` /
``scatter_s_values`` (an R-split strategy's blocks, a Cannon strategy's
skewed slices and transposed values included), and a GAT's weights, in
global column order, through ``dense_project``. Nothing here imports the
JAX package: only numpy arrays cross the boundary.
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


@dataclasses.dataclass
class CarriedALS:
    """An ALS model's state in host order: the factors and the
    observations in S's and S^T's nonzero orders."""

    A: np.ndarray      # [M, R] float32
    B: np.ndarray      # [N, R] float32
    obs: np.ndarray    # [nnz] float32, S's nonzero order
    obs_t: np.ndarray  # [nnz] float32, S^T's nonzero order

    def model(self, d_ops, **kw):
        """A port ``DistributedALS`` on ``d_ops`` (any strategy) observing
        ``obs`` (no artificial ground truth) with the factors set to ``A``
        and ``B`` in its layout."""
        from distributed_sddmm_tpu_torch.models.als import DistributedALS

        als = DistributedALS(d_ops, artificial_groundtruth=False, ground_truth_vals=self.obs,
                             ground_truth_vals_transpose=self.obs_t, **kw)
        als.A, als.B = d_ops.put_a(self.A), d_ops.put_b(self.B)
        return als


def als_state_from_reference(A_host, B_host, obs, obs_t) -> CarriedALS:
    """The JAX model's state: ``A``/``B`` from its strategy's ``host_a`` /
    ``host_b``, the observations from ``gather_s_values`` /
    ``gather_st_values`` of its ``ground_truth`` and
    ``ground_truth_transpose``."""
    state = CarriedALS(*(np.array(x, dtype=np.float32) for x in (A_host, B_host, obs, obs_t)))
    if state.A.shape[1] != state.B.shape[1] or state.obs.shape != state.obs_t.shape:
        raise ValueError(f"inconsistent ALS state: A {state.A.shape}, B {state.B.shape}, "
                         f"obs {state.obs.shape}, obs_t {state.obs_t.shape}")
    return state


def gat_weights_from_reference(weights, device=None) -> list:
    """The JAX GAT's weights (one list of ``(R_in, R_head)`` arrays a
    layer, ``np.asarray`` of each ``layer.weights``) as float32 tensors on
    ``device``, to assign to the port's ``layer.weights``."""
    dev = resolve_device(device)
    return [[torch.from_numpy(np.array(w, dtype=np.float32)).to(dev) for w in layer]
            for layer in weights]
