"""Multi-head graph attention network, forward pass (counterpart of
``models/gat.py``).

Per layer and head:

1. the local projection ``A_h = X @ W`` (``dense_project``);
2. the SDDMM at the adjacency pattern: attention logits;
3. LeakyReLU on the edge values;
4. the SpMM aggregation into a fresh output;
5. ReLU; the heads are concatenated on the feature dimension.

As in the JAX package: the weights are scaled-uniform random
(``±1/sqrt(input_features)``, from a ``torch.Generator`` seeded with
``seed``; the draws cannot equal ``jax.random``'s), the aggregation is a
fresh ``S_att @ A_h``, and the strategy's R follows each layer's widths
(``set_r_value``). A whole layer runs as one unit on the strategy's raw
``sddmm_program`` / ``spmm_program`` accessors, timed once as the
``gatLayer`` op; a strategy without them, or with skews around its public
ops, is refused: the three R-split strategies are ROADMAP.md, queue A
item 10b.
With guards on (``SDDMM_TORCH_GUARDS``) every layer's output passes
``guard_output``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.parallel.base import DistributedSparse
from distributed_sddmm_tpu_torch.resilience import guards


@dataclasses.dataclass
class GATLayer:
    """A layer's widths; :class:`GAT` fills ``weights``, one
    ``(input_features, features_per_head)`` tensor a head."""

    input_features: int
    features_per_head: int
    num_heads: int
    weights: list = dataclasses.field(default_factory=list)

    @property
    def output_features(self) -> int:
        return self.features_per_head * self.num_heads


def _supports_programs(d_ops: DistributedSparse) -> bool:
    """True when the strategy has the raw SDDMM and SpMM accessors and needs
    no pre- or post-skew: then a whole layer runs as one unit."""
    return (hasattr(d_ops, "sddmm_program") and hasattr(d_ops, "spmm_program")
            and type(d_ops).initial_shift is DistributedSparse.initial_shift
            and type(d_ops).de_shift is DistributedSparse.de_shift)


def _leaky_relu(logits: torch.Tensor, alpha: float) -> torch.Tensor:
    """``max(l, 0) + min(l, 0) * alpha``, the JAX package's expression."""
    return logits.clamp(min=0) + logits.clamp(max=0) * alpha


def _no_mark(part: str) -> None:
    pass


class GAT:
    """A GAT over a square adjacency matrix on a strategy that
    :func:`_supports_programs` accepts (``DenseShift15D``)."""

    def __init__(self, layers: list[GATLayer], d_ops: DistributedSparse,
                 leaky_relu_alpha: float = 0.2, seed: int = 0):
        if not _supports_programs(d_ops):
            raise NotImplementedError(
                f"{type(d_ops).__name__} has no sddmm_program/spmm_program or skews its "
                "operands; GAT runs on DenseShift15D (the apps on the R-split "
                "strategies are ROADMAP.md, queue A item 10b)")
        if d_ops.M != d_ops.N:
            raise ValueError("GAT requires a square adjacency matrix")
        if not layers:
            raise ValueError("need at least one layer")
        for i in range(1, len(layers)):
            if layers[i].input_features != layers[i - 1].output_features:
                raise ValueError(
                    f"layer {i} input_features {layers[i].input_features} != "
                    f"layer {i - 1} output {layers[i - 1].output_features}")
        self.d_ops = d_ops
        self.layers = layers
        self.leaky_relu_alpha = leaky_relu_alpha
        self._head = None
        gen = torch.Generator(device=d_ops.device).manual_seed(seed)
        for layer in layers:
            bound = 1.0 / math.sqrt(layer.input_features)
            layer.weights = [  # never reuse weights from another GAT
                (torch.rand((layer.input_features, layer.features_per_head), generator=gen,
                            dtype=d_ops.dtype, device=d_ops.device) * 2 - 1) * bound
                for _ in range(layer.num_heads)]

    def _head_program(self):
        """``f(X, w, mark) -> relu(spmm(A, leaky_relu(sddmm(A, A))))`` with
        ``A = X @ w``: one head on the strategy's raw accessors (A == B, as
        M == N). ``mark(part)`` is called after each part is issued (a
        timing hook; it does nothing by default)."""
        if self._head is None:
            d, mode, alpha = self.d_ops, MatMode.A, self.leaky_relu_alpha
            sddmm, spmm = d.sddmm_program(mode), d.spmm_program(mode)
            ones = d.like_s_values(1.0)

            def head(X, w, mark=_no_mark):
                A = d.dense_project(X, w, mode)
                mark("projection")
                logits = sddmm(A, A, ones)
                mark("sddmm")
                att = _leaky_relu(logits, alpha)
                mark("leaky_relu")
                h = spmm(A, att)
                mark("spmm")
                out = torch.relu(h)
                mark("relu")
                return out

            self._head = head
        return self._head

    def compute_self_attention_head(self, X: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """Head ``j`` of layer ``i``: projection, SDDMM, LeakyReLU, SpMM,
        ReLU."""
        return self._head_program()(X, self.layers[i].weights[j])

    def layer_forward(self, i: int, X: torch.Tensor, mark=_no_mark) -> torch.Tensor:
        """Every head of layer ``i`` and their concat (``mark("concat")``
        after it); the strategy's R becomes the layer's output width."""
        head = self._head_program()
        out = self.d_ops.concat_heads([head(X, w, mark) for w in self.layers[i].weights],
                                      MatMode.A)
        mark("concat")
        return out

    def default_input(self) -> torch.Tensor:
        """The deterministic dummy fill ``(row * R + col) / (M * R)`` with
        R = ``layers[0].input_features``, in A's layout."""
        d, R = self.d_ops, self.layers[0].input_features
        d.set_r_value(R)
        return d.dummy_initialize(MatMode.A) * (1.0 / (d.M * R))

    def forward(self, X: torch.Tensor | None = None) -> torch.Tensor:
        """The whole forward pass, one ``gatLayer`` a layer. ``X``: node
        features in A's layout with R = ``layers[0].input_features``; by
        default :meth:`default_input`."""
        if X is None:
            X = self.default_input()
        guarding = guards.enabled()
        for i in range(len(self.layers)):
            X = self.d_ops._timed("gatLayer", self.layer_forward, i, X)
            if guarding:
                # A poisoned activation raises (naming the layer) or is
                # repaired, per SDDMM_TORCH_GUARD_MODE; it never feeds the
                # next layer silently.
                X = guards.guard_output(f"gat:layer{i}", X)
        return X

    def node_embeddings(self, X: torch.Tensor | None = None) -> np.ndarray:
        """The final layer's embeddings ``(M, output_features)`` in global
        row and column order on the host."""
        d = self.d_ops
        out = self.forward(X)
        d.set_r_value(self.layers[-1].output_features)
        return d.host_a(d._unskew_cols(out, MatMode.A))

    # -------------------------- parameter checkpoints ---------------------- #

    def save_checkpoint(self, store, step: int = 0) -> None:
        """Persist every head's projection weights (``w_{layer}_{head}``;
        process 0 writes under a world of processes)."""
        if self.d_ops.world.process_index != 0:
            return
        arrays = {f"w_{i}_{j}": w.detach().cpu().numpy()
                  for i, layer in enumerate(self.layers)
                  for j, w in enumerate(layer.weights)}
        store.save(step, arrays,
                   meta={"kind": "gat", "heads": [layer.num_heads for layer in self.layers]})

    def load_checkpoint(self, store) -> bool:
        """Restore the weights from the newest valid checkpoint; False when
        there is none, or it belongs to another app or shape."""
        loaded = store.load_latest()
        if loaded is None:
            return False
        _, arrays, meta = loaded
        if meta and meta.get("kind") not in (None, "gat"):
            return False
        want = {f"w_{i}_{j}" for i, layer in enumerate(self.layers)
                for j in range(layer.num_heads)}
        if not want.issubset(arrays):
            return False
        d = self.d_ops
        for i, layer in enumerate(self.layers):
            layer.weights = [torch.as_tensor(arrays[f"w_{i}_{j}"], dtype=d.dtype, device=d.device)
                             for j in range(layer.num_heads)]
        return True
