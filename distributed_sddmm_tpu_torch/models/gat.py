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
(``set_r_value``). Each head runs through the public ops with
``initial_shift`` / ``de_shift`` around them
(:meth:`GAT.compute_self_attention_head`). The counters follow the JAX
package's records: on ``DenseShift15D``, where the JAX package runs a
layer as one program, one ``gatLayer`` times each layer (the public ops
inside it run untimed); on the R-split strategies the per-op counters
show its sddmmA and spmmA. A ``gatLayer`` is charged one fused pair a
head at the layer's output width, as in the JAX package. With guards on
(``SDDMM_TORCH_GUARDS``, or a fault plan) every layer's output passes
``guard_output`` inside the layer, so on the dense shift a poisoned layer
is retried as a whole. The R-split path runs each layer under a
``gat:layer`` span, and the watchdog watches every layer's time
(``gat:layer<i>``); a strict alarm propagates out of ``forward``: GAT has
no cheaper rung to fall to.

The forward pass is differentiable in the weights on every strategy and
world: set ``requires_grad`` on ``layer.weights`` and call ``backward``
on a loss of the output (the tile ops' backward is ``ops/autograd.py``,
the collectives' ``parallel/comm.py``). Under a world of processes each
process holds its rows of the output and a copy of the weights, so the
loss is the sum of the processes' terms and the weight grads are summed
over the processes (an all-reduce, as data-parallel training does). As
in the JAX package there is no trainer or optimiser here.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from distributed_sddmm_tpu_torch.common import KernelMode, MatMode
from distributed_sddmm_tpu_torch.obs import trace as obs_trace
from distributed_sddmm_tpu_torch.obs import watchdog as obs_watchdog
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


def _leaky_relu(logits: torch.Tensor, alpha: float) -> torch.Tensor:
    """``max(l, 0) + min(l, 0) * alpha``, the JAX package's expression."""
    return logits.clamp(min=0) + logits.clamp(max=0) * alpha


def _no_mark(part: str, value=None) -> None:
    pass


class GAT:
    """A GAT over a square adjacency matrix on any strategy."""

    def __init__(self, layers: list[GATLayer], d_ops: DistributedSparse,
                 leaky_relu_alpha: float = 0.2, seed: int = 0):
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
        #: The autotune plan the strategy was built on (``from_plan``).
        self.plan = None
        # One gatLayer a layer where the JAX package runs it as one
        # program: the strategy whose blocks hold whole rows.
        self._unit = not d_ops.r_split
        # The SDDMM's unit values and the SpMM's zero base (a width each),
        # built once: the ops never write into them.
        self._ones_vals: torch.Tensor | None = None
        self._zeros: dict = {}
        gen = torch.Generator(device=d_ops.device).manual_seed(seed)
        for layer in layers:
            bound = 1.0 / math.sqrt(layer.input_features)
            layer.weights = [  # never reuse weights from another GAT
                (torch.rand((layer.input_features, layer.features_per_head), generator=gen,
                            dtype=d_ops.dtype, device=d_ops.device) * 2 - 1) * bound
                for _ in range(layer.num_heads)]

    @classmethod
    def from_plan(cls, S, layers: list[GATLayer], plan=None, world=None, device=None,
                  plan_mode: str = "model", **kw) -> "GAT":
        """A GAT on an autotune-selected strategy, R fingerprinted at the
        first layer's input width. ``plan=None`` asks the plan cache and
        the cost model (``autotune.get_plan``); the plan is kept on
        ``self.plan``."""
        from distributed_sddmm_tpu_torch.autotune import Problem, get_plan

        R = layers[0].input_features
        if plan is None:
            plan = get_plan(Problem.from_coo(S, R), world, S=S, device=device,
                            mode=plan_mode)
        model = cls(layers, plan.instantiate(S, R=R, world=world, device=device), **kw)
        model.plan = plan
        return model

    def compute_self_attention_head(self, X: torch.Tensor, i: int, j: int,
                                    mark=_no_mark) -> torch.Tensor:
        """Head ``j`` of layer ``i`` through the public ops: projection,
        SDDMM, LeakyReLU, SpMM into a fresh output, ReLU. B is A (M == N),
        and SDDMM_A and SPMM_A share one shift, so the shifted ``B_s``
        serves the aggregation too; ``de_shift`` comes after the SpMM.
        ``mark(part, out)`` is called after each part is issued, with its
        output (a timing hook; it does nothing by default)."""
        d, alpha = self.d_ops, self.leaky_relu_alpha
        if self._ones_vals is None:
            self._ones_vals = d.like_s_values(1.0)
        d.set_r_value(self.layers[i].input_features)
        A = d.dense_project(X, self.layers[i].weights[j], MatMode.A)
        mark("projection", A)
        A_s, B_s = d.initial_shift(A, A, KernelMode.SDDMM_A)
        logits = d.sddmm_a(A_s, B_s, self._ones_vals)
        mark("sddmm", logits)
        att = _leaky_relu(logits, alpha)
        mark("leaky_relu", att)
        if d.R not in self._zeros:
            self._zeros[d.R] = d.like_a_matrix(0.0)
        h = d.spmm_a(self._zeros[d.R], B_s, att)
        h, _ = d.de_shift(h, None, KernelMode.SPMM_A)
        mark("spmm", h)
        out = torch.relu(h)
        mark("relu", out)
        return out

    def layer_forward(self, i: int, X: torch.Tensor, mark=_no_mark) -> torch.Tensor:
        """Every head of layer ``i`` and their concat (``mark("concat",
        out)`` after it); the strategy's R becomes the layer's output
        width. One ``gatLayer`` on the dense shift, the public ops'
        counters elsewhere. With guards on, the output passes the
        ``gat:layer<i>`` sentinel (raise or repair)."""
        d, layer_spec = self.d_ops, self.layers[i]
        guarding = guards.enabled()

        def layer():
            heads = [self.compute_self_attention_head(X, i, j, mark)
                     for j in range(len(layer_spec.weights))]
            out = d.concat_heads(heads, MatMode.A)
            mark("concat", out)
            # A poisoned activation raises (naming the layer) or is
            # repaired; it never feeds the next layer silently.
            return guards.guard_output(f"gat:layer{i}", out) if guarding else out

        if self._unit:
            d.set_r_value(layer_spec.output_features)
            return d._timed("gatLayer", layer, _pairs=float(layer_spec.num_heads))
        with obs_trace.span("gat:layer", layer=i, heads=layer_spec.num_heads):
            return layer()

    def default_input(self) -> torch.Tensor:
        """The deterministic dummy fill ``(row * R + col) / (M * R)`` with
        R = ``layers[0].input_features``, in A's layout."""
        d, R = self.d_ops, self.layers[0].input_features
        d.set_r_value(R)
        return d.dummy_initialize(MatMode.A) * (1.0 / (d.M * R))

    def forward(self, X: torch.Tensor | None = None) -> torch.Tensor:
        """The whole forward pass, a :meth:`layer_forward` a layer. ``X``:
        node features in A's layout with R = ``layers[0].input_features``;
        by default :meth:`default_input`."""
        if X is None:
            X = self.default_input()
        wd = obs_watchdog.active()
        for i in range(len(self.layers)):
            t_layer = time.perf_counter()
            X = self.layer_forward(i, X)
            if wd is not None:
                # Keyed a layer: layers differ in width and heads.
                wd.observe(f"gat:layer{i}", time.perf_counter() - t_layer)
        return X

    def node_embeddings(self, X: torch.Tensor | None = None) -> np.ndarray:
        """The final layer's embeddings ``(M, output_features)`` in global
        row and column order on the host (``host_a`` puts an R-split
        layout's columns back in order)."""
        d = self.d_ops
        out = self.forward(X)
        d.set_r_value(self.layers[-1].output_features)
        return d.host_a(out)

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
