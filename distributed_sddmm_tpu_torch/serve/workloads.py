"""Concrete serving endpoints: ALS fold-in top-k, attention token scoring
and GAT node scoring (counterpart of ``serve/workloads.py``).

All follow the contract the engine batches against
(:class:`ServingWorkload`): a request payload is a small dict, its inner
size (rated items, tokens, nodes) is bucketed apart from the batch
dimension, and the program of a ``(batch_bucket, inner_bucket)`` cell
computes every request row on its own, so a reply is a function of its
payload alone, not of the requests that shared its micro-batch or of the
padding.

A program here is the bound kernel call of one cell: the host arrays
:meth:`ServingWorkload.pad_batch` built go to the workload's device, the
hand-written kernels of ``ops/serve_kernels.py`` run on them (their plain
versions on a CPU device), and the outputs come back as device tensors of
the call's own, so a retried call never shares a buffer with a late
launch. Every per-request sum runs in a fixed order inside those kernels;
the rest is gathers, elementwise ops, index writes of one value and a
stable sort, none of which can make a request's bits depend on its
neighbours.

**ALS fold-in + top-k**: a new user's ratings are folded in against the
warm item factors B (the R x R ridge normal equation, solved by
:func:`~distributed_sddmm_tpu_torch.ops.serve_kernels.fold_in_solve`),
every item is scored against the user's factors, the rated items are
masked out and the top k returned; the served row is appended to the live
host matrix through :meth:`HostCOO.append_rows`.

**Attention token scoring**: the whole-sequence fused attention call runs
once at engine build, and its output rows are the cached context; a
request scores tokens by a masked softmax over each token's ``±w``
neighbourhood through a fixed head.

**GAT node scoring**: the whole-graph forward pass runs once and its
final embeddings are cached; a request gathers its nodes' rows and scores
them through a fixed head.
"""

from __future__ import annotations

import abc
import os
import threading
from typing import Optional

import numpy as np
import torch

from distributed_sddmm_tpu_torch.device import resolve_device
from distributed_sddmm_tpu_torch.ops import serve_kernels
from distributed_sddmm_tpu_torch.utils.buckets import bucket_for  # noqa: F401
from distributed_sddmm_tpu_torch.utils.coo import HostCOO

#: Default inner-size bucket ladders (powers of two keep the program count
#: logarithmic in the supported range), the JAX package's.
ALS_ITEM_BUCKETS = (8, 16, 32, 64)
GAT_NODE_BUCKETS = (1, 4, 16, 64)
ATTN_TOKEN_BUCKETS = (1, 4, 16, 64)

#: The default per-request window half-width of the attention endpoint.
ATTN_WINDOW_ENV = "SDDMM_TORCH_ATTN_SERVE_WINDOW"


def _model_kernel_variant(model) -> Optional[str]:
    """The warm model's realized codegen variant (None: generic), stamped
    into the ladder's keys so a ladder warmed under one specialization
    never answers for another; the rule bench records use."""
    from distributed_sddmm_tpu_torch.parallel.base import realized_kernel_variant

    return realized_kernel_variant(getattr(model, "d_ops", None))


def _model_wire(model_or_ops) -> Optional[str]:
    """The warm strategy's realized wire-policy label (``bf16``,
    ``bf16.reduce=bf16``, ...), or None for the f32 wire: the serve keys'
    ``w<label>`` segment, so a ladder warmed over a bf16-wire strategy
    never answers for an f32 one, and two bf16 policies that differ in a
    role never alias. Takes the model or the strategy itself."""
    ops = getattr(model_or_ops, "d_ops", model_or_ops)
    policy = getattr(ops, "wire", None)
    if policy is None:
        return None
    label = policy.label
    return None if label == "f32" else label


def top_k(scores, k: int) -> tuple:
    """``(values, ids)`` of each row's k largest scores, best first, ties
    broken by the lower id (``jax.lax.top_k``'s rule): a stable sort, which
    selects and computes nothing, so the values keep their bits."""
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _check_ids(ids, n: int, what: str) -> None:
    ids = np.asarray(ids)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"{what} ids must lie in [0, {n}), got {ids.min()}..{ids.max()}")


def _to(dev, *arrays) -> list:
    return [torch.from_numpy(a).to(dev) for a in arrays]


class ServingWorkload(abc.ABC):
    """What the engine needs from an endpoint. The per-dispatch work is
    in :meth:`build_program`'s callable; payload padding and reply slicing
    are host numpy."""

    #: Endpoint name (bench record ``app`` = ``serve-<name>``).
    name: str = "?"
    #: Inner-size ladder (rated items / tokens / nodes).
    inner_buckets: tuple[int, ...] = (1,)
    #: Codegen variant of the warm model's plan (None: generic), in the
    #: ladder's keys (``programs/keys.py::serve_program_key``).
    kernel_variant: Optional[str] = None
    #: Realized wire label of the warm model's strategy (None: f32), in
    #: the ladder's keys as ``w<label>``.
    wire: Optional[str] = None
    #: The device the programs run on.
    device: torch.device = torch.device("cpu")

    @abc.abstractmethod
    def inner_size(self, payload: dict) -> int:
        """The payload's inner dimension, before bucketing."""

    @abc.abstractmethod
    def clamp(self, payload: dict) -> dict:
        """The payload admitted for execution: ids checked, an oversize
        payload cut to the largest inner bucket (admission never grows the
        ladder)."""

    @abc.abstractmethod
    def build_program(self, batch_bucket: int, inner_bucket: int):
        """The callable ``prog(*padded_args) -> tuple of device tensors``
        of one bucket cell. Called once a cell (the engine caches)."""

    @abc.abstractmethod
    def pad_batch(self, payloads: list[dict], batch_bucket: int,
                  inner_bucket: int) -> tuple:
        """The program's arguments; rows past ``len(payloads)`` are
        zero-masked."""

    @abc.abstractmethod
    def unpad(self, outputs, payloads: list[dict]) -> list[dict]:
        """One reply a payload from the program's outputs (host tensors)."""

    @abc.abstractmethod
    def serial(self, payload: dict) -> dict:
        """One request in host numpy float32: the degrade rung of an engine
        on the CPU (an engine on the card has none)."""

    @abc.abstractmethod
    def oracle(self, payload: dict) -> dict:
        """The float64 reference reply."""

    @abc.abstractmethod
    def check_reply(self, payload: dict, reply: dict) -> bool:
        """True when ``reply`` is consistent with :meth:`oracle`."""

    @abc.abstractmethod
    def sample_payload(self, rng: np.random.Generator) -> dict:
        """A synthetic request (the load generator's)."""

    def ingest(self, payloads: list[dict]) -> None:
        """Optional online-ingest hook, called after a batch is answered."""

    def program_params(self) -> str:
        """Workload constants of the program beyond its arguments' shapes,
        in the program key: two configurations never share a key. Empty
        when every knob is an argument."""
        return ""


# --------------------------------------------------------------------- #
# ALS: user fold-in + top-k recommendation
# --------------------------------------------------------------------- #


class ALSFoldInTopK(ServingWorkload):
    """Top-k recommendations for unseen users against warm item factors.

    ``model`` is a warm
    :class:`~distributed_sddmm_tpu_torch.models.als.DistributedALS`; its
    item factors are fetched once (global row order) and kept on its
    device as the scoring matrix. ``S_live`` (default: the model's
    ``S_host``) receives each served user's ratings row.

    Payload: ``{"items": int array, "ratings": float array}``.
    Reply:   ``{"items": int64[k] (unseen items, best first; ties: the
    lower id first), "scores": float32[k]}``.
    """

    name = "als"

    def __init__(self, model, k: int = 10, item_buckets: tuple[int, ...] = ALS_ITEM_BUCKETS,
                 S_live: Optional[HostCOO] = None, ingest_rows: bool = True,
                 ridge: float = 0.1, kernel_variant: Optional[str] = None):
        self.kernel_variant = (kernel_variant if kernel_variant is not None
                               else _model_kernel_variant(model))
        self.wire = _model_wire(model)
        if model.B is None:
            raise ValueError("ALSFoldInTopK needs a warm model (run initialize_embeddings"
                             "/run_cg first, or use ServingEngine warmup)")
        self.model = model
        self.k = int(k)
        self.inner_buckets = tuple(sorted(int(b) for b in item_buckets))
        d = model.d_ops
        self.N, self.R, self.device = d.N, d.R, d.device
        # Stiffer than the training ridge: a fold-in user has fewer
        # observations than factors (a rank-deficient Gram), and 1e-6
        # leaves the float32 solve meaningless.
        self.ridge_lambda = max(float(model.ridge_lambda), float(ridge))
        # One host fetch; the programs take the factors as an argument, so a
        # refreshed B never invalidates a cell.
        self._B_host = np.ascontiguousarray(model.item_factors(), dtype=np.float32)
        self._B_dev = torch.from_numpy(self._B_host).to(self.device)
        self._B64 = None
        self._B64_lock = threading.Lock()
        self.S_live = S_live if S_live is not None else model.S_host
        self.ingest_rows = bool(ingest_rows and self.S_live is not None)
        if self.ingest_rows:
            # Grow the live matrix's buffers here, not under the first
            # served batch (a copy of every triplet: 0.3-0.5 s at 2^20 rows).
            self.S_live.reserve(self.S_live.nnz)
        self._ingest_lock = threading.Lock()
        if self.k > self.N:
            raise ValueError(f"k={k} exceeds item count N={self.N}")

    # -- payload shaping ----------------------------------------------- #

    def inner_size(self, payload: dict) -> int:
        return int(len(payload["items"]))

    def clamp(self, payload: dict) -> dict:
        _check_ids(payload["items"], self.N, "item")
        cap = self.inner_buckets[-1]
        if len(payload["items"]) <= cap:
            return payload
        return {"items": np.asarray(payload["items"])[:cap],
                "ratings": np.asarray(payload["ratings"])[:cap]}

    def sample_payload(self, rng: np.random.Generator) -> dict:
        n = int(min(1 + rng.poisson(4), self.inner_buckets[-1]))
        items = rng.choice(self.N, size=n, replace=False).astype(np.int64)
        return {"items": items, "ratings": rng.standard_normal(n).astype(np.float64)}

    def program_params(self) -> str:
        # k and the ridge are constants of the program; the factor matrix
        # is an argument.
        return f"k{self.k}-l{self.ridge_lambda:g}"

    # -- device program ------------------------------------------------ #

    def build_program(self, batch_bucket: int, inner_bucket: int):
        lam, k, N, dev = self.ridge_lambda, self.k, self.N, self.device
        rows = torch.arange(batch_bucket, device=dev)[:, None].expand(batch_bucket, inner_bucket)

        def fold_in_topk(B, idx, ratings, mask):
            idx, ratings, mask = _to(dev, idx, ratings, mask)
            x = serve_kernels.fold_in_solve(B, idx, ratings, mask, lam)        # (b, R)
            # Scores into [b, N + 1]: the rated items and, for padded slots,
            # the spare last column take -inf, one value for every write,
            # so repeated and padded slots cannot race.
            scores = torch.empty(batch_bucket, N + 1, dtype=torch.float32, device=dev)
            serve_kernels.score_rows(x, B, out=scores)
            cols = torch.where(mask > 0, idx.long(), torch.full_like(idx, N, dtype=torch.long))
            scores[rows, cols] = float("-inf")
            return top_k(scores[:, :N], k)

        return fold_in_topk

    def pad_batch(self, payloads: list[dict], batch_bucket: int, inner_bucket: int) -> tuple:
        b, L = batch_bucket, inner_bucket
        idx = np.zeros((b, L), dtype=np.int32)
        ratings = np.zeros((b, L), dtype=np.float32)
        mask = np.zeros((b, L), dtype=np.float32)
        for i, p in enumerate(payloads):
            n = len(p["items"])
            idx[i, :n] = p["items"]
            ratings[i, :n] = p["ratings"]
            mask[i, :n] = 1.0
        return (self._B_dev, idx, ratings, mask)

    def unpad(self, outputs, payloads: list[dict]) -> list[dict]:
        vals, ids = (t.numpy() for t in outputs)
        return [{"items": ids[i].astype(np.int64), "scores": vals[i]}
                for i in range(len(payloads))]

    # -- host paths ---------------------------------------------------- #

    def _B_host64(self) -> np.ndarray:
        """B in float64, made once: the oracle of every checked reply reads
        it (1 GiB at 2^20 items of R = 128), from the load generator's
        waiter threads."""
        with self._B64_lock:
            if self._B64 is None:
                self._B64 = self._B_host.astype(np.float64)
            return self._B64

    def _scores_host(self, payload: dict, B: np.ndarray) -> np.ndarray:
        items = np.asarray(payload["items"], dtype=np.int64)
        ratings = np.asarray(payload["ratings"], dtype=B.dtype)
        rows = B[items]
        gram = rows.T @ rows + self.ridge_lambda * np.eye(B.shape[1], dtype=B.dtype)
        x = np.linalg.solve(gram, rows.T @ ratings)
        scores = B @ x
        scores[items] = -np.inf
        return scores

    def serial(self, payload: dict) -> dict:
        """The degrade rung: the same math, numpy float32, on the host."""
        scores = self._scores_host(payload, self._B_host)
        order = np.argsort(-scores, kind="stable")[: self.k]
        return {"items": order.astype(np.int64), "scores": scores[order].astype(np.float32)}

    def oracle(self, payload: dict) -> dict:
        scores = self._scores_host(payload, self._B_host64())
        order = np.argsort(-scores, kind="stable")[: self.k]
        return {"items": order.astype(np.int64), "scores": scores[order]}

    def check_reply(self, payload: dict, reply: dict) -> bool:
        """Every returned item scores, by the float64 oracle, at least the
        oracle's k-th best less float32 slack, and its returned score
        agrees with the oracle's. The order of near-ties is not pinned:
        float32 against float64 legitimately swaps them."""
        oracle_scores = self._scores_host(payload, self._B_host64())
        scale = float(np.max(np.abs(oracle_scores[np.isfinite(oracle_scores)])))
        tol = 1e-3 * max(scale, 1.0)
        ids = np.asarray(reply["items"])
        got = np.asarray(reply["scores"], dtype=np.float64)
        kth = np.partition(oracle_scores, -self.k)[-self.k]
        if np.any(oracle_scores[ids] < kth - tol):
            return False
        return bool(np.all(np.abs(got - oracle_scores[ids]) <= tol))

    def ingest(self, payloads: list[dict]) -> None:
        """Fold the served users into the live ratings matrix, one row a
        request (repair mode: online traffic is untrusted)."""
        if not self.ingest_rows:
            return
        with self._ingest_lock:
            self.S_live.append_rows(
                [np.asarray(p["items"], dtype=np.int64) for p in payloads],
                [np.asarray(p["ratings"], dtype=np.float64) for p in payloads],
                mode="repair")

    # -- structure rebind ---------------------------------------------- #

    def rebind_structure(self, S: Optional[HostCOO] = None) -> dict:
        """Bind the ingest-grown ratings pattern (default ``S_live``) into
        the model's strategy, which must be a ``dynstruct.build`` product;
        on a spill the replacement strategy is re-pointed into the model."""
        from distributed_sddmm_tpu_torch import dynstruct

        if S is None:
            S = self.S_live
        if S is None:
            raise ValueError("no live ratings matrix to rebind")
        with self._ingest_lock:
            update = dynstruct.rebind(self.model.d_ops, S)
            if update.spilled:
                self.model.d_ops = update.alg
        return {"fit": update.fit, "nnz": update.nnz_after, "row_cap": update.row_cap,
                "reason": update.reason}


# --------------------------------------------------------------------- #
# Attention: token scoring over cached context embeddings
# --------------------------------------------------------------------- #


class AttentionTokenScore(ServingWorkload):
    """Score tokens by local attention over a cached context.

    The fused block-sparse SDDMM → masked softmax → SpMM call runs once at
    build (``build_attention_engine``), and its output rows are the cached
    context ``K``. A request asks for a token batch: per token ``i``, a
    masked softmax over its ``±w`` neighbourhood of ``K`` weights the
    neighbours' values through a fixed head (seeded, so replies are
    reproducible across processes). With ``dynamic=True`` the context is
    padded to a capacity rung and its real row count is a runtime
    argument, and each request may narrow the window with a ``mask`` spec
    (``window:<p>`` or ``topk:<p>``) without a new program.

    Payload: ``{"tokens": int array[, "mask": spec]}``.
    Reply:   ``{"tokens": int64 array, "scores": float32 array}``.
    """

    name = "attention"

    def __init__(self, context: np.ndarray, d_ops=None, window: Optional[int] = None,
                 token_buckets: tuple[int, ...] = ATTN_TOKEN_BUCKETS, head_seed: int = 0,
                 kernel_variant: Optional[str] = None, dynamic: bool = False,
                 device=None):
        if kernel_variant is None and d_ops is not None:
            from distributed_sddmm_tpu_torch.parallel.base import realized_kernel_variant

            kernel_variant = realized_kernel_variant(d_ops)
        self.kernel_variant = kernel_variant
        self.wire = _model_wire(d_ops) if d_ops is not None else None
        self.d_ops = d_ops
        self.device = (d_ops.device if d_ops is not None and device is None
                       else resolve_device(device))
        if window is None:
            window = int(os.environ.get(ATTN_WINDOW_ENV, "16"))
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        self.window = int(window)
        self.inner_buckets = tuple(sorted(int(b) for b in token_buckets))
        self.dynamic = bool(dynamic)
        rng = np.random.default_rng(head_seed)
        self._w_host = (rng.standard_normal(context.shape[1])
                        / np.sqrt(context.shape[1])).astype(np.float32)
        self._w_dev = torch.from_numpy(self._w_host).to(self.device)
        self._bind_context(np.ascontiguousarray(context, dtype=np.float32))

    def _bind_context(self, K: np.ndarray) -> None:
        """(Re)bind the cached context. In dynamic mode ``K`` is padded up
        to the capacity rung ``ctx_cap`` (extra rows zero) and the real row
        count ``n_valid`` is a runtime argument: growth within the rung
        rebinds with no new program."""
        self.n_ctx, self.R = K.shape
        self._K_host = K
        self._K64 = None
        if self.dynamic:
            from distributed_sddmm_tpu_torch.utils.buckets import pow2_at_least

            self.ctx_cap = pow2_at_least(self.n_ctx + 1)
            self._K_dev = self._padded(K)
        else:
            self.ctx_cap = self.n_ctx
            self._K_dev = torch.from_numpy(K).to(self.device)

    def _padded(self, K: np.ndarray):
        """``K`` on the device, zero rows up to ``ctx_cap``."""
        pad = np.zeros((self.ctx_cap, self.R), dtype=np.float32)
        pad[: K.shape[0]] = K
        return torch.from_numpy(pad).to(self.device)

    # -- payload shaping ----------------------------------------------- #

    def inner_size(self, payload: dict) -> int:
        return int(len(payload["tokens"]))

    def _spec(self, spec: str) -> tuple[str, int]:
        from distributed_sddmm_tpu_torch import masks

        return masks.parse_dynamic_spec(spec, w_max=self.window, k_max=2 * self.window + 1)

    def clamp(self, payload: dict) -> dict:
        _check_ids(payload["tokens"], self.n_ctx, "token")
        if self.dynamic and "mask" in payload:
            # Admission-time validation: a malformed or capacity-exceeding
            # spec is refused here, before it reaches a padded batch.
            self._spec(payload["mask"])
        cap = self.inner_buckets[-1]
        if len(payload["tokens"]) <= cap:
            return payload
        out = dict(payload)
        out["tokens"] = np.asarray(payload["tokens"])[:cap]
        return out

    def sample_payload(self, rng: np.random.Generator) -> dict:
        n = int(min(1 + rng.poisson(2), self.inner_buckets[-1]))
        out = {"tokens": rng.choice(self.n_ctx, size=n, replace=False).astype(np.int64)}
        if self.dynamic:
            # Mask-churn traffic: every request narrows differently, and
            # none of it may need a new program.
            pick = rng.integers(0, 3)
            if pick == 1:
                out["mask"] = f"window:{int(rng.integers(0, self.window + 1))}"
            elif pick == 2:
                out["mask"] = f"topk:{int(rng.integers(1, 2 * self.window + 2))}"
        return out

    def program_params(self) -> str:
        # The window is a constant of the program; dynamic mode bakes the
        # same window as a capacity and takes n_valid, kind and param as
        # arguments, so it must not share a key.
        return f"w{self.window}-dyn" if self.dynamic else f"w{self.window}"

    @property
    def capacity_segment(self) -> Optional[str]:
        """The serve key's capacity segment: None for static builds (their
        keys stay the JAX package's exact ones), the window capacity and
        the context rung in dynamic mode."""
        if not self.dynamic:
            return None
        return f"w{self.window}.n{self.ctx_cap}"

    # -- device program ------------------------------------------------ #

    def build_program(self, batch_bucket: int, inner_bucket: int):
        w, dev = self.window, self.device
        if not self.dynamic:
            n_ctx = self.n_ctx

            def score(K, head, tokens, mask):
                tokens, mask = _to(dev, tokens, mask)
                return (serve_kernels.window_score(K, head, tokens, mask, n_ctx, w),)

            return score

        def score_dyn(K, n_valid, head, tokens, mask, kind, param):
            tokens, mask, kind, param = _to(dev, tokens, mask, kind, param)
            return (serve_kernels.window_score(K, head, tokens, mask, n_valid, w, kind,
                                               param),)

        return score_dyn

    def _mask_arrays(self, payloads: list[dict], b: int) -> tuple[np.ndarray, np.ndarray]:
        kind = np.zeros(b, dtype=np.int32)
        param = np.full(b, self.window, dtype=np.int32)
        for i, p in enumerate(payloads):
            spec = p.get("mask")
            if spec is None:
                continue
            fam, val = self._spec(spec)
            kind[i] = 1 if fam == "topk" else 0
            param[i] = val
        return kind, param

    def pad_batch(self, payloads: list[dict], batch_bucket: int, inner_bucket: int) -> tuple:
        b, L = batch_bucket, inner_bucket
        tokens = np.zeros((b, L), dtype=np.int32)
        mask = np.zeros((b, L), dtype=np.float32)
        for i, p in enumerate(payloads):
            n = len(p["tokens"])
            tokens[i, :n] = p["tokens"]
            mask[i, :n] = 1.0
        if not self.dynamic:
            return (self._K_dev, self._w_dev, tokens, mask)
        kind, param = self._mask_arrays(payloads, b)
        return (self._K_dev, self.n_ctx, self._w_dev, tokens, mask, kind, param)

    def unpad(self, outputs, payloads: list[dict]) -> list[dict]:
        scores = outputs[0].numpy()
        return [{"tokens": np.asarray(p["tokens"], dtype=np.int64),
                 "scores": scores[i][: len(p["tokens"])]}
                for i, p in enumerate(payloads)]

    # -- host paths ---------------------------------------------------- #

    def _scores_host(self, payload: dict, K: np.ndarray) -> np.ndarray:
        from distributed_sddmm_tpu_torch.ops.kernels import ATTN_NEG

        head = self._w_host.astype(K.dtype)
        tokens = np.asarray(payload["tokens"], dtype=np.int64)
        offs = np.arange(-self.window, self.window + 1, dtype=np.int64)
        nb = tokens[:, None] + offs
        valid = (nb >= 0) & (nb < self.n_ctx)
        nb = np.clip(nb, 0, self.n_ctx - 1)
        q = K[tokens]
        kn = K[nb]
        logits = np.sum(q[:, None, :] * kn, axis=-1) / np.sqrt(K.dtype.type(self.R))
        zsafe = np.where(valid, logits, K.dtype.type(ATTN_NEG))
        if self.dynamic and payload.get("mask") is not None:
            fam, val = self._spec(payload["mask"])
            if fam == "window":
                valid = valid & (np.abs(offs)[None, :] <= val)
            else:
                sorted_desc = -np.sort(-zsafe, axis=-1)
                kidx = min(max(val, 1), offs.size) - 1
                valid = valid & (zsafe >= sorted_desc[:, kidx: kidx + 1])
            zsafe = np.where(valid, zsafe, K.dtype.type(ATTN_NEG))
        m = np.max(zsafe, axis=-1, keepdims=True)
        e = np.where(valid, np.exp(zsafe - m), 0.0).astype(K.dtype)
        d = np.sum(e, axis=-1)
        vals = np.sum(kn * head, axis=-1)
        return np.sum(e * vals, axis=-1) / np.where(d > 0, d, 1.0)

    # -- structure rebind ---------------------------------------------- #

    def rebind_structure(self, context: np.ndarray) -> dict:
        """Bind a grown or refreshed context (``dynamic=True`` only). Growth
        within the ``ctx_cap`` rung rebinds with every program kept
        (``dynstruct_rebinds``); past it the capacity is derived anew, the
        serve keys change through :attr:`capacity_segment`, and the engine
        re-warms its ladder (``dynstruct_bucket_spills``,
        ``structure_retraces``). A new device tensor replaces the old one,
        so a batch already padded keeps the context it was padded with."""
        from distributed_sddmm_tpu_torch.dynstruct import note_rebind

        if not self.dynamic:
            raise ValueError("attention structure rebind needs dynamic=True (a static "
                             "build bakes n_ctx into its program)")
        K = np.ascontiguousarray(context, dtype=np.float32)
        if K.ndim != 2 or K.shape[1] != self.R:
            raise ValueError(f"context must be (n, {self.R}), got {K.shape}")
        fit = K.shape[0] <= self.ctx_cap
        if fit:
            K_dev = self._padded(K)
            self._K_host, self._K64 = K, None
            self._K_dev, self.n_ctx = K_dev, K.shape[0]
        else:
            self._bind_context(K)
        note_rebind(fit)
        return {"fit": fit, "n_ctx": self.n_ctx, "ctx_cap": self.ctx_cap}

    def serial(self, payload: dict) -> dict:
        tokens = np.asarray(payload["tokens"], dtype=np.int64)
        return {"tokens": tokens,
                "scores": self._scores_host(payload, self._K_host).astype(np.float32)}

    def oracle(self, payload: dict) -> dict:
        if self._K64 is None:
            self._K64 = self._K_host.astype(np.float64)
        tokens = np.asarray(payload["tokens"], dtype=np.int64)
        return {"tokens": tokens, "scores": self._scores_host(payload, self._K64)}

    def check_reply(self, payload: dict, reply: dict) -> bool:
        want = self.oracle(payload)["scores"]
        got = np.asarray(reply["scores"], dtype=np.float64)[: len(want)]
        scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0)
        return bool(np.all(np.abs(got - want) <= 1e-3 * scale))


# --------------------------------------------------------------------- #
# GAT: node scoring over cached forward embeddings
# --------------------------------------------------------------------- #


class GATNodeScore(ServingWorkload):
    """Score nodes against the warm model's cached embeddings.

    :meth:`refresh` runs the whole-graph forward pass and caches the final
    embeddings in global row order on the model's device; a request is a
    gather and a fixed linear head (seeded, so replies are reproducible
    across processes).

    Payload: ``{"nodes": int array}``.
    Reply:   ``{"nodes": int64 array, "scores": float32 array}``.
    """

    name = "gat"

    def __init__(self, model, node_buckets: tuple[int, ...] = GAT_NODE_BUCKETS,
                 head_seed: int = 0, kernel_variant: Optional[str] = None):
        self.model = model
        self.kernel_variant = (kernel_variant if kernel_variant is not None
                               else _model_kernel_variant(model))
        self.wire = _model_wire(model)
        self.inner_buckets = tuple(sorted(int(b) for b in node_buckets))
        self.M = model.d_ops.M
        self.device = model.d_ops.device
        self._F = model.layers[-1].output_features
        rng = np.random.default_rng(head_seed)
        self._w_host = (rng.standard_normal(self._F) / np.sqrt(self._F)).astype(np.float32)
        self._w_dev = torch.from_numpy(self._w_host).to(self.device)[None, :]
        self._X_host: Optional[np.ndarray] = None
        self._X_dev = None
        self.refresh()

    def refresh(self) -> None:
        """Run the warm forward pass and cache the embeddings (after a
        weight update; serving reads a consistent snapshot)."""
        X = np.ascontiguousarray(self.model.node_embeddings(), dtype=np.float32)
        self._X_dev = torch.from_numpy(X).to(self.device)
        self._X_host = X

    # -- payload shaping ----------------------------------------------- #

    def inner_size(self, payload: dict) -> int:
        return int(len(payload["nodes"]))

    def clamp(self, payload: dict) -> dict:
        _check_ids(payload["nodes"], self.M, "node")
        cap = self.inner_buckets[-1]
        if len(payload["nodes"]) <= cap:
            return payload
        return {"nodes": np.asarray(payload["nodes"])[:cap]}

    def sample_payload(self, rng: np.random.Generator) -> dict:
        n = int(min(1 + rng.poisson(2), self.inner_buckets[-1]))
        return {"nodes": rng.choice(self.M, size=n, replace=False).astype(np.int64)}

    # -- device program ------------------------------------------------ #

    def build_program(self, batch_bucket: int, inner_bucket: int):
        dev = self.device

        def score(X, w, nodes, mask):
            nodes, mask = _to(dev, nodes, mask)
            s = serve_kernels.score_rows(w, X, tidx=nodes.view(-1))        # (1, b * L)
            return (s.view(batch_bucket, inner_bucket) * mask,)

        return score

    def pad_batch(self, payloads: list[dict], batch_bucket: int, inner_bucket: int) -> tuple:
        b, L = batch_bucket, inner_bucket
        nodes = np.zeros((b, L), dtype=np.int32)
        mask = np.zeros((b, L), dtype=np.float32)
        for i, p in enumerate(payloads):
            n = len(p["nodes"])
            nodes[i, :n] = p["nodes"]
            mask[i, :n] = 1.0
        return (self._X_dev, self._w_dev, nodes, mask)

    def unpad(self, outputs, payloads: list[dict]) -> list[dict]:
        scores = outputs[0].numpy()
        return [{"nodes": np.asarray(p["nodes"], dtype=np.int64),
                 "scores": scores[i][: len(p["nodes"])]}
                for i, p in enumerate(payloads)]

    # -- host paths ---------------------------------------------------- #

    def serial(self, payload: dict) -> dict:
        nodes = np.asarray(payload["nodes"], dtype=np.int64)
        scores = self._X_host[nodes] @ self._w_host
        return {"nodes": nodes, "scores": scores.astype(np.float32)}

    def oracle(self, payload: dict) -> dict:
        nodes = np.asarray(payload["nodes"], dtype=np.int64)
        scores = self._X_host[nodes].astype(np.float64) @ self._w_host.astype(np.float64)
        return {"nodes": nodes, "scores": scores}

    def check_reply(self, payload: dict, reply: dict) -> bool:
        want = self.oracle(payload)["scores"]
        got = np.asarray(reply["scores"], dtype=np.float64)[: len(want)]
        scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0)
        return bool(np.all(np.abs(got - want) <= 1e-3 * scale))
