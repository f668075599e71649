"""The port's GAT forward pass (``models/gat.py``) against the JAX
package's.

The weights are drawn by different generators in the two packages, so the
JAX GAT's weights cross over through
``utils/interop.gat_weights_from_reference``; the default input
``dummy_initialize(A) / (M * R_in)`` is the same in both. The outputs
agree within 1e-5 of the output's max abs value (float32 sums in another
order), at (p, c) = (1, 1) and (8, 2), with 2 and 3 layers, one
``gatLayer`` a layer; and on the three R-split strategies at (8, 2), whose
heads run through the public ops with their shifts. Also: the validation of
``tests/test_gat.py``, the benchmark's layer spec against the float64
oracle (``utils/oracle.gat_forward``), the guard, and weight checkpoints.
"""

import numpy as np
import pytest
import torch

import jax

from distributed_sddmm_tpu.models.gat import GAT as JaxGAT
from distributed_sddmm_tpu.models.gat import GATLayer as JaxLayer
from distributed_sddmm_tpu.parallel.cannon_dense_25d import CannonDense25D as JaxCD
from distributed_sddmm_tpu.parallel.cannon_sparse_25d import CannonSparse25D as JaxCS
from distributed_sddmm_tpu.parallel.dense_shift_15d import DenseShift15D as JaxDS
from distributed_sddmm_tpu.parallel.sparse_shift_15d import SparseShift15D as JaxSS
from distributed_sddmm_tpu.resilience import CheckpointStore as JaxStore
from distributed_sddmm_tpu.utils.coo import HostCOO as JaxCOO

from distributed_sddmm_tpu_torch.bench import harness
from distributed_sddmm_tpu_torch.common import MatMode
from distributed_sddmm_tpu_torch.models.gat import GAT, GATLayer
from distributed_sddmm_tpu_torch.parallel.cannon_dense_25d import CannonDense25D
from distributed_sddmm_tpu_torch.parallel.cannon_sparse_25d import CannonSparse25D
from distributed_sddmm_tpu_torch.parallel.comm import LocalWorld
from distributed_sddmm_tpu_torch.parallel.dense_shift_15d import DenseShift15D
from distributed_sddmm_tpu_torch.parallel.sparse_shift_15d import SparseShift15D
from distributed_sddmm_tpu_torch.resilience import CheckpointStore, NumericalFault, guards
from distributed_sddmm_tpu_torch.utils import oracle
from distributed_sddmm_tpu_torch.utils.coo import HostCOO
from distributed_sddmm_tpu_torch.utils.interop import gat_weights_from_reference

OUT_TOL = 1e-5
SPECS = {2: [(8, 4, 2), (8, 4, 2)], 3: [(8, 4, 2), (8, 8, 3), (24, 4, 2)]}
STRATEGIES = {"dense_shift": (JaxDS, DenseShift15D), "sparse_shift": (JaxSS, SparseShift15D),
              "cannon_dense": (JaxCD, CannonDense25D),
              "cannon_sparse": (JaxCS, CannonSparse25D)}


def _graph(M=32, seed=0):
    return JaxCOO.erdos_renyi(M, M, 4, seed=seed)


def _alg(S, R=8, p=1, c=1):
    return DenseShift15D(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=R, c=c,
                         world=LocalWorld(p), device="cpu")


def _port_gat(S, spec, p=1, c=1, **kw):
    alg = _alg(S, spec[0][0], p, c)
    return GAT([GATLayer(*s) for s in spec], alg, **kw), alg


@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("strategy,p,c", [
    pytest.param("dense_shift", 1, 1, id="1-1"), pytest.param("dense_shift", 8, 2, id="8-2"),
    pytest.param("sparse_shift", 8, 2, id="sparse_shift-8-2"),
    pytest.param("cannon_dense", 8, 2, id="cannon_dense-8-2"),
    pytest.param("cannon_sparse", 8, 2, id="cannon_sparse-8-2")])
def test_forward_matches_jax(strategy, p, c, n_layers):
    S = _graph()
    spec = SPECS[n_layers]
    jcls, pcls = STRATEGIES[strategy]
    ja = jcls(S, R=spec[0][0], c=c, devices=jax.devices()[:p])
    jgat = JaxGAT([JaxLayer(*s) for s in spec], ja, seed=3)
    want = ja.host_a(jgat.forward())
    weights = gat_weights_from_reference(
        [[np.asarray(w) for w in layer.weights] for layer in jgat.layers], device="cpu")
    alg = pcls(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), R=spec[0][0], c=c,
               world=LocalWorld(p), device="cpu")
    gat = GAT([GATLayer(*s) for s in spec], alg, seed=3)
    for layer, ws in zip(gat.layers, weights):
        layer.weights = ws
    got = alg.host_a(gat.forward())
    assert got.shape == want.shape == (32, gat.layers[-1].output_features)
    scale = float(np.abs(want).max())
    assert scale > 0 and np.abs(got - want).max() <= OUT_TOL * scale
    assert alg.R == ja.R == gat.layers[-1].output_features
    if strategy == "dense_shift":
        assert set(alg.metrics) == {"gatLayer"}
        assert alg.metrics["gatLayer"]["calls"] == n_layers
    else:
        heads = sum(layer.num_heads for layer in gat.layers)
        assert {k: v["calls"] for k, v in alg.metrics.items()} == {"sddmmA": heads,
                                                                  "spmmA": heads}


def test_layer_parts_and_heads_come_from_the_forward_code(monkeypatch):
    """``layer_forward``'s timing hook sees each part of each head in
    order with its output, then the concat; a head is its slice of the
    layer's output; on the dense shift a layer is one ``gatLayer``. The
    timing changes nothing computed: with the unit off, the same layer
    shows the public ops' counters, with the same marks and the same
    output."""
    S = _graph()
    gat, alg = _port_gat(S, SPECS[2], seed=2)
    X = gat.default_input()
    parts, values = [], {}

    def mark(part, value):
        parts.append(part)
        values.setdefault(part, value)

    out = gat.layer_forward(0, X, mark=mark)
    head = ["projection", "sddmm", "leaky_relu", "spmm", "relu"]
    assert parts == head * 2 + ["concat"] and alg.R == 8
    assert {k: v["calls"] for k, v in alg.metrics.items()} == {"gatLayer": 1}
    assert torch.equal(values["concat"], out) and torch.equal(values["relu"], out[:, :4])
    assert torch.equal(torch.relu(values["spmm"]), values["relu"])
    assert torch.equal(gat.compute_self_attention_head(X, 0, 1), out[:, 4:])
    assert torch.equal(gat.layer_forward(1, gat.layer_forward(0, X)), gat.forward())
    monkeypatch.setattr(gat, "_unit", False)
    alg.reset_performance_timers()
    marks = []
    assert torch.equal(gat.layer_forward(0, X, mark=lambda part, _: marks.append(part)), out)
    assert marks == parts and set(alg.metrics) == {"sddmmA", "spmmA"}


def test_node_embeddings_and_comm_profile_follow_the_width():
    """After a forward pass the strategy's R is the last layer's width:
    the host embeddings and ``comm_profile`` take it from there."""
    S = _graph()
    gat, alg = _port_gat(S, SPECS[3], 4, 2, seed=1)
    emb = gat.node_embeddings()
    assert emb.shape == (32, 8) and alg.R == 8
    words = {e["collective"]: e["words"] for e in alg.comm_profile("sddmmA")}
    assert words["all_gather"] == (2 - 1) * alg.localArows * 8
    alg.set_r_value(24)
    words = {e["collective"]: e["words"] for e in alg.comm_profile("sddmmA")}
    assert words["all_gather"] == (2 - 1) * alg.localArows * 24


def test_gat_validates_specs():
    S = _graph()
    alg = _alg(S)
    with pytest.raises(ValueError, match="layer 1 input_features 9"):
        GAT([GATLayer(8, 4, 2), GATLayer(9, 4, 2)], alg)
    with pytest.raises(ValueError, match="at least one layer"):
        GAT([], alg)
    rect = JaxCOO.erdos_renyi(32, 16, 2, seed=1)
    with pytest.raises(ValueError, match="square"):
        GAT([GATLayer(8, 4, 2)], _alg(rect))


def test_gat_benchmark_layer_spec():
    """Layer widths that change per layer (set_r_value) against the float64
    oracle at the tolerances of ``tests/test_gat.py``; the harness's spec is
    heads (4, 4, 6) at ``features_per_head = R``."""
    S = _graph(M=24)
    gat, alg = _port_gat(S, [(16, 8, 2), (16, 4, 3)], seed=5)
    out = gat.forward()
    assert out.shape[-1] == 12
    X = oracle.dummy_dense(alg.M_pad, 16) / (alg.M * 16)
    want = oracle.gat_forward(HostCOO(S.rows, S.cols, S.vals, S.M, S.N), X,
                              [[w.double().numpy() for w in layer.weights]
                               for layer in gat.layers])
    np.testing.assert_allclose(alg.host_a(out), want[: alg.M], rtol=2e-3, atol=1e-5)
    spec = harness._gat_layers(8)
    assert [(s.input_features, s.features_per_head, s.num_heads) for s in spec] == [
        (8, 8, 4), (32, 8, 4), (32, 8, 6)]
    assert len(harness._gat_layers(8, num_layers=2)) == 2


def test_weights_are_scaled_uniform_and_seeded():
    S = _graph()
    a, _ = _port_gat(S, SPECS[2], seed=7)
    b, _ = _port_gat(S, SPECS[2], seed=7)
    c, _ = _port_gat(S, SPECS[2], seed=8)
    w = torch.cat([x.reshape(-1) for layer in a.layers for x in layer.weights])
    assert float(w.abs().max()) <= 1 / np.sqrt(8) and float(w.std()) > 0.1
    assert all(torch.equal(x, y) for la, lb in zip(a.layers, b.layers)
               for x, y in zip(la.weights, lb.weights))
    assert not torch.equal(a.layers[0].weights[0], c.layers[0].weights[0])


def test_guard_checks_every_layer(monkeypatch):
    S = _graph()
    gat, alg = _port_gat(S, SPECS[2], seed=1)
    real = alg.spmm_a

    def poisoned(A, B, s_vals):
        out = real(A, B, s_vals)
        out[0, 0] = float("nan")
        return out

    monkeypatch.setattr(alg, "spmm_a", poisoned)
    monkeypatch.delenv(guards.GUARDS_ENV, raising=False)
    assert not bool(torch.isfinite(gat.forward()).all())  # off by default
    monkeypatch.setenv(guards.GUARDS_ENV, "1")
    with pytest.raises(NumericalFault, match="gat:layer0"):
        gat.forward()
    monkeypatch.setenv(guards.GUARD_MODE_ENV, "repair")
    assert bool(torch.isfinite(gat.forward()).all())


def test_gat_weights_roundtrip_and_refusals(tmp_path):
    S = _graph()
    gat, alg = _port_gat(S, [(8, 8, 2)], seed=3)
    store = CheckpointStore(tmp_path / "gat")
    gat.save_checkpoint(store)
    other = GAT([GATLayer(8, 8, 2)], alg, seed=99)
    assert not torch.equal(gat.layers[0].weights[0], other.layers[0].weights[0])
    assert other.load_checkpoint(store)
    for x, y in zip(gat.layers[0].weights, other.layers[0].weights):
        assert torch.equal(x, y)
    assert torch.equal(gat.forward(), other.forward())

    assert not other.load_checkpoint(CheckpointStore(tmp_path / "none"))
    als_store = CheckpointStore(tmp_path / "als")
    als_store.save(1, {"w_0_0": np.zeros((8, 8), np.float32),
                       "w_0_1": np.zeros((8, 8), np.float32)}, meta={"kind": "als"})
    assert not other.load_checkpoint(als_store)
    wider = GAT([GATLayer(8, 8, 3)], alg, seed=1)
    assert not wider.load_checkpoint(store)  # no w_0_2 there


def test_jax_gat_weights_load_in_the_port(tmp_path):
    S = _graph()
    ja = JaxDS(S, R=8, c=1, devices=jax.devices()[:1])
    jgat = JaxGAT([JaxLayer(8, 4, 2)], ja, seed=2)
    jgat.save_checkpoint(JaxStore(tmp_path))
    gat, alg = _port_gat(S, [(8, 4, 2)], seed=5)
    assert gat.load_checkpoint(CheckpointStore(tmp_path))
    for x, y in zip(gat.layers[0].weights, jgat.layers[0].weights):
        assert np.array_equal(x.numpy(), np.asarray(y))
    want = ja.host_a(jgat.forward())
    got = alg.host_a(gat.forward())
    assert np.abs(got - want).max() <= OUT_TOL * float(np.abs(want).max())
    gat.save_checkpoint(CheckpointStore(tmp_path / "port"), step=4)
    back = JaxGAT([JaxLayer(8, 4, 2)], ja, seed=9)
    assert back.load_checkpoint(JaxStore(tmp_path / "port"))
    assert np.array_equal(np.asarray(back.layers[0].weights[1]), gat.layers[0].weights[1].numpy())


def test_dense_project_and_concat_heads_keep_rows():
    S = _graph()
    alg = _alg(S, 8, 4, 2)
    X = torch.arange(32 * 8, dtype=torch.float32).reshape(32, 8)
    W = torch.eye(8)[:, :3]
    Y = alg.dense_project(X, W, MatMode.A)
    assert alg.R == 3 and torch.equal(Y, X[:, :3])
    Z = alg.concat_heads([Y, Y[:, :1]], MatMode.A)
    assert alg.R == 4 and Z.shape == (32, 4) and torch.equal(Z[:, 3], X[:, 0])
