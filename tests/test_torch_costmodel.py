"""The port's cost model (``tools/costmodel.py``) against the JAX
package's, and the banked variants' cost factor (``codegen/variants.py``).

``pair_words``, ``pair_bytes``, ``pair_time`` (on the same machine
numbers), ``optimal_c`` and ``model_curves`` equal the JAX functions on a
grid of shapes and (p, c), refusals included. The machine defaults are the
card's: the flops rate comes from ``bench kernels`` records (path knob
``SDDMM_TORCH_KERNEL_RECORDS``), else a family's fallback literal. The
variant factor restates the JAX one for the port's CSR bands, so it is
held to its own contract: near 1 on uniform rows, a discount on skewed
ones, 1 for a non-banked or unknown id.
"""

import json

import pytest

from distributed_sddmm_tpu.parallel.wire import WirePolicy as JaxPolicy
from distributed_sddmm_tpu.tools import costmodel as jax_cm

from distributed_sddmm_tpu_torch.autotune.fingerprint import Problem
from distributed_sddmm_tpu_torch.codegen import variants
from distributed_sddmm_tpu_torch.parallel.wire import WirePolicy
from distributed_sddmm_tpu_torch.tools import costmodel as cm

MODELS = ("15d_fusion2", "15d_fusion1", "15d_unfused", "15d_sparse", "25d_dense",
          "25d_sparse")
SHAPES = [(1 << 10, 1 << 10, 8, 1 << 13), (3000, 1000, 64, 20000),
          (1 << 16, 1 << 14, 128, 1 << 21), (1 << 20, 1 << 20, 512, 1 << 25)]
GRID = [(p, c) for p in (1, 2, 3, 4, 8, 9, 16, 18, 32, 64) for c in (1, 2, 3, 4, 8, 16)]
POLICIES = [None, "f32", "bf16", (("reduce", "bf16"),), (("ring", "f32"),),
            (("ring_accum", "bf16"), ("reduce", "bf16"))]
MACHINE = dict(words=3.7e10, alpha=2e-6, flops=9.1e11)


def _policies(spec):
    """The same policy in both packages."""
    if spec is None or isinstance(spec, str):
        return spec, spec
    return WirePolicy("bf16", spec), JaxPolicy("bf16", spec)


def _both(fn_port, fn_jax):
    """Both results, or both refusals."""
    try:
        want = fn_jax()
    except ValueError:
        with pytest.raises(ValueError):
            fn_port()
        return None
    return fn_port(), want


@pytest.mark.parametrize("shape", SHAPES, ids=[f"M{s[0]}-R{s[2]}" for s in SHAPES])
def test_words_bytes_and_time_equal_jax(shape):
    M, N, R, nnz = shape
    port_m = cm.Machine(link_words_per_s=MACHINE["words"], alpha_s=MACHINE["alpha"],
                        flops_rate=MACHINE["flops"])
    jax_m = jax_cm.Machine(ici_words_per_s=MACHINE["words"], alpha_s=MACHINE["alpha"],
                           flops_rate=MACHINE["flops"])
    compared = 0
    for alg in MODELS + ("nope",):
        for p, c in GRID:
            res = _both(lambda: cm.pair_words(alg, M, N, R, nnz, p, c),
                        lambda: jax_cm.pair_words(alg, M, N, R, nnz, p, c))
            if res is None:
                continue
            assert res[0] == res[1], (alg, p, c)
            compared += 1
            for spec in POLICIES:
                mine, theirs = _policies(spec)
                assert cm.pair_bytes(alg, M, N, R, nnz, p, c, wire=mine) == \
                    jax_cm.pair_bytes(alg, M, N, R, nnz, p, c, wire=theirs), (alg, p, c, spec)
                assert cm.pair_time(alg, M, N, R, nnz, p, c, port_m, wire=mine) == \
                    jax_cm.pair_time(alg, M, N, R, nnz, p, c, jax_m, wire=theirs)
    assert compared > 150
    for p in (1, 4, 16, 64):
        for alg in MODELS:
            res = _both(lambda: cm.optimal_c(alg, M, N, R, nnz, p, port_m),
                        lambda: jax_cm.optimal_c(alg, M, N, R, nnz, p, jax_m))
            assert res is None or res[0] == res[1]
        assert cm.model_curves(M, N, R, nnz, p, port_m) == \
            jax_cm.model_curves(M, N, R, nnz, p, jax_m)


def test_f32_bytes_are_four_a_word_and_bf16_discounts_only_what_casts():
    M, N, R, nnz = SHAPES[2]
    for alg in MODELS:
        words = cm.pair_words(alg, M, N, R, nnz, 16, 4 if alg.startswith("25d") else 2)
        assert cm.pair_bytes(alg, M, N, R, nnz, 16,
                             4 if alg.startswith("25d") else 2) == 4 * words
    # The sparse shift's integer index traffic keeps its 4 bytes.
    ring_only = cm.pair_bytes("15d_sparse", M, N, R, nnz, 16, 1, wire="bf16")
    assert ring_only == 4 * cm.pair_words("15d_sparse", M, N, R, nnz, 16, 1) \
        - 2 * (16 - 1) * nnz / 16


def test_machine_defaults_are_the_cards(tmp_path, monkeypatch):
    """The link is NVLink 4's 450 GB/s a direction; the flops rate is the
    records' at the headline, else their best, else the literal."""
    assert cm.DEFAULT_LINK_WORDS_PER_S == 450e9 / 4
    records = tmp_path / "k.jsonl"
    monkeypatch.setenv(cm.KERNEL_RECORDS_ENV, str(records))
    assert cm.measured_flops_rate("cuda-bf16") is None
    assert cm.Machine().flops_rate == cm.FALLBACK_FLOPS_RATES["cuda-bf16"]
    assert cm.family_flops_rate("torch") == cm.FALLBACK_FLOPS_RATES["torch"]
    rec = {"M": 1 << 16, "N": 1 << 16, "nnz": 2097000, "R": 128, "kernel": "cuda-bf16",
           "fused_pair_gflops": 8000.0, "device": "NVIDIA H100 80GB HBM3"}
    lines = [rec, dict(rec, M=1 << 13, nnz=1 << 16, fused_pair_gflops=9000.0),
             dict(rec, kernel="cuda-f32", fused_pair_gflops=5000.0)]
    records.write_text("\n".join(json.dumps(x) for x in lines) + "\nnot json\n")
    assert cm.measured_flops_rate("cuda-bf16", config=cm.HEADLINE_CONFIG) == 8000e9
    assert cm.measured_flops_rate("cuda-bf16") == 9000e9
    assert cm.Machine().flops_rate == 8000e9  # the headline's, not the best
    assert cm.family_flops_rate("cuda-f32") == 5000e9
    assert cm.family_flops_rate("torch") == cm.FALLBACK_FLOPS_RATES["torch"]


def test_main_prints_curves(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv(cm.KERNEL_RECORDS_ENV, str(tmp_path / "none.jsonl"))
    assert cm.main(["12", "8", "64", "16"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["machine"]["flops_rate_source"] == "fallback literal (no kernel records)"
    assert set(out["models"]) == {"15d_fusion2", "15d_fusion1", "15d_unfused", "15d_sparse"}
    assert all(1 <= m["c_optimal"] <= 16 for m in out["models"].values())


def test_variant_cost_factor_near_one_on_uniform_rows_and_a_discount_on_skew():
    uniform = Problem(M=1 << 20, N=1 << 20, nnz=33553906, R=128, row_max=65)
    skewed = Problem(M=1 << 20, N=1 << 20, nnz=31404221, R=128, row_max=65116)
    for prob in (uniform, skewed):
        vid = variants.select_variant(prob).variant_id
        assert variants.select_variant(prob).banked
        assert variants.estimated_pad_frac(prob, banked=False) >= 0
    f_uniform = variants.variant_cost_factor(uniform, "v1.rb32.rm")
    assert 1.0 < f_uniform < 1.05
    assert variants.variant_cost_factor(skewed, "v1.rb32.rm") == 0.6
    assert variants.estimated_pad_frac(skewed, banked=True) < \
        variants.estimated_pad_frac(skewed, banked=False)
    assert variants.variant_cost_factor(uniform, "v1.rb0.rl") == 1.0  # not banked
    assert variants.variant_cost_factor(uniform, "v9.rb4.rs") == 1.0  # unknown id
    # Without the heaviest row the Poisson estimate stands in: uniform.
    guess = Problem(M=1 << 16, N=1 << 16, nnz=1 << 21, R=128)
    assert 32 < variants.heaviest_row(guess) < 64
    assert variants.variant_cost_factor(guess, "v1.rb32.rm") > 1.0
