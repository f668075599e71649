"""The port's resilience layer (``resilience/checkpoint.py``,
``resilience/guards.py``, ``utils/atomic.py``): the JAX package's store
cases on the port's store, each package reading the other's store bit for
bit, and the guards' knobs (``SDDMM_TORCH_GUARDS``,
``SDDMM_TORCH_GUARD_MODE``). The JAX package's write-fault hook is not
ported, so a torn or garbled write is made by editing the file."""

import json
import math

import numpy as np
import pytest
import torch

from distributed_sddmm_tpu.resilience import CheckpointStore as JaxStore

from distributed_sddmm_tpu_torch.resilience import (
    CGGuard, CheckpointStore, NumericalFault, all_finite, check_finite,
    default_checkpoint_dir, guard_output,
)
from distributed_sddmm_tpu_torch.resilience import checkpoint as ckpt_mod
from distributed_sddmm_tpu_torch.resilience import guards
from distributed_sddmm_tpu_torch.utils import atomic


def _arrays(scale=1.0):
    rng = np.random.default_rng(0)
    return {"A": (rng.random((6, 4)) * scale).astype(np.float32),
            "B": (rng.random((5, 4)) * scale).astype(np.float32)}


# ------------------------------------------------------------------ store


def test_save_load_roundtrip_bit_exact(tmp_path):
    store = CheckpointStore(tmp_path)
    arrs = _arrays()
    store.save(3, arrs, meta={"kind": "als"})
    step, got, meta = store.load_latest()
    assert step == 3 and meta == {"kind": "als"}
    for k in arrs:
        assert np.array_equal(got[k], arrs[k])
    assert store.load(3)["A"].tobytes() == arrs["A"].tobytes()
    assert store.load(4) is None


def test_corrupt_latest_npz_scans_back_one_step(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _arrays(1.0))
    store.save(2, _arrays(2.0))
    p = store._step_path(2)
    p.write_bytes(p.read_bytes()[:40])  # torn write
    step, got, _ = store.load_latest()
    assert step == 1
    assert np.array_equal(got["A"], _arrays(1.0)["A"])


def test_corrupt_latest_pointer_falls_back_to_scan(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(5, _arrays())
    (tmp_path / "latest.json").write_text("{torn")
    step, _, meta = store.load_latest()
    assert step == 5 and meta == {}


def test_digest_mismatch_rejects_garbled_npz(tmp_path):
    """Bytes garbled inside the newest npz (its zip CRC fails too) never
    serve: the pointer's digest rejects them and scan-back takes step 1.
    A newest file that loads but is not what the pointer recorded is served
    by scan-back only (meta {}), never through the pointer."""
    store = CheckpointStore(tmp_path)
    store.save(1, _arrays(1.0))
    store.save(2, _arrays(2.0))
    p = store._step_path(2)
    raw = bytearray(p.read_bytes())
    mid = len(raw) // 2
    raw[mid:mid + 8] = bytes(255 - b for b in raw[mid:mid + 8])
    p.write_bytes(bytes(raw))
    step, got, _ = store.load_latest()
    assert step == 1
    assert np.array_equal(got["A"], _arrays(1.0)["A"])

    other = CheckpointStore(tmp_path / "other")
    other.save(2, _arrays(3.0))
    p.write_bytes(other._step_path(2).read_bytes())
    step, got, meta = store.load_latest()
    assert step == 2 and meta == {}
    assert np.array_equal(got["A"], _arrays(3.0)["A"])


def test_schema_version_rollback_reads_as_miss(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _arrays(), meta={"kind": "als"})
    rec = json.loads((tmp_path / "latest.json").read_text())
    rec["schema_version"] = ckpt_mod.SCHEMA_VERSION + 1
    (tmp_path / "latest.json").write_text(json.dumps(rec))
    step, _, meta = store.load_latest()
    assert step == 1 and meta == {}


def test_empty_store_returns_none(tmp_path):
    assert CheckpointStore(tmp_path / "nonexistent").load_latest() is None
    assert CheckpointStore(tmp_path / "nonexistent").steps() == []


def test_prune_keeps_last_k(tmp_path):
    store = CheckpointStore(tmp_path, keep_last=2)
    for s in range(1, 6):
        store.save(s, _arrays())
    assert store.steps() == [4, 5]
    assert store.load_latest()[0] == 5


def test_default_checkpoint_dir(monkeypatch, tmp_path):
    monkeypatch.delenv(ckpt_mod.CHECKPOINT_DIR_ENV, raising=False)
    assert default_checkpoint_dir("run") == ckpt_mod.DEFAULT_ROOT / "run"
    assert ckpt_mod.DEFAULT_ROOT.parts[-2:] == ("artifacts", "checkpoints")
    monkeypatch.setenv(ckpt_mod.CHECKPOINT_DIR_ENV, str(tmp_path))
    assert default_checkpoint_dir() == tmp_path / "default"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_store(tmp_path, writer):
    """Same files, same pointer: a store written by one package loads in
    the other bit for bit, with its step and meta; the pointer files carry
    the same keys."""
    arrs = _arrays(1.5)
    meta = {"kind": "als", "R": 4, "M": 6, "N": 5}
    write, read = ((CheckpointStore, JaxStore) if writer == "port"
                   else (JaxStore, CheckpointStore))
    write(tmp_path).save(7, arrs, meta=meta)
    step, got, got_meta = read(tmp_path).load_latest()
    assert step == 7 and got_meta == meta
    for k in arrs:
        assert got[k].dtype == arrs[k].dtype and np.array_equal(got[k], arrs[k])
    ptr = json.loads((tmp_path / "latest.json").read_text())
    assert set(ptr) == {"schema_version", "step", "file", "digest", "meta"}
    assert ptr["file"] == "step_00000007.npz"
    assert ckpt_mod.SCHEMA_VERSION == ptr["schema_version"]


# ----------------------------------------------------------------- atomic


def test_atomic_writes_leave_no_temp_files(tmp_path):
    path = tmp_path / "sub" / "x.json"
    atomic.atomic_write_json(path, {"b": 1, "a": [1, 2]})
    assert json.loads(path.read_text()) == {"a": [1, 2], "b": 1}
    atomic.atomic_write_bytes(path.with_suffix(".bin"), b"\x00\x01")
    assert path.with_suffix(".bin").read_bytes() == b"\x00\x01"
    with pytest.raises(TypeError):
        atomic.atomic_write_bytes(path, "not bytes")
    assert json.loads(path.read_text()) == {"a": [1, 2], "b": 1}
    assert sorted(p.name for p in path.parent.iterdir()) == ["x.bin", "x.json"]


# ----------------------------------------------------------------- guards


@pytest.mark.parametrize("value,on", [(None, False), ("", False), ("1", True),
                                      ("on", True), ("TRUE", True), ("yes", True),
                                      ("0", False), ("off", False)])
def test_guards_off_by_default_and_on_by_env(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv(guards.GUARDS_ENV, raising=False)
    else:
        monkeypatch.setenv(guards.GUARDS_ENV, value)
    assert guards.enabled() is on


def test_guard_mode_env(monkeypatch):
    monkeypatch.delenv(guards.GUARD_MODE_ENV, raising=False)
    assert guards.guard_mode() == "raise"
    monkeypatch.setenv(guards.GUARD_MODE_ENV, "Repair")
    assert guards.guard_mode() == "repair"
    monkeypatch.setenv(guards.GUARD_MODE_ENV, "ignore")
    assert guards.guard_mode() == "raise"


def test_guard_output_raises_or_repairs(monkeypatch):
    bad = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    ints = torch.tensor([1, 2])
    tree = {"x": [bad, ints], "y": torch.ones(2)}
    assert not all_finite(tree) and all_finite({"y": torch.ones(2), "i": ints})
    with pytest.raises(NumericalFault, match="output of op1"):
        check_finite("op1", tree)
    with pytest.raises(NumericalFault, match="output of op2"):
        guard_output("op2", tree, mode="raise")
    fixed = guard_output("op3", tree, mode="repair")
    assert all_finite(fixed) and fixed["x"][1] is ints
    assert fixed["x"][0][1] == 0 and math.isfinite(float(fixed["x"][0][2]))
    good = torch.ones(3)
    assert guard_output("op4", good) is good
    monkeypatch.setenv(guards.GUARD_MODE_ENV, "repair")
    assert all_finite(guard_output("op5", bad))


def test_cg_guard_trips_on_growth_and_non_finite():
    g = CGGuard(growth_tol=10.0, patience=2)
    assert not g.update(1.0) and not g.update(0.5)
    assert not g.update(6.0)   # one strike
    assert g.update(7.0)       # two in a row
    g = CGGuard()
    assert not g.update(1.0) and not g.update(20.0) and not g.update(2.0)
    assert not g.update(30.0)  # strikes reset by the 2.0
    assert CGGuard().update(float("nan")) and CGGuard().update(float("inf"))
