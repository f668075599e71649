"""The port's elastic membership (``distributed_sddmm_tpu_torch/dist/
elastic.py``): the JAX drill of ``tests/test_dist_elastic.py`` on the CPU.

Two workers (``chip_smoke.py --dist-worker``, the same worker the card
runs, so it imports no JAX) each run shards of an R-mat drawn by
``rmat_partitioned``, a step ``x <- 0.5 x + S_s B`` through the SpMM tile
kernel's plain version, a checkpoint a step. A ``kill`` fault fells
worker 1 after step 3's compute, before its checkpoint; ``on_loss`` tears
shard 1's checkpoint pointer; generation 1 at p = 1 resumes both shards
(shard 1 by scan-back) and finishes bit-equal to an uninterrupted run.
The JAX drill's step is ``x <- 0.5 x + r`` with ``r`` the row sums of an
Erdos-Renyi shard: the port's with ``B`` a column of ones, so the two
packages' uninterrupted fingerprints agree within float32 rounding.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from distributed_sddmm_tpu_torch.dist import elastic  # noqa: E402
from distributed_sddmm_tpu_torch.dist.elastic import ElasticSupervisor  # noqa: E402
from distributed_sddmm_tpu_torch.resilience.faults import KILL_EXIT_CODE  # noqa: E402

os.environ["SDDMM_TORCH_RUNSTORE"] = "0"
os.environ["SDDMM_TORCH_PROGRAMS"] = "0"

#: The card's drill (``chip_smoke.DRILL``) cut to a small R-mat.
SPEC = {**chip_smoke.DRILL, "device": "cpu", "log_m": 9, "edge_factor": 8, "R": 16}
#: The JAX drill's data and step: ``B`` a column of ones.
JAX_SPEC = {**SPEC, "data": "er", "R": 1, "b": "ones"}
#: float32 rounding of the row sums and the steps, summed over ~50 rows.
FINGERPRINT_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _no_jax_on_the_worker_path(monkeypatch):
    """The workers start from a clean interpreter on the repo root."""
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    for k in ("JAX_PLATFORMS", "XLA_FLAGS", "SDDMM_TORCH_FAULTS"):
        monkeypatch.delenv(k, raising=False)


def _uninterrupted(spec) -> dict:
    return {str(s): chip_smoke.drill_shard(spec, s) for s in range(spec["nshards"])}


def test_two_worker_kill_and_recover_drill(tmp_path):
    kill_step = SPEC["kill_step"]

    def tear_pointer(result):
        latest = tmp_path / "ckpt" / "shard1" / "latest.json"
        assert latest.exists()
        latest.write_text("{torn")

    result = chip_smoke.run_drill(SPEC, tmp_path, on_loss=tear_pointer,
                                  generation_timeout_s=240, grace_s=90)
    gen0 = result.generations[0]
    assert gen0.lost == [1] and gen0.returncodes[1] == KILL_EXIT_CODE
    assert gen0.returncodes[0] == 0 and gen0.records[0]["shards"]
    assert result.recovered and result.ok
    gen1 = result.generations[1]
    assert gen1.live_p == 1 and gen1.ok
    final = gen1.records[0]
    want = _uninterrupted(SPEC)
    assert set(final["digests"]) == {"0", "1"}
    assert final["digests"] == {s: w["sha256"] for s, w in want.items()}  # bit-equal
    assert final["shards"] == {s: w["fingerprint"] for s, w in want.items()}
    assert not any(r["jax_loaded"] for g in result.generations for r in g.records if r)

    facts = chip_smoke.drill_trace_facts(tmp_path / "traces")
    assert facts["shard_files"] == 3  # generation 0's two workers, generation 1's one
    assert {"step": kill_step - 1, "source": "scan_back"} in facts["checkpoint_loads"]
    steps = facts["steps"]
    assert {"0:0", "0:1", "1:0"} <= set(steps)
    assert max(t for _, t in steps["0:1"]) == kill_step
    assert sorted(map(tuple, steps["1:0"])) == [(1, t) for t in range(kill_step,
                                                                     SPEC["steps"])]


def test_supervisor_clean_run_single_generation(tmp_path):
    spec = {**SPEC, "steps": 2}
    result = chip_smoke.run_drill(spec, tmp_path, kill=False, generation_timeout_s=180,
                                  grace_s=60)
    assert result.ok and not result.recovered
    assert len(result.generations) == 1
    assert [r["pid"] for r in result.records] == [0, 1]
    want = _uninterrupted(spec)
    assert {**result.records[0]["digests"], **result.records[1]["digests"]} == {
        s: w["sha256"] for s, w in want.items()}


def test_watch_reaps_a_hung_survivor():
    sup = ElasticSupervisor(
        lambda g, p, w, port: [
            "-c", "import sys, time; "
            "sys.exit(7) if int(sys.argv[1]) == 1 else time.sleep(60)", str(w)],
        2, max_recoveries=0, generation_timeout_s=120, grace_s=2)
    t0 = time.monotonic()
    result = sup.run()
    assert time.monotonic() - t0 < 60
    gen0 = result.generations[0]
    assert gen0.lost == [1] and gen0.reaped == [0]
    assert not result.ok and not result.recovered


def test_port_drill_agrees_with_the_jax_drill():
    """JAX ``tests/test_dist_elastic.py``'s uninterrupted fingerprints
    (its worker's ``0.5 x + r`` under ``jax.jit``) against the port's step
    with ``B`` ones, on the same partitioned Erdos-Renyi shards."""
    import jax
    import jax.numpy as jnp

    from distributed_sddmm_tpu.dist import ingest

    step_fn = jax.jit(lambda x, r: 0.5 * x + r)
    want = {}
    for s in range(JAX_SPEC["nshards"]):
        shard = ingest.erdos_renyi_partitioned(96, 80, 4, JAX_SPEC["nshards"], s, seed=5,
                                               values="normal", chunk_edges=64)
        drive = np.zeros(max(shard.row1 - shard.row0, 1))
        np.add.at(drive, shard.coo.rows - shard.row0, shard.coo.vals)
        x, r = jnp.zeros_like(jnp.asarray(drive)), jnp.asarray(drive)
        for _ in range(JAX_SPEC["steps"]):
            x = step_fn(x, r)
        want[str(s)] = float(np.sum(np.asarray(x, np.float64) ** 2))
    got = {s: r["fingerprint"] for s, r in _uninterrupted(JAX_SPEC).items()}
    for s in want:
        assert got[s] == pytest.approx(want[s], rel=FINGERPRINT_RTOL)


def test_last_json_line_and_spawn_helpers(tmp_path):
    proc = elastic.spawn_process([sys.executable, "-c",
                                  "import sys; print('noise'); print('{\"a\": 1}'); "
                                  "print('[1, 2]'); print('x' * 70000, file=sys.stderr)"])
    proc.wait(timeout=60)
    out, err = elastic.collect_output(proc)
    assert elastic.last_json_line(out) == {"a": 1}
    assert len(err) > 65536  # a temp file, not a pipe that would fill
    assert elastic.last_json_line("no json\n") is None
    port = elastic.free_port()
    assert 0 < port < 65536


def test_worker_prints_one_json_line_without_jax(tmp_path):
    """One worker alone (``--dist-worker``), as the supervisor starts it."""
    import subprocess

    spec = {**SPEC, "pid": 0, "nprocs": 1, "generation": 0, "steps": 1,
            "checkpoint_dir": str(tmp_path / "ckpt")}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker",
                           json.dumps(spec)], cwd=ROOT, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = elastic.last_json_line(proc.stdout)
    assert rec["jax_loaded"] is False and set(rec["shards"]) == {"0", "1"}
