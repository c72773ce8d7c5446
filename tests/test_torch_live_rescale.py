"""The port's live rescale end to end on the CPU, held to the JAX
package's own invariants.

``run_rescale_episode(scenario="live")`` at the reference test's
settings (world 2, 960 records in shards of 16, a save every 2 steps,
80 ms steps): the port's in-process master (coordinator, task manager,
KV store, servicer over HTTP) and two ``rescale_worker`` processes
holding their int64 state as CPU tensors. One is SIGKILLed, the
survivor rescales to a world of one in-process, restores its byte
ranges of ``w`` and ``opt`` through ``load_state_regions``, a fresh
worker joins and the world goes back to two; the KV store is the
interconnect (no process group). The report carries the reference
test's assertions, and the merged ledger passes the reference's own
``dlrover_tpu.testing.rescale_soak.check_rescale_invariants`` (a copy
with one save's CRC flipped fails it). The kill-during-rescale episode
runs under the schedules the reference's chaos soak builds for seed 0
(episode 3). The worker's arithmetic and ``state_crc`` equal the
reference's on the same values.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.testing import rescale_worker as rw
from dlrover_tpu_torch.testing.rescale_soak import (
    RescaleSoakConfig,
    check_rescale_invariants,
    run_rescale_episode,
)
from dlrover_tpu_torch.testing.soak import SoakInvariantError
from dlrover_tpu_torch.testing.soak_worker import state_crc

REPO = Path(__file__).resolve().parents[1]
LIVE = dict(world=2, dataset_size=960, shard_size=16, ckpt_every=2,
            step_ms=80.0, watchdog_s=120.0)


def _reference_cfg(cfg: RescaleSoakConfig):
    from dlrover_tpu.testing import rescale_soak as ref

    fields = {f.name for f in dataclasses.fields(ref.RescaleSoakConfig)}
    return ref.RescaleSoakConfig(**{
        k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    cfg = RescaleSoakConfig(device="cpu", **LIVE)
    report = run_rescale_episode(
        seed=0, cfg=cfg, scenario="live",
        work_dir=str(tmp_path_factory.mktemp("live")))
    return cfg, report


@pytest.mark.rescale
@pytest.mark.soak
def test_live_rescale_down_then_back_up(live):
    """The reference test's assertions on the port's report."""
    _, report = live
    assert report["deaths"] == 1
    assert report["generations"] == {0: 0, 1: 1}
    # bootstrap + scale-down + scale-up = at least three plans
    assert report["plans"] >= 3
    worlds = {t["world"] for t in report["rescales"]}
    assert {1, 2} <= worlds, report["rescales"]
    reasons = {t["reason"] for t in report["rescales"]}
    assert "node_lost" in reasons
    assert any(r.startswith("scale_up") for r in reasons)
    assert any(
        t.get("plan_to_first_step_s") is not None
        for t in report["rescales"]
    ), report["rescales"]
    starts = [e for e in report["events"] if e["kind"] == "worker_start"]
    assert len(starts) == 3 and {e["device"] for e in starts} == {"cpu"}
    restores = [e for e in report["events"] if e["kind"] == "restore"]
    assert restores and all(e["bytes_read"] > 0 for e in restores)
    # Every plan's three phase barriers completed.
    for row in report["plans_cut"]:
        assert all(v is not None for v in row["barrier_wait_s"].values())


@pytest.mark.rescale
@pytest.mark.soak
def test_live_events_pass_the_reference_invariants(live):
    from dlrover_tpu.testing.rescale_soak import (
        check_rescale_invariants as reference_check,
    )

    cfg, report = live
    events = report["events"]
    reference_check(copy.deepcopy(events), _reference_cfg(cfg))
    check_rescale_invariants(copy.deepcopy(events), cfg)


@pytest.mark.rescale
@pytest.mark.soak
def test_flipped_save_crc_fails_both_invariant_checks(live):
    from dlrover_tpu.testing.rescale_soak import (
        check_rescale_invariants as reference_check,
    )
    from dlrover_tpu.testing.soak import (
        SoakInvariantError as ReferenceInvariantError,
    )

    cfg, report = live
    events = copy.deepcopy(report["events"])
    saves = [e for e in events if e["kind"] == "save" and e["step"] > 0]
    saves[len(saves) // 2]["crc"] ^= 1 << 7
    with pytest.raises(ReferenceInvariantError):
        reference_check(copy.deepcopy(events), _reference_cfg(cfg))
    with pytest.raises(SoakInvariantError):
        check_rescale_invariants(events, cfg)


@pytest.mark.rescale
@pytest.mark.chaos
@pytest.mark.soak
def test_kill_during_rescale_episode(tmp_path):
    """Chaos episode 3 at seed 0, rigged as the reference's soak rigs
    it: rank 1 dies mid-step (cutting the scale-down plan), rank 0 is
    SIGKILLed between its resume ack and its first step, and one plan
    broadcast is dropped; the respawned generation finishes."""
    from dlrover_tpu.testing.rescale_soak import (
        check_rescale_invariants as reference_check,
    )
    from dlrover_tpu.testing.soak import SoakConfig, build_episode_plan
    from dlrover_tpu_torch.fault import FaultSchedule

    scfg = SoakConfig(dataset_size=512, shard_size=16, serve=False,
                      watchdog_s=140.0)
    plan = build_episode_plan(0, 3, scfg)
    assert plan.kind == "kill_during_rescale"

    def port_schedule(s):
        return FaultSchedule.from_json(s.to_json())

    cfg = RescaleSoakConfig(
        world=2, dataset_size=scfg.dataset_size, shard_size=scfg.shard_size,
        ckpt_every=scfg.ckpt_every, step_ms=scfg.step_ms,
        watchdog_s=scfg.watchdog_s, device="cpu")
    report = run_rescale_episode(
        seed=0, cfg=cfg, scenario="kill_during_rescale",
        work_dir=str(tmp_path),
        runner_schedule=port_schedule(plan.runner_schedule),
        rank_schedules={r: port_schedule(s)
                        for r, s in plan.rank_schedules.items()})
    assert report["deaths"] == 2
    fired = {f["rule_id"] for f in report["faults"]}
    assert {"worker-sigkill", "kill-mid-rescale",
            "drop-plan-broadcast"} <= fired
    assert report["wall_s"] < cfg.watchdog_s
    reference_check(copy.deepcopy(report["events"]), _reference_cfg(cfg))


@pytest.mark.rescale
def test_worker_arithmetic_equals_the_reference():
    from dlrover_tpu.testing import rescale_worker as ref

    rng = np.random.default_rng(0)
    for vec_len, size, shard in ((64, 960, 16), (100, 500, 7)):
        starts = rng.permutation(np.arange(0, size, shard))
        ranges = [(int(s), int(min(s + shard, size)))
                  for s in starts[: len(starts) // 2]]
        want = ref.reference_state(size, ranges, vec_len)
        got = rw.reference_state(size, ranges, vec_len)
        stepped = rw.fresh_state(vec_len)
        for s, e in ranges:
            rw.apply_contribution(stepped, rw.shard_contribution(s, e,
                                                                 vec_len))
            c = rw.shard_contribution(s, e, vec_len)
            wire = rw._decode(rw._encode(rw.contribution_payload(c, s, e)))
            back = rw.contribution_from_payload(wire, vec_len, "cpu")
            assert torch.equal(back["vec"], c["vec"])
            assert torch.equal(back["hist"], c["hist"])
            assert back["sum"] == c["sum"]
        for key in want:
            assert got[key].dtype == torch.int64
            np.testing.assert_array_equal(got[key].numpy(), want[key])
            np.testing.assert_array_equal(stepped[key].numpy(), want[key])
        assert rw.world_lcm(4) == ref.world_lcm(4)
        assert rw.block_bounds(1, 3, vec_len) == ref.block_bounds(
            1, 3, vec_len)


@pytest.mark.rescale
def test_state_crc_equals_the_reference():
    from dlrover_tpu.testing import rescale_worker as ref
    from dlrover_tpu.testing.soak_worker import state_crc as ref_crc

    state = ref.reference_state(960, [(0, 16), (32, 48)])
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    assert str(tensors["w"].dtype) == "torch.int64"
    assert state_crc(tensors) == ref_crc(state) == state_crc(state)
    tensors["w"][3] += 1
    assert state_crc(tensors) != ref_crc(state)


def test_worker_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.testing.rescale_worker",
         "--master-addr", "localhost:1", "--rank", "0", "--world", "1",
         "--dataset-size", "16", "--ckpt-dir", str(tmp_path / "c"),
         "--events", str(tmp_path / "e.jsonl"), "--device", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "e.jsonl").exists()
