"""The port's hang watchdog (``dlrover_tpu_torch/observability/
hang_watchdog.py``) against the JAX package's: on one fake clock and one
seeded beat sequence both ``check()``s fire at the same calls with the
same ``hang_for_s``, ``deadline_s`` and ``beats`` (exact: the same
float arithmetic); their dump files carry the same keys and each
package's ``collect_hang_dumps`` reads the other's, with the same age
cutoff. Also: one dump per hang episode, the dump counter in the port's
registry, the process watchdog's install/active/reset, and the worker
runtime arming it from ``DLROVER_TPU_HANG_DEADLINE_S`` (0 disables it).
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dlrover_tpu.observability import hang_watchdog as ref_hw
from dlrover_tpu_torch.observability import hang_watchdog as port_hw
from dlrover_tpu_torch.observability.registry import default_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    yield tmp_path / "flight"
    port_hw.reset_watchdog()
    ref_hw.reset_watchdog()


def _script(seed, n=400):
    """A seeded sequence of (kind, time) calls on one fake clock: beats
    at jittered gaps with long silences between them, and checks every
    so often."""
    rng = np.random.default_rng(seed)
    t, calls = 1000.0, []
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            t += float(rng.exponential(2.0))
            calls.append(("beat", t))
        elif r < 0.65:
            t += float(rng.uniform(20.0, 200.0))
            calls.append(("check", t))
        else:
            t += float(rng.uniform(0.0, 5.0))
            calls.append(("check", t))
    return calls


def _drive(mod, calls, tmp_path, tag):
    fired = []
    wd = mod.HangWatchdog(
        name="train", dump_path=str(tmp_path / f"{tag}.json"),
        deadline_factor=8.0, min_deadline_s=30.0,
        clock=lambda: (_ for _ in ()).throw(AssertionError("clock read")),
        on_hang=lambda info: fired.append(
            {k: info[k] for k in ("name", "hang_for_s", "deadline_s",
                                  "beats")}))
    out = []
    for i, (kind, t) in enumerate(calls):
        if kind == "beat":
            wd.beat(now=t)
        else:
            got = wd.check(now=t)
            out.append((i, got is not None, wd.deadline_s()))
    return out, fired, wd.dumps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_check_fires_at_the_same_calls_as_the_reference(tmp_path, seed):
    calls = _script(seed)
    port, port_fired, port_dumps = _drive(port_hw, calls, tmp_path, "port")
    ref, ref_fired, ref_dumps = _drive(ref_hw, calls, tmp_path, "ref")
    assert port == ref
    assert port_fired == ref_fired and port_dumps == ref_dumps
    assert port_dumps >= 3, "the script should hold several hang episodes"
    # One dump per episode: a check after a fired one, with no beat
    # between them, never fires again.
    fired_at = [i for i, hit, _ in port if hit]
    beats = [i for i, (kind, _) in enumerate(calls) if kind == "beat"]
    for a, b in zip(fired_at, fired_at[1:]):
        assert any(a < i < b for i in beats)


def test_dump_counter_counts_in_the_port_registry(tmp_path):
    counter = default_registry().counter(
        "hang_watchdog_dumps_total",
        "stack dumps captured by the hang watchdog")
    before = counter.value()
    wd = port_hw.HangWatchdog(min_deadline_s=1.0, clock=lambda: 0.0)
    wd.beat(now=0.0)
    assert wd.check(now=0.5) is None
    assert wd.check(now=2.0) == "captured"
    assert wd.check(now=3.0) is None
    assert counter.value() == before + 1


def _dump_with(mod, path, meta):
    wd = mod.HangWatchdog(name="train", dump_path=path, min_deadline_s=1.0,
                          meta=meta, clock=lambda: 0.0)
    wd.beat(now=0.0)
    assert wd.check(now=5.0) == path
    with open(path) as f:
        return json.load(f)


def test_dump_files_have_the_same_keys_and_cross_read(flight_dir):
    meta = {"node_rank": 2, "local_rank": 1, "process_id": 5}
    port = _dump_with(port_hw, port_hw.hang_dump_path(2, 1), meta)
    ref = _dump_with(ref_hw, ref_hw.hang_dump_path(3, 1), meta)
    assert port_hw.hang_dump_path(2, 1) == ref_hw.hang_dump_path(2, 1)
    assert sorted(port) == sorted(ref)
    for dump in (port, ref):
        assert dump["kind"] == "stack_dump" and dump["reason"] == "hang:train"
        assert (dump["hang_for_s"], dump["deadline_s"], dump["beats"]) == (
            5.0, 1.0, 1)
        # The stacks name this test's frame in the main thread.
        main = [s for k, s in dump["stacks"].items()
                if k.startswith("MainThread")]
        assert any("_dump_with" in fr for fr in main[0])
    # Each package collects the other's dump, exactly.
    assert port_hw.collect_hang_dumps(3, [1]) == {1: ref}
    assert ref_hw.collect_hang_dumps(2, [1]) == {1: port}
    assert port_hw.collect_hang_dumps(2, [0, 1]) == ref_hw.collect_hang_dumps(
        2, [0, 1])


def test_collect_hang_dumps_age_cutoff_matches(flight_dir):
    for node, age in ((0, 0.0), (1, 120.0), (2, 30.0)):
        path = _dump_with(port_hw, port_hw.hang_dump_path(node, 0),
                          {"node_rank": node})
        if age:
            old = time.time() - age
            os.utime(port_hw.hang_dump_path(node, 0), (old, old))
        assert path
    # A file that is not a stack dump is skipped by both.
    with open(port_hw.hang_dump_path(3, 0), "w") as f:
        json.dump({"kind": "other"}, f)
    for max_age in (None, 10.0, 60.0, 600.0):
        got = {n: sorted(port_hw.collect_hang_dumps(n, [0], max_age))
               for n in range(5)}
        want = {n: sorted(ref_hw.collect_hang_dumps(n, [0], max_age))
                for n in range(5)}
        assert got == want
    assert sorted(n for n in range(5)
                  if port_hw.collect_hang_dumps(n, [0], 60.0)) == [0, 2]


def test_process_watchdog_install_is_idempotent(flight_dir):
    wd = port_hw.install_watchdog(node_rank=4, local_rank=2,
                                  min_deadline_s=50.0, poll_interval_s=60.0)
    try:
        assert port_hw.active_watchdog() is wd
        assert port_hw.install_watchdog(node_rank=9, local_rank=9) is wd
        assert wd._dump_path == port_hw.hang_dump_path(4, 2)
        assert wd._meta == {"node_rank": 4, "local_rank": 2}
        assert wd._thread.is_alive() and wd._thread.daemon
    finally:
        port_hw.reset_watchdog()
    assert port_hw.active_watchdog() is None and not wd._thread.is_alive()


_RUNTIME = (
    "import json, os\n"
    "from dlrover_tpu_torch.observability import hang_watchdog\n"
    "from dlrover_tpu_torch.trainer.runtime import init_distributed\n"
    "init_distributed(device='cpu')\n"
    "wd = hang_watchdog.active_watchdog()\n"
    "print(json.dumps(None if wd is None else {\n"
    "    'floor': wd._min_deadline_s, 'path': wd._dump_path,\n"
    "    'meta': wd._meta, 'alive': wd._thread.is_alive()}))\n"
)


@pytest.mark.parametrize("deadline, want", [
    (None, 300.0), ("2.5", 2.5), ("0", None), ("junk", 300.0)])
def test_runtime_arms_the_watchdog_from_the_env(flight_dir, deadline, want):
    env = dict(os.environ, PYTHONPATH=REPO, DLROVER_TPU_NODE_RANK="3",
               DLROVER_TPU_LOCAL_RANK="1", DLROVER_TPU_PROCESS_ID="7")
    env.pop("DLROVER_TPU_HANG_DEADLINE_S", None)
    if deadline is not None:
        env["DLROVER_TPU_HANG_DEADLINE_S"] = deadline
    out = subprocess.run([sys.executable, "-c", _RUNTIME], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if want is None:
        assert got is None
    else:
        assert got == {"floor": want, "alive": True,
                       "path": str(flight_dir / "hang_node3_rank1.json"),
                       "meta": {"process_id": 7, "node_rank": 3,
                                "local_rank": 1}}
