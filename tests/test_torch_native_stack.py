"""The port's native stack capture (``tpu_timer/native_stack.py`` and
``native/tpu_timer/stack_sampler.cc``), against the JAX package's.

A worker wedged inside a C call (libc ``sleep`` through ctypes, which
faulthandler shows as one opaque Python line) is sampled by the port's
sampler, with libunwind where it is installed and by its own stack scan
over the mapped ELF symbols (the path a host without libunwind takes):
each names the native frame. ``parse_native_dumps`` equals the
reference's on the same text, and the analysis CLI folds Python and
native stacks together. Sampling disturbs no live target: a sampler
killed at any moment, or a signal that arrives while a thread is
stopped, leaves the target running with its signals delivered."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from dlrover_tpu.tpu_timer.native_stack import (
    parse_native_dumps as ref_parse_native_dumps,
)
from dlrover_tpu_torch.tpu_timer import analysis, bridge, native_stack
from dlrover_tpu_torch.tpu_timer.native_stack import (
    parse_native_dumps,
    sample_native_stacks,
)

_WEDGED = (
    "import ctypes, sys\n"
    "libc = ctypes.CDLL('libc.so.6')\n"
    "sys.stdout.write('READY\\n'); sys.stdout.flush()\n"
    "libc.sleep(120)\n"
)


@pytest.fixture
def wedged_worker():
    proc = subprocess.Popen(
        [sys.executable, "-c", _WEDGED], stdout=subprocess.PIPE
    )
    try:
        line = proc.stdout.readline()  # blocks until the marker
        assert b"READY" in line
        time.sleep(0.5)  # marker -> inside the C call
        assert proc.poll() is None
        yield proc
    finally:
        proc.kill()
        proc.wait()


def _sample(pid, scan=False, tries=4):
    """Sample, retrying while the dump shows the worker short of the
    sleep chain (scheduling slop on a loaded host)."""
    text = None
    for _ in range(tries):
        if scan:
            out = subprocess.run(
                [native_stack.ensure_built(), str(pid), "64", "scan"],
                capture_output=True, text=True, timeout=60)
            text = out.stdout if out.returncode == 0 else None
        else:
            text = sample_native_stacks(pid)
        if text and "sleep" in text:
            return text
        time.sleep(1.0)
    return text


@pytest.mark.parametrize("scan", [False, True])
def test_sampler_names_the_native_frame(wedged_worker, scan):
    text = _sample(wedged_worker.pid, scan=scan)
    assert text is not None
    assert f"Native thread {wedged_worker.pid} (most recent call first):" \
        in text
    stacks = parse_native_dumps(text)
    assert stacks and any(
        any("sleep" in frame for frame in stack) for stack in stacks)
    # The innermost frame is in libc's sleep chain.
    assert any("sleep" in stack[-1] for stack in stacks)


def test_parse_and_fold_match_the_reference(wedged_worker):
    text = _sample(wedged_worker.pid)
    noisy = ("worker log line\nNative thread 1 (most recent call first):\n"
             "  #0 0x0000000000000001 ??\n\n" + text +
             "\nTraceback (most recent call last):\n  File \"x.py\", line 3"
             " in f\n")
    assert parse_native_dumps(noisy) == ref_parse_native_dumps(noisy)
    stacks = parse_native_dumps(noisy)
    folded = analysis.fold_stacks(stacks)
    assert sum(folded.values()) == len([s for s in stacks if s])
    assert analysis.top_frames(stacks)[0][1] >= 1


def test_parse_native_dumps_ignores_unrelated_text():
    text = "nothing\n  #0 0x1 sym\nThread 0x1 (most recent call first):\n"
    assert parse_native_dumps(text) == ref_parse_native_dumps(text) == []


def test_analysis_cli_folds_python_and_native(tmp_path, wedged_worker,
                                              capsys):
    native = _sample(wedged_worker.pid)
    python = (
        "Thread 0x00007f0000000001 (most recent call first):\n"
        '  File "/w/train.py", line 12 in step\n'
        '  File "/w/train.py", line 40 in main\n\n'
    )
    log = tmp_path / "worker.log"
    log.write_text(python + native)
    assert analysis.main(["stacks", str(log), "--folded"]) == 0
    out = capsys.readouterr().out
    assert "main (train.py:40);step (train.py:12) 1" in out
    assert "sleep" in out


def test_sampler_builds_into_the_build_dir():
    path = Path(native_stack.ensure_built())
    assert path.parent == bridge.BUILD_DIR
    assert path.name.startswith("stack_sampler_") and path.exists()
    assert native_stack.ensure_built() == str(path)


def test_missing_target_degrades_to_none():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    assert sample_native_stacks(proc.pid, timeout=30) is None


# A live target: a main loop that prints its count and the SIGUSR1s its
# handler ran, beside threads asleep in a futex and in nanosleep.
_LIVE = r"""
import signal, sys, threading, time
got = [0]
signal.signal(signal.SIGUSR1, lambda *a: got.__setitem__(0, got[0] + 1))
for _ in range(2):
    threading.Thread(target=threading.Event().wait, daemon=True).start()
def naps():
    while True:
        time.sleep(0.003)
threading.Thread(target=naps, daemon=True).start()
n = 0
while True:
    n += 1
    sys.stdout.write(f"{n} {got[0]}\n")
    sys.stdout.flush()
    time.sleep(0.005)
"""


@pytest.fixture
def live_target():
    proc = subprocess.Popen([sys.executable, "-c", _LIVE],
                            stdout=subprocess.PIPE, text=True)
    last = {}

    def read():
        for line in proc.stdout:
            n, got = line.split()
            last.update(n=int(n), got=int(got))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        deadline = time.time() + 60
        while "n" not in last:
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.01)
        yield proc, last
    finally:
        proc.kill()
        proc.wait()
        reader.join(timeout=10)


def _stopped_threads(pid):
    """The threads of ``pid`` in a stop (state T or t)."""
    out = []
    for tid in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{tid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state in "tT":
            out.append(tid)
    return out


def _still_counting(last, seconds=0.5):
    n = last["n"]
    time.sleep(seconds)
    return last["n"] > n


def test_sampler_killed_mid_attach_leaves_the_target_running(live_target):
    """A sampler SIGKILLed at random moments of its walk (the agent's
    timeout) leaves no stop behind: every thread of the target runs on."""
    proc, last = live_target
    tool = native_stack.ensure_built()
    rng = random.Random(0)
    for _ in range(40):
        sampler = subprocess.Popen([tool, str(proc.pid), "64", "scan"],
                                   stdout=subprocess.DEVNULL,
                                   stderr=subprocess.DEVNULL)
        time.sleep(rng.uniform(0.0, 0.01))
        sampler.kill()
        sampler.wait()
    time.sleep(0.2)
    assert _stopped_threads(proc.pid) == []
    assert proc.poll() is None and _still_counting(last)


def test_signal_during_sampling_is_delivered(live_target):
    """SIGUSR1s sent while the sampler walks the target reach its
    handler, each one, and leave it running."""
    proc, last = live_target
    tool = native_stack.ensure_built()
    sent = 0
    for _ in range(10):
        sampler = subprocess.Popen([tool, str(proc.pid), "64", "scan"],
                                   stdout=subprocess.DEVNULL,
                                   stderr=subprocess.DEVNULL)
        os.kill(proc.pid, signal.SIGUSR1)
        sent += 1
        assert sampler.wait(timeout=60) == 0
        time.sleep(0.1)
    deadline = time.time() + 10
    while last["got"] < sent and time.time() < deadline:
        time.sleep(0.05)
    assert last["got"] == sent
    assert _stopped_threads(proc.pid) == []
    assert proc.poll() is None and _still_counting(last)
