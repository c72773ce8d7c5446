"""Profiler launch wrapper: run any training command under the
zero-cooperation capture listener (the port's copy of
``dlrover_tpu/tpu_timer/launch.py``).

Parity: reference ``xpu_timer_launch`` (py_xpu_timer's entry wrapper
around LD_PRELOAD) — the ergonomic path for scripts NOT started by the
elastic agent (the agent injects the same environment itself,
agent/training.py). The wrapped command needs no code changes: the
injection dir's sitecustomize arms the capture listener at interpreter
startup, the native daemon serves /metrics and /timeline, and captures
can be triggered any time via the trigger file
(xla_capture.request_xla_capture).

    python -m dlrover_tpu_torch.tpu_timer.launch -- python train.py --steps 100
    python -m dlrover_tpu_torch.tpu_timer.launch --interval 30 --window 0.5 \
        -- python -m mypkg.train

Everything after ``--`` is exec'd verbatim (this process is replaced:
signals, exit code, and the controlling terminal all pass through).
"""

import argparse
import os
import sys


def build_env(
    interval_s: float = 60.0,
    window_s: float = 1.0,
    env: dict = None,
) -> dict:
    """The environment the agent injects, reproduced for standalone
    runs: capture flag + cadence, injection dir + package root on
    PYTHONPATH (shared with tests so the two paths cannot diverge)."""
    env = dict(os.environ if env is None else env)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    inject_dir = os.path.join(
        pkg_root, "dlrover_tpu_torch", "tpu_timer", "_inject"
    )
    parts = [inject_dir, pkg_root]
    existing = env.get("PYTHONPATH", "")
    if existing:
        parts.append(existing)
    env["PYTHONPATH"] = os.pathsep.join(parts)
    env["DLROVER_TPU_TIMER_XLA"] = "1"
    env["DLROVER_TPU_TIMER_XLA_INTERVAL"] = str(interval_s)
    env["DLROVER_TPU_TIMER_XLA_WINDOW"] = str(window_s)
    return env


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        own, cmd = argv[:split], argv[split + 1:]
    else:
        own, cmd = [], argv
    ap = argparse.ArgumentParser(
        description="run a command under the XLA capture listener"
    )
    ap.add_argument("--interval", type=float, default=60.0,
                    help="periodic capture interval, seconds")
    ap.add_argument("--window", type=float, default=1.0,
                    help="capture window length, seconds")
    ns = ap.parse_args(own)
    if not cmd:
        ap.error("no command given (usage: ... -- python train.py)")
    env = build_env(ns.interval, ns.window)
    os.execvpe(cmd[0], cmd, env)  # no return


if __name__ == "__main__":
    raise SystemExit(main())
