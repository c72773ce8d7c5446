"""Keeps training events of in-process control-plane tests off disk.

Both packages' rendezvous managers, agents and savers emit training
events through a per-process emitter cache, and the JAX package's
exporter writes to a fixed directory by default. A test that drives
them in-process turns the exporter off and gives each package a fresh
emitter cache, so nothing is written outside the test's own directories
whatever ran earlier in the process.
"""

import importlib

PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")


def events_off(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_EVENT_EXPORTER", "off")
    for pkg in PACKAGES:
        emitter = importlib.import_module(f"{pkg}.training_event.emitter")
        monkeypatch.setattr(emitter, "_emitters", {})
