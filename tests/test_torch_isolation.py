"""The port stands alone: it imports neither JAX nor anything of the
JAX package. Checked in a fresh interpreter that serves and takes a
training step on the CPU (this test process has JAX loaded by
``tests/conftest.py``) and by a scan of every import statement in the
port's sources and in ``chip_smoke.py``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dlrover_tpu_torch"

_CHILD = r"""
import importlib, json, pkgutil, sys
import numpy as np
import dlrover_tpu_torch
for m in pkgutil.walk_packages(dlrover_tpu_torch.__path__,
                               "dlrover_tpu_torch."):
    importlib.import_module(m.name)
from dlrover_tpu_torch.models import generate, llama
from dlrover_tpu_torch.serving import ServingEngine
import torch
cfg = llama.tiny_config()
params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
out = generate.generate(cfg, params, np.zeros((1, 3), np.int32), 3,
                        device="cpu")
eng = ServingEngine(cfg, params, slots=1, max_len=16, prefill_chunk=8,
                    device="cpu")
req = eng.submit(np.arange(4), 2)
eng.run_until_idle()
from dlrover_tpu_torch.trainer import train_step as ts
tc = ts.TrainConfig(grad_accum=2)
opt = ts.make_optimizer(tc)
state = ts.init_train_state(cfg, opt, params)
state, m = ts.make_train_step(cfg, tc, opt, device="cpu")(
    state, {"tokens": np.zeros((4, 9), np.int32)})
print(json.dumps({
    "tokens": out.tokens.shape[1] + len(req.tokens),
    "train_step": state["step"], "loss": float(m["loss"]),
    "leaked": sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith(("jax.", "jaxlib"))
        or m == "dlrover_tpu" or m.startswith("dlrover_tpu.")
    ),
}))
"""


def test_port_runs_without_loading_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["tokens"] == 5
    assert result["train_step"] == 1 and result["loss"] > 0
    assert result["leaked"] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", _SOURCES, ids=[str(p.relative_to(REPO)) for p in _SOURCES]
)
def test_source_imports_no_jax_and_no_jax_package(path):
    bad = [
        name for name in _imports(path)
        if name.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu")
    ]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"
