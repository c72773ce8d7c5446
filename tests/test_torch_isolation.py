"""The port stands alone: it imports neither JAX nor anything of the
JAX package. Checked in a fresh interpreter that serves (flat and
paged engines, speculative decoding on both, MoE on the paged one),
takes a training step, and generates and trains one
step with a dropless MoE config on the CPU (this test process
has JAX loaded by ``tests/conftest.py``) and by a scan of every import
statement in the port's sources and in ``chip_smoke.py``."""

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
from dlrover_tpu_torch.serving import PagedServingEngine, ServingEngine
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
paged_tokens = 0
for kv in ("fp", "int8"):
    peng = PagedServingEngine(cfg, params, slots=2, max_len=16,
                              prefill_chunk=8, block_size=8,
                              kv_cache_dtype=kv, device="cpu")
    for _ in range(2):
        preq = peng.submit(np.arange(9), 2)
        peng.run_until_idle()
        paged_tokens += len(preq.tokens)
    peng.check_block_invariants()
    assert preq.prefix_hit_blocks == 1
from dlrover_tpu_torch.trainer import train_step as ts
tc = ts.TrainConfig(grad_accum=2)
opt = ts.make_optimizer(tc)
state = ts.init_train_state(cfg, opt, params)
state, m = ts.make_train_step(cfg, tc, opt, device="cpu")(
    state, {"tokens": np.zeros((4, 9), np.int32)})
moe_cfg = llama.tiny_config(n_layers=2, n_experts=4, moe_top_k=2,
                            moe_impl="dropless")
moe_params = llama.init_params(moe_cfg, torch.Generator().manual_seed(1),
                               device="cpu")
moe_out = generate.generate(moe_cfg, moe_params,
                            np.ones((2, 3), np.int32), 2, device="cpu")
spec_tokens = 0
for cls, c, p, kw in (
        (ServingEngine, cfg, params, {}),
        (PagedServingEngine, cfg, params,
         dict(block_size=8, kv_cache_dtype="int8",
              spec_drafter="early_exit")),
        (PagedServingEngine, moe_cfg, moe_params, dict(block_size=8))):
    seng = cls(c, p, slots=2, max_len=16, prefill_chunk=8, spec_k=2,
               device="cpu", **kw)
    sreq = seng.submit(np.arange(4), 3)
    seng.run_until_idle()
    spec_tokens += len(sreq.tokens)
moe_tc = ts.TrainConfig()
moe_opt = ts.make_optimizer(moe_tc)
moe_state = ts.init_train_state(moe_cfg, moe_opt, moe_params)
moe_state, moe_m = ts.make_train_step(moe_cfg, moe_tc, moe_opt,
                                      device="cpu")(
    moe_state, {"tokens": np.arange(18, dtype=np.int32).reshape(2, 9)})
print(json.dumps({
    "tokens": out.tokens.shape[1] + len(req.tokens),
    "paged_tokens": paged_tokens, "spec_tokens": spec_tokens,
    "train_step": state["step"], "loss": float(m["loss"]),
    "moe_tokens": list(moe_out.tokens.shape),
    "moe_train_step": moe_state["step"], "moe_loss": float(moe_m["loss"]),
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
    assert result["paged_tokens"] == 8
    assert result["spec_tokens"] == 9
    assert result["train_step"] == 1 and result["loss"] > 0
    assert result["moe_tokens"] == [2, 2]
    assert result["moe_train_step"] == 1 and result["moe_loss"] > 0
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


def test_scan_covers_the_paged_engine_modules():
    scanned = {str(p.relative_to(PORT)) for p in _SOURCES[:-1]}
    assert {"serving/kvpool/__init__.py", "serving/kvpool/allocator.py",
            "serving/kvpool/engine.py",
            "serving/kvpool/prefix_cache.py", "models/moe.py",
            "ops/moe_dispatch.py"} <= scanned


@pytest.mark.parametrize(
    "path", _SOURCES, ids=[str(p.relative_to(REPO)) for p in _SOURCES]
)
def test_source_imports_no_jax_and_no_jax_package(path):
    bad = [
        name for name in _imports(path)
        if name.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu")
    ]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


_KERNEL_SOURCES = sorted((PORT / "ops" / "csrc").glob("*.cu"))


@pytest.mark.parametrize("path", _KERNEL_SOURCES,
                         ids=[p.name for p in _KERNEL_SOURCES])
def test_kernel_source_is_self_contained(path):
    """``ops/_ext.library_path`` hashes only the source's own bytes, so a
    kernel source may include system and toolkit headers but none of the
    port's own; and every source in ``csrc/`` is one ``_ext`` builds."""
    from dlrover_tpu_torch.ops import _ext

    assert path.name in _ext.SOURCES
    local = [ln for ln in path.read_text().splitlines()
             if ln.lstrip().startswith("#include") and '"' in ln]
    assert local == [], f"{path.name} includes {local}"


def test_library_name_follows_the_source_bytes(tmp_path, monkeypatch):
    """An edited source gets a library of another name (built anew); the
    same bytes give the same name."""
    from dlrover_tpu_torch.ops import _ext

    monkeypatch.setattr(_ext, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _ext.library_path("k.cu")
    assert _ext.library_path("k.cu") == first
    src.write_text("// two\n")
    assert _ext.library_path("k.cu") != first
    assert first.parent == _ext.BUILD_DIR and first.suffix == ".so"
