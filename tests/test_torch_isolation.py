"""The port stands alone: it imports neither JAX nor anything of the
JAX package. Checked in a fresh interpreter that serves (flat and
paged engines, speculative decoding on both, MoE on the paged one),
migrates a request between paged engines under tracing, routes one
through a thread-replica fleet, takes a training step, generates and
trains one step with a dropless MoE config, runs the pipeline, the
lite attention block, the ring's hop loops and the ep expert body, and
the profiler (its daemon, a per-op profile window, the metric monitor's
scrape, the timeline's summary and merge), and an autoscaler tick that
evicts a straggler through the sim scaler on the CPU (this test
process has JAX loaded by ``tests/conftest.py``); in a fleet's
subprocess worker; in the elastic training worker, which also loads no
``ml_dtypes`` on its checkpoint path; in every interpreter of the
standalone launcher's path (launcher and agent, master, worker), which
also loads neither ``grpc`` nor ``psutil``; in a live-rescale worker
and a warm standby; in the chaos soak's master, which also loads no
``torch``, and its worker; and by a scan of every import statement in
the port's sources, the ``tools/torch_*.py`` scripts and
``chip_smoke.py``."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
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
from dlrover_tpu_torch import fault
from dlrover_tpu_torch.observability import flight_recorder, tracing
from dlrover_tpu_torch.serving import fleet
from dlrover_tpu_torch.serving.kvpool import (
    export_request, import_request, release_exported)
def paged_engine():
    return PagedServingEngine(cfg, params, slots=2, max_len=16,
                              prefill_chunk=8, block_size=8, device="cpu")
src, dst = paged_engine(), paged_engine()
mreq = src.submit(np.arange(9), 4)
while mreq.state != "decode":
    src.step()
tracer = tracing.arm(tracing.Tracer(service="isolation"))
rec = flight_recorder.install_recorder()
fault.arm(fault.FaultSchedule([fault.FaultRule("serving.step.error",
                                               action="delay")]))
moved = import_request(dst, export_request(src, mreq))
release_exported(src, mreq)
dst.run_until_idle()
fault.disarm()
tracing.disarm()
router = fleet.FleetRouter([fleet.ThreadReplica("t0", paged_engine)])
router.start()
freq = router.submit(np.arange(5), 3)
router.run_until_idle(timeout_s=120.0)
router.stop()
from dlrover_tpu_torch.models import moe as moe_lib
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import ring_attention as ra
pp_cfg = llama.tiny_config(pp_stages=2, num_microbatches=2)
pp_logits, _ = llama.forward(pp_cfg, llama.init_params(
    pp_cfg, torch.Generator().manual_seed(2), device="cpu"),
    torch.zeros((2, 8), dtype=torch.long))
lite_loss, _ = llama.loss_fn(
    llama.tiny_config(remat_policy="attn_save"), params,
    {"tokens": torch.zeros((2, 9), dtype=torch.long)},
    fa.make_flash_attention())
chunks = [torch.randn(1, 8, 2, 16) for _ in range(2)]
ring = ra.one_process_ring_forward(chunks, chunks, chunks, [0, 8])
ep_rows = moe_lib.ep_expert_body(
    torch.randn(5, 64), [[2, 1], [0, 2]], 2, 16, torch.randn(2, 64, 256),
    torch.randn(2, 128, 64))
import os, tempfile
from dlrover_tpu_torch.common.metric import JobMetricMonitor
from dlrover_tpu_torch.observability import trace_merge
from dlrover_tpu_torch.tpu_timer import analysis, get_timer, xla_capture
timer = get_timer()
timer.start_server(0)
prof_rows = xla_capture.capture_op_profile(fn=lambda: llama.loss_fn(
    cfg, params, {"tokens": torch.zeros((2, 9), dtype=torch.long)}))
shares = xla_capture.bucket_by_scope(prof_rows, {"attn": ("attn",)})
xla_capture.record_events([("k", True, 0.0, 5.0)], timer.now_ns())
monitor = JobMetricMonitor({0: f"127.0.0.1:{timer.port}"})
fd, timeline_path = tempfile.mkstemp(suffix=".json")
os.close(fd)
timer.dump_timeline(timeline_path)
timeline = json.load(open(timeline_path))
os.unlink(timeline_path)
merged = trace_merge.merge_job_timeline(rank_traces={0: timeline})
from dlrover_tpu_torch import autoscaler as asc
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan
from dlrover_tpu_torch.master.scaler.sim_scaler import SimClusterScaler
from dlrover_tpu_torch.observability.registry import MetricsRegistry
from dlrover_tpu_torch.common.node import NodeGroupResource
sim = SimClusterScaler("isolation")
sim.scale(ScalePlan(node_group_resources={"worker": NodeGroupResource(2)}))
world = asc.TrainWorldActuator.for_sim(sim)
bus = asc.SignalBus().add_source("perf", lambda: {
    "straggler_ranks": [1], "straggler_scores": {1: 3.0},
    "median_step_s": 0.01}).add_source("world", world.as_source())
autoscaler = asc.AutoScaler(
    bus, policy=asc.RulePolicy(asc.PolicyConfig(straggler_confirm_ticks=1)),
    actuators=world.bindings(), registry=MetricsRegistry())
autoscaler.tick()
autoscaler.stop()
print(json.dumps({
    "autoscale": [(d.action, d.outcome)
                  for d in autoscaler.ledger.entries()],
    "world": world.world_size(),
    "tokens": out.tokens.shape[1] + len(req.tokens),
    "paged_tokens": paged_tokens, "spec_tokens": spec_tokens,
    "train_step": state["step"], "loss": float(m["loss"]),
    "moe_tokens": list(moe_out.tokens.shape),
    "moe_train_step": moe_state["step"], "moe_loss": float(moe_m["loss"]),
    "migrated_tokens": len(moved.tokens),
    "spans": sorted({s["name"] for s in tracer.finished()}),
    "annotations": len(rec.records()),
    "fleet_tokens": len(freq.result.tokens),
    "pp_logits": list(pp_logits.shape), "lite_loss": float(lite_loss),
    "ring_chunks": len(ring), "ep_rows": ep_rows.shape[0],
    "attn_share": shares.get("attn", 0.0), "scraped": monitor.scrape_once(),
    "kernels": analysis.summarize_timeline(timeline)["device_kernel_us"],
    "merge_problems": trace_merge.validate_merged(merged),
    "leaked": sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith(("jax.", "jaxlib"))
        or m == "dlrover_tpu" or m.startswith("dlrover_tpu.")
        or m.split(".")[0] in ("grpc", "psutil")
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
    assert result["migrated_tokens"] == 4
    assert "serving.migrate" in result["spans"]
    assert result["annotations"] > 0
    assert result["fleet_tokens"] == 3
    assert result["pp_logits"] == [2, 8, 256] and result["lite_loss"] > 0
    assert result["ring_chunks"] == 2 and result["ep_rows"] == 5
    assert result["attn_share"] > 0 and result["scraped"] == 1
    assert result["kernels"] == 5.0 and result["merge_problems"] == []
    assert result["autoscale"] == [["evict_straggler", "actuated"]]
    assert result["world"] == 2
    assert result["leaked"] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


_PORT_SOURCES = sorted(PORT.rglob("*.py"))
_TOOL_SOURCES = sorted((REPO / "tools").glob("torch_*.py"))
_SOURCES = _PORT_SOURCES + _TOOL_SOURCES + [REPO / "chip_smoke.py"]


def test_scan_covers_the_fleet_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"fault/__init__.py", "fault/registry.py",
            "observability/tracing.py",
            "observability/flight_recorder.py",
            "serving/kvpool/migrate.py", "serving/fleet/__init__.py",
            "serving/fleet/health.py", "serving/fleet/metrics.py",
            "serving/fleet/replica.py", "serving/fleet/replica_worker.py",
            "serving/fleet/router.py"} <= scanned


def test_scan_covers_the_axes_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"ops/ring_attention.py", "trainer/pipeline.py",
            "models/moe.py", "parallel/sharding.py"} <= scanned


# Loaded first by the worker's interpreter (through PYTHONPATH): at exit
# it writes which JAX or JAX-package modules that process imported.
_SITECUSTOMIZE = r"""
import atexit, json, os, sys

def _report():
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu"))
    with open(os.environ["ISOLATION_REPORT"], "w") as f:
        json.dump({"leaked": leaked, "port": "dlrover_tpu_torch"
                   in sys.modules}, f)

atexit.register(_report)
"""


def test_subprocess_replica_worker_loads_no_jax(tmp_path, monkeypatch):
    """A fleet's subprocess worker (the port's, on the CPU) serves a
    request and stops; its interpreter never loaded JAX or the JAX
    package."""
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.serving import fleet

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    report = tmp_path / "report.json"
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("ISOLATION_REPORT", str(report))
    replica = fleet.SubprocessReplica(
        "w0", str(tmp_path / "work"), paged=True, device="cpu",
        config="tiny")
    router = fleet.FleetRouter([replica], registry=MetricsRegistry())
    router.start(timeout_s=120.0)
    try:
        req = router.submit(list(range(5)), 3)
        router.run_until_idle(timeout_s=120.0)
    finally:
        router.stop()
    assert req.result.ok and len(req.result.tokens) == 3
    result = json.loads(report.read_text())
    assert result == {"leaked": [], "port": True}


def test_scan_covers_the_paged_engine_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
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


def test_scan_covers_the_elastic_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"common/constants.py", "common/serialize.py",
            "trainer/runtime.py", "flash_ckpt/raw_format.py",
            "flash_ckpt/storage.py", "flash_ckpt/shm_handler.py",
            "flash_ckpt/shared_obj.py", "flash_ckpt/autotune.py",
            "flash_ckpt/engine.py", "flash_ckpt/saver.py",
            "flash_ckpt/checkpointer.py", "trainer/elastic/sampler.py",
            "trainer/elastic/dataloader.py", "trainer/elastic/trainer.py",
            "examples/train_llama.py"} <= scanned


def test_elastic_worker_loads_no_jax_and_no_ml_dtypes(tmp_path):
    """The elastic worker trains, checkpoints to shm and disk, and a
    relaunch restores from memory; neither interpreter loaded JAX, the
    JAX package or ``ml_dtypes``."""
    import uuid

    site = tmp_path / "site"
    site.mkdir()
    # One report per interpreter: the worker also starts the shm
    # resource tracker's.
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE.replace(
        '("jax", "jaxlib", "dlrover_tpu")',
        '("jax", "jaxlib", "dlrover_tpu", "ml_dtypes")').replace(
        'os.environ["ISOLATION_REPORT"]',
        'os.environ["ISOLATION_REPORT"] + str(os.getpid())'))
    job = f"iso{uuid.uuid4().hex[:10]}"
    env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{REPO}",
               ISOLATION_REPORT=str(tmp_path / "report.json"),
               DLROVER_TPU_JOB_NAME=job,
               DLROVER_TPU_SHARED_DIR=str(tmp_path / "uds"))
    args = [sys.executable, "-m", "dlrover_tpu_torch.examples.train_llama",
            "--device", "cpu", "--global-batch", "4", "--micro-batch", "2",
            "--seq", "16", "--persist-every", "3",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    try:
        for steps, restored in ((4, 0), (5, 4)):
            proc = subprocess.run(args + ["--steps", str(steps)], env=env,
                                  cwd=REPO, capture_output=True, text=True,
                                  timeout=300)
            assert proc.returncode == 0, proc.stderr[-3000:]
            events = [json.loads(ln) for ln in proc.stdout.splitlines()]
            ready = next(e for e in events if e["event"] == "ready")
            assert ready["restored_step"] == restored
            assert events[-1]["event"] == "done"
            reports = [json.loads(p.read_text())
                       for p in tmp_path.glob("report.json*")]
            assert all(r["leaked"] == [] for r in reports), reports
            assert any(r["port"] for r in reports)
            for p in tmp_path.glob("report.json*"):
                p.unlink()
    finally:
        for seg in os.listdir("/dev/shm"):
            if job in seg:
                os.unlink(os.path.join("/dev/shm", seg))


def test_scan_covers_the_profiler_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"tpu_timer/__init__.py", "tpu_timer/bridge.py",
            "tpu_timer/py_tracing.py", "tpu_timer/xla_capture.py",
            "tpu_timer/native_stack.py", "tpu_timer/analysis.py",
            "tpu_timer/dump.py", "tpu_timer/launch.py",
            "tpu_timer/_inject/sitecustomize.py", "diagnosis/collectors.py",
            "common/metric.py", "observability/trace_merge.py"} <= scanned
    assert REPO / "tools" / "torch_merge_timeline.py" in _TOOL_SOURCES


def test_scan_covers_the_mesh_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharding.py", "agent/__init__.py",
            "agent/node_check_worker.py"} <= scanned


_MESH_CHILD = r"""
import json, os, sys, tempfile
import numpy as np
import torch
from dlrover_tpu_torch.agent import node_check_worker
from dlrover_tpu_torch.flash_ckpt import engine, storage
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.trainer import train_step as ts
mesh = build_mesh(MeshConfig(), "cpu")
cfg = llama.tiny_config(n_layers=2)
tc = ts.TrainConfig()
opt = ts.make_optimizer(tc)
params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
state = ts.init_train_state(cfg, opt, params, mesh=mesh)
state, m = ts.make_train_step(cfg, tc, opt, mesh=mesh)(
    state, {"tokens": np.zeros((2, 9), np.int32)})
d = tempfile.mkdtemp()
eng = engine.CheckpointEngine(d, standalone=True)
eng.save_to_storage(1, ts.state_tree(state))
eng._shm.unlink()
eng.close()
restored = engine.load_global_state(d, 1, storage.load_step_meta(d, 1),
                                    ts.state_tree(state))
os.environ["DLROVER_TPU_CHECK_DEVICE"] = "cpu"
rc = node_check_worker.main(["x", os.path.join(d, "probe"), "32", "8", "1"])
# Every kernel wrapper refuses a DTensor before it picks a route.
from torch.distributed.tensor import DTensor, Replicate
from dlrover_tpu_torch.ops import decode_attention as da
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import fused_ce as fc
from dlrover_tpu_torch.ops import moe_dispatch as md
x = DTensor.from_local(torch.ones(2, 4), mesh, [Replicate()] * 6,
                       run_check=False)
wrappers = [fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv,
            da.decode_attention, da.paged_decode_attention,
            fc.fused_ce_forward, fc.fused_ce_backward_dx,
            fc.fused_ce_backward_dw, md.grouped_ffn_forward,
            md.grouped_ffn_backward_dx, md.grouped_ffn_backward_dw_gu,
            md.grouped_ffn_backward_dw_down]
refused = 0
for fn in wrappers:
    n = fn.__code__.co_argcount
    try:
        fn(x, *[None] * (n - 1))
    except TypeError as e:
        refused += "DTensor" in str(e)
print(json.dumps({
    "loss": float(m["loss"]), "restored": restored is not None,
    "probe": rc == 0 and os.path.exists(os.path.join(d, "probe")),
    "refused": refused, "wrappers": len(wrappers),
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu")),
}))
"""


def test_mesh_path_loads_no_jax(tmp_path):
    """A world-of-one mesh step, its checkpoint and resharding restore,
    and the node check probe, in an interpreter that never loads JAX or
    the JAX package; and every kernel wrapper refuses a DTensor (a CPU
    one here) with ``TypeError`` before it picks the plain version."""
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DLROVER_TPU_JOB_NAME=f"isomesh{os.getpid()}",
               DLROVER_TPU_SHARED_DIR=str(tmp_path / "uds"))
    proc = subprocess.run([sys.executable, "-c", _MESH_CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loss"] > 0 and result["restored"] and result["probe"]
    assert result["refused"] == result["wrappers"] == 12
    assert result["leaked"] == []


def test_scan_covers_the_control_plane_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"run.py", "common/comm.py", "common/node.py",
            "common/env_utils.py", "rpc/transport.py",
            "training_event/emitter.py", "training_event/exporter.py",
            "training_event/predefined.py",
            "master/main.py", "master/args.py", "master/local_master.py",
            "master/servicer.py", "master/overload.py",
            "master/rpc_metrics.py",
            "master/elastic_training/rdzv_manager.py",
            "master/elastic_training/kv_store.py",
            "master/elastic_training/sync_service.py",
            "master/elastic_training/elastic_ps.py",
            "master/shard/task_manager.py",
            "master/shard/dataset_splitter.py",
            "master/monitor/perf_monitor.py",
            "master/node/job_context.py",
            "master/node/local_job_manager.py",
            "master/node/status_flow.py",
            "master/diagnosis/diagnosis_master.py",
            "diagnosis/actions.py", "diagnosis/diagnosis_data.py",
            "diagnosis/diagnostician.py", "diagnosis/diagnosis_manager.py",
            "diagnosis/precheck.py",
            "diagnosis/diagnosticians/training_hang.py",
            "diagnosis/diagnosticians/node_failure.py",
            "agent/master_client.py", "agent/rendezvous.py",
            "agent/monitor.py", "agent/training_monitor.py",
            "agent/paral_config_tuner.py", "agent/diagnosis_agent.py",
            "agent/training.py"} <= scanned


def test_standalone_launcher_path_loads_no_jax_grpc_or_psutil(tmp_path):
    """``python -m dlrover_tpu_torch.run --standalone`` on the CPU over
    HTTP: the launcher (the agent's process), the local master and the
    elastic worker it runs each leave a report; none loaded JAX, the JAX
    package, ``grpc`` or ``psutil``."""
    import uuid

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE.replace(
        '("jax", "jaxlib", "dlrover_tpu")',
        '("jax", "jaxlib", "dlrover_tpu", "grpc", "psutil")').replace(
        'os.environ["ISOLATION_REPORT"]',
        'os.environ["ISOLATION_REPORT"] + str(os.getpid())'))
    job = f"isorun{uuid.uuid4().hex[:10]}"
    env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{REPO}",
               ISOLATION_REPORT=str(tmp_path / "report.json"),
               DLROVER_TPU_JOB_NAME=job, OMP_NUM_THREADS="1",
               DLROVER_TPU_SHARED_DIR=str(tmp_path / "uds"),
               DLROVER_TPU_EVENT_DIR=str(tmp_path / "events"))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
             "--nproc_per_node", "1", "--monitor_interval", "0.2", "-m",
             "dlrover_tpu_torch.examples.train_llama", "--device", "cpu",
             "--layers", "1", "--steps", "2", "--global-batch", "2",
             "--micro-batch", "2", "--seq", "8", "--persist-every", "2",
             "--ckpt-dir", str(tmp_path / "ckpt")],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        events = [json.loads(ln) for ln in proc.stdout.splitlines()
                  if ln.startswith("{")]
        assert events[-1]["event"] == "done"
        assert "'transport': 'http'" in proc.stderr
        reports = [json.loads(p.read_text())
                   for p in tmp_path.glob("report.json*")]
        # The launcher, the master and the worker at least.
        assert sum(r["port"] for r in reports) >= 3, reports
        assert all(r["leaked"] == [] for r in reports), reports
    finally:
        for seg in os.listdir("/dev/shm"):
            if job in seg:
                os.unlink(os.path.join("/dev/shm", seg))


def test_scan_covers_the_rescale_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"master/elastic_training/rescale_coordinator.py",
            "trainer/elastic/rescale.py",
            "trainer/elastic/sharding_client.py",
            "testing/__init__.py", "testing/soak.py",
            "testing/soak_worker.py", "testing/rescale_worker.py",
            "testing/rescale_soak.py", "agent/standby.py",
            "agent/node_check.py"} <= scanned


def test_rescale_worker_and_standby_load_no_jax(tmp_path, monkeypatch):
    """A live-rescale worker (world one, on the CPU) runs its bootstrap
    plan, saves and trains to the end of its dataset under the port's
    in-process master; a warm standby imports torch without touching
    CUDA and, once adopted, runs a script. Neither interpreter loaded
    JAX or the JAX package."""
    from dlrover_tpu_torch.testing import rescale_soak as rs

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE.replace(
        'os.environ["ISOLATION_REPORT"]',
        'os.environ["ISOLATION_REPORT"] + str(os.getpid())'))
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("ISOLATION_REPORT", str(tmp_path / "report.json"))
    ep_dir = tmp_path / f"iso{os.getpid()}"
    (ep_dir / "ckpt").mkdir(parents=True)
    cfg = rs.RescaleSoakConfig(world=1, dataset_size=64, shard_size=16,
                               watchdog_s=120.0, device="cpu")
    runner = rs._build_master(cfg, str(ep_dir))
    try:
        rs._spawn_worker(runner, 0)
        assert runner.procs[0].wait(timeout=120) == 0
    finally:
        rs._cleanup(runner)
    events = rs._all_events(runner)
    assert [e["kind"] for e in events if e["kind"] in ("worker_start",
                                                       "done")] == [
        "worker_start", "done"]
    rs.check_rescale_invariants(events, cfg)

    script = tmp_path / "adopted.py"
    script.write_text("import sys\nprint('adopted', sys.argv[1:])\n")
    standby = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.agent.standby"],
        env=dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{REPO}"),
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ready = json.loads(standby.stderr.readline())
    assert ready["event"] == "standby_ready"
    assert ready["pid"] == standby.pid
    assert ready["cuda_initialized"] is False
    out, _ = standby.communicate(json.dumps({
        "env": {"ADOPTED": "1"}, "argv": [str(script), "x"],
        "module": None}) + "\n", timeout=60)
    assert standby.returncode == 0 and "adopted ['x']" in out
    reports = [json.loads(p.read_text())
               for p in tmp_path.glob("report.json*")]
    # The worker and the standby (and helpers such as multiprocessing's
    # resource tracker, which load no port).
    assert sum(r["port"] for r in reports) == 2, reports
    assert all(r["leaked"] == [] for r in reports), reports


def test_scan_covers_the_journal_and_soak_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"master/journal.py",
            "master/shard/streaming_dataset_manager.py",
            "testing/soak.py", "testing/soak_worker.py",
            "testing/soak_master.py", "testing/master_kill_soak.py",
            "testing/chaos.py"} <= scanned
    tools = {p.name for p in _TOOL_SOURCES}
    assert {"torch_journal_dump.py", "torch_chaos_soak.py",
            "torch_bench_master_recovery.py",
            "torch_phases.py"} <= tools


def test_master_kill_processes_load_no_jax_and_the_master_no_torch(
        tmp_path, monkeypatch):
    """The soak's master_kill episode on the CPU: the restarted master
    (the killed one leaves no report) and the worker never loaded JAX or
    the JAX package, and the master never loaded ``torch``."""
    from dlrover_tpu_torch.testing import soak

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE.replace(
        '"port": "dlrover_tpu_torch"\n                   in sys.modules}',
        '"port": "dlrover_tpu_torch"\n                   in sys.modules, '
        '"torch": "torch" in sys.modules, "argv": sys.argv}').replace(
        'os.environ["ISOLATION_REPORT"]',
        'os.environ["ISOLATION_REPORT"] + str(os.getpid())'))
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("ISOLATION_REPORT", str(tmp_path / "report.json"))
    cfg = soak.SoakConfig(dataset_size=256, serve=False, watchdog_s=90.0,
                          device="cpu")
    report = soak.run_soak(seed=0, episode=7, cfg=cfg,
                           work_dir=str(tmp_path / "work"))["reports"][0]
    assert report["master_epochs"] == [1, 2]
    reports = [json.loads(p.read_text())
               for p in tmp_path.glob("report.json*")]
    masters = [r for r in reports
               if "dlrover_tpu_torch.testing.soak_master" in r["argv"]
               or any(a.endswith("soak_master.py") for a in r["argv"])]
    workers = [r for r in reports
               if any(a.endswith("soak_worker.py") for a in r["argv"])]
    assert len(masters) == 1 and len(workers) == 1, reports
    assert masters[0]["torch"] is False
    assert all(r["leaked"] == [] for r in reports), reports


def test_scan_covers_the_replica_and_observability_modules():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"flash_ckpt/replica.py", "observability/hang_watchdog.py",
            "observability/flight_recorder.py",
            "testing/replica_worker.py"} <= scanned


_REPLICA_CHILD = r"""
import json, os, signal, sys
import torch
from dlrover_tpu_torch.trainer.runtime import init_distributed
init_distributed(device="cpu")
from dlrover_tpu_torch.flash_ckpt.engine import shm_segment_name
from dlrover_tpu_torch.flash_ckpt.replica import (
    CkptReplicaManager, snapshot_segment)
from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.observability import flight_recorder, hang_watchdog
name = shm_segment_name(0)
SharedMemoryHandler(name).save_state_dict(3, {"w": torch.ones(8)})
m0 = CkptReplicaManager(node_rank=0, group_size=2)
m1 = CkptReplicaManager(node_rank=1, group_size=2)
m0._addr_map = m1._addr_map = {0: f"127.0.0.1:{m0.port}",
                               1: f"127.0.0.1:{m1.port}"}
for m in (m0, m1):
    m.start()
    m.set_world([0, 1])
before = snapshot_segment(name)
pushed = m0.push_node_image(1)
SharedMemoryHandler(name).unlink()
pulled = m0.restore_missing_segments(1)
same = snapshot_segment(name) == before
SharedMemoryHandler(name).unlink()
m0.stop(); m1.stop()
wd = hang_watchdog.active_watchdog()
wd.beat(now=0.0)
fired = wd.check(now=10.0)
os.kill(os.getpid(), signal.SIGUSR1)
rec = flight_recorder.active_recorder()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu"))
print(json.dumps({"pushed": pushed, "pulled": pulled, "same": same,
                  "fired": fired, "on_demand": os.path.exists(
                      rec.on_demand_path()), "leaked": leaked}))
"""


def test_replica_and_watchdog_paths_load_no_jax(tmp_path):
    """The replica push and pull, the hang watchdog and the flight
    recorder's dumps, in a worker runtime on the CPU: nothing of JAX or
    the JAX package is loaded."""
    import uuid

    job = f"isorep{uuid.uuid4().hex[:10]}"
    env = dict(os.environ, PYTHONPATH=str(REPO), DLROVER_TPU_JOB_NAME=job,
               DLROVER_TPU_REPLICA_TOKEN="t", DLROVER_TPU_HANG_DEADLINE_S="1",
               DLROVER_TPU_FLIGHT_DIR=str(tmp_path / "flight"))
    proc = subprocess.run([sys.executable, "-c", _REPLICA_CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"pushed": 1, "pulled": 1, "same": True,
                      "fired": str(tmp_path / "flight" /
                                   "hang_node0_rank0.json"),
                      "on_demand": True, "leaked": []}


def test_scan_covers_the_checkpoint_bridges():
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert {"flash_ckpt/dcp_io.py", "trainer/hf_flash.py",
            "models/moe.py", "trainer/train_step.py"} <= scanned


_BRIDGE_CHILD = r"""
import json, os, sys, warnings
warnings.simplefilter("ignore")
import torch
from dlrover_tpu_torch.flash_ckpt import dcp_io
from dlrover_tpu_torch.flash_ckpt.checkpointer import Checkpointer
from dlrover_tpu_torch.trainer import hf_flash
root = sys.argv[1]
ckpt = Checkpointer(os.path.join(root, "flash"), standalone=True)
ckpt.save_checkpoint(3, {"w": torch.ones(2, 2, dtype=torch.bfloat16)},
                     "disk")
ckpt.close()
dcp_io.export_step(os.path.join(root, "flash"), os.path.join(root, "d"))
dcp_io.import_step(os.path.join(root, "d"), os.path.join(root, "back"))
step, state = dcp_io.load_dcp(os.path.join(root, "d"), device="cpu")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "dlrover_tpu", "orbax", "ml_dtypes"))
print(json.dumps({"step": step, "leaked": leaked,
                  "callback": hf_flash.FlashCkptCallback.__mro__[1].__name__}))
"""


def test_checkpoint_bridges_load_no_jax_orbax_or_ml_dtypes(tmp_path):
    """The DCP bridge's export, import and load and the HF callback's
    module, in a process of their own: nothing of JAX, orbax, ml_dtypes
    or the JAX package is loaded."""
    import uuid

    job = f"isobr{uuid.uuid4().hex[:10]}"
    env = dict(os.environ, PYTHONPATH=str(REPO), DLROVER_TPU_JOB_NAME=job,
               DLROVER_TPU_SHARED_DIR=str(tmp_path / "uds"))
    try:
        proc = subprocess.run([sys.executable, "-c", _BRIDGE_CHILD,
                               str(tmp_path)], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
    finally:
        for seg in os.listdir("/dev/shm"):
            if job in seg:
                os.unlink(os.path.join("/dev/shm", seg))
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"step": 3, "leaked": [],
                      "callback": "TrainerCallback"}


_CLUSTER_MODULES = {
    "master/scheduler/__init__.py", "master/scheduler/k8s_client.py",
    "master/scaler/pod_scaler.py", "master/scaler/elasticjob_scaler.py",
    "master/watcher/k8s_watcher.py", "operator/__init__.py",
    "operator/reconciler.py", "operator/__main__.py",
    "brain/__init__.py", "brain/evaluators.py", "brain/service.py",
    "brain/client.py", "observability/prom.py", "master/dashboard.py",
    "common/global_context.py"}


def _kubernetes_imports(path: Path):
    """(enclosing class, enclosing function) of each import of
    ``kubernetes`` in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []

    def walk(node, cls, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name, fn)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, cls, child.name)
            else:
                names = []
                if isinstance(child, ast.Import):
                    names = [a.name for a in child.names]
                elif isinstance(child, ast.ImportFrom) and child.level == 0:
                    names = [child.module or ""]
                if any(n.split(".")[0] == "kubernetes" for n in names):
                    found.append((cls, fn))
                walk(child, cls, fn)

    walk(tree, None, None)
    return found


def test_scan_covers_the_cluster_modules():
    """The cluster side and the brain are scanned like every port
    module (no JAX, no JAX package), and the ``kubernetes`` client is
    imported in one place only: ``RealK8sApi``'s constructor, so every
    module imports without it."""
    scanned = {str(p.relative_to(PORT)) for p in _PORT_SOURCES}
    assert _CLUSTER_MODULES <= scanned
    where = {str(p.relative_to(REPO)): _kubernetes_imports(p)
             for p in _SOURCES}
    assert {k: v for k, v in where.items() if v} == {
        "dlrover_tpu_torch/master/scheduler/k8s_client.py": [
            ("RealK8sApi", "__init__")]}
