"""The port's device capture (``tpu_timer/xla_capture.py``) over
``torch.profiler``, against the JAX package's.

- ``record_events``: both packages get the same event list, and their
  native rings agree;
- ``bucket_by_scope``: equal shares on equal rows;
- scope attribution on a tiny CPU train step: every matrix product,
  forward and backward (and recomputed under each remat policy), lands
  under the scopes the reference's lowered train step uses; without
  remat, each scope holds three products a forward one (the forward and
  its two gradients, attributed through the autograd node's sequence
  number);
- the same attribution on a kineto trace of a flagship step recorded on
  an H100 (``tests/data/kineto_flagship_step.json.gz``, 2 layers, grad
  accumulation 2): every B1/B2 launch lands in ``attn``;
- the listener: the trigger file, no window before the process's first
  optimizer step, a stalled capture tripping the native watchdog,
  idempotence, host-only windows without a CUDA context, and
  the ``_inject`` sitecustomize on and off, chain-loading the one it
  shadows, without importing torch at interpreter start."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import collections
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.tpu_timer import xla_capture as ref_xc
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.tpu_timer import get_timer
from dlrover_tpu_torch.tpu_timer import xla_capture as xc
from dlrover_tpu_torch.trainer import train_step as ts

REPO = Path(__file__).resolve().parents[1]
TRACE = REPO / "tests" / "data" / "kineto_flagship_step.json.gz"
BUCKETS = {"attn": ("attn",), "mlp": ("mlp",), "vocab": ("vocab", "lm_head"),
           "optimizer": ("optimizer",)}
MATMULS = ("aten::mm", "aten::bmm", "aten::addmm")


def _bucket(row):
    shares = xc.bucket_by_scope([dict(row, dur_us=1.0)], BUCKETS)
    return max(shares, key=shares.get)


_RING = r"""
import json, os, sys, tempfile
from dlrover_tpu.tpu_timer import xla_capture as ref_xc
from dlrover_tpu.tpu_timer.bridge import get_timer as ref_timer
from dlrover_tpu_torch.tpu_timer import xla_capture as xc
from dlrover_tpu_torch.tpu_timer.bridge import get_timer
events = json.loads(sys.argv[1])
out = {}
for label, mod, t in (("ref", ref_xc, ref_timer()), ("port", xc, get_timer())):
    anchor = t.now_ns()
    n = mod.record_events([tuple(e) for e in events], anchor,
                          max_events=int(sys.argv[2]))
    fd, path = tempfile.mkstemp()
    os.close(fd)
    t.dump_timeline(path)
    with open(path) as f:
        trace = json.load(f)
    os.unlink(path)
    out[label] = {"n": n, "anchor": anchor,
                  "events": trace["traceEvents"],
                  "gauge": "tpu_timer_gauge{name=\"xla_capture_events\"} "
                           f"{float(n):.6f}" in t.metrics_text()}
print(json.dumps(out))
"""


def _random_events(seed, n):
    rs = np.random.RandomState(seed)
    names = ["jit_step(123)", "fusion.7", "all-reduce.3", "copy_start",
             "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
             "cudaLaunchKernel", "dot_general"]
    return [[names[rs.randint(len(names))], bool(rs.rand() < 0.6),
             float(rs.randint(0, 10_000)), float(rs.choice([0.5, 3.0, 40.0,
                                                            1200.25]))]
            for _ in range(n)]


@pytest.mark.parametrize("n, cap", [(60, 4096), (60, 20)])
def test_record_events_rings_agree_with_the_reference(n, cap):
    """The same event list (device and host, below the 1 us floor,
    collectives) through both packages' ``record_events``: the same
    count recorded, the same gauge, and the same ring contents (names,
    kinds, times off the anchor). A capped capture keeps device events
    first in the port (the reference keeps list order)."""
    events = _random_events(n, n)
    proc = subprocess.run(
        [sys.executable, "-c", _RING, json.dumps(events), str(cap)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    ref, port = got["ref"], got["port"]
    assert ref["n"] == port["n"] == min(
        cap, sum(e[3] >= 1.0 for e in events))
    assert ref["gauge"] and port["gauge"]

    def ring(side):
        return sorted(
            (e["name"], e["args"]["kind"],
             round(e["ts"] - side["anchor"] / 1e3, 3), e["dur"])
            for e in side["events"])

    if cap >= len(events):
        assert ring(port) == ring(ref)
    else:
        kept = [e for e in sorted(events, key=lambda e: (not e[1], e[2]))
                if e[3] >= 1.0][:cap]
        assert sorted(r[0] for r in ring(port)) == sorted(
            ("xla/" if e[1] else "xla_host/") + xc.base_name(e[0])
            for e in kept)


def test_base_name_strips_kernel_signatures():
    assert xc.base_name("void (anonymous namespace)::flash_fwd_kernel<128>("
                        "CUtensorMap_st, (anonymous namespace)::Params)") == \
        "flash_fwd_kernel"
    assert xc.base_name("void at::native::vectorized_elementwise_kernel<4, "
                        "at::native::FillFunctor<float>>(int, T)") == \
        "at::native::vectorized_elementwise_kernel"
    assert xc.base_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    for name in ("jit_matmul(1234)", "fusion.3", "all-gather-start"):
        assert xc.base_name(name) == ref_xc._base_name(name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_by_scope_matches_the_reference(seed):
    rs = np.random.RandomState(seed)
    scopes = ["jit(step)/attn/dot_general", "mlp", "attn/mlp", "",
              "optimizer/Optimizer.step#AdamW.step", "lm_head", "x"]
    ops = [{"name": f"op{i}", "scope": scopes[rs.randint(len(scopes))],
            "dur_us": float(rs.rand() * 100)} for i in range(50)]
    ops.append({"name": "vocab_kernel", "scope": "", "dur_us": 3.0})
    got = xc.bucket_by_scope(ops, BUCKETS)
    assert got == ref_xc.bucket_by_scope(ops, BUCKETS)
    assert abs(sum(got.values()) - 1.0) < 1e-12
    assert xc.bucket_by_scope([], BUCKETS) == {} == \
        ref_xc.bucket_by_scope([], BUCKETS)


@pytest.fixture(scope="module")
def reference_scopes():
    """The named scopes of the reference's lowered train step (tiny
    config), all and those over a ``dot_general``."""
    from dlrover_tpu.models import llama as jax_llama
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.trainer import train_step as jax_ts

    jcfg = jax_llama.tiny_config(n_layers=2)
    jtc = jax_ts.TrainConfig(warmup_steps=2, grad_accum=1)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jopt = jax_ts.make_optimizer(jtc)
    jstate, _ = jax_ts.init_train_state(jcfg, jopt, mesh,
                                        jax.random.key(0))
    jstep, _ = jax_ts.make_train_step(jcfg, jtc, jopt, mesh)
    with mesh:
        text = jstep.jitted.lower(jstate, {"tokens": jnp.zeros(
            (4, 17), jnp.int32)}).as_text(debug_info=True)
    names = set(re.findall(r'loc\("([^"]*)"', text))
    every, dots = set(), set()
    for name in names:
        hit = [b for b in BUCKETS if any(k in name for k in BUCKETS[b])]
        every.update(hit[:1])
        if name.endswith("dot_general"):
            dots.update(hit[:1] or ["other"])
    return every, dots


def _tiny_step(remat_policy):
    kw = ({"remat": False} if remat_policy is None
          else {"remat": True, "remat_policy": remat_policy})
    cfg = llama.tiny_config(n_layers=2, **kw)
    tc = ts.TrainConfig(warmup_steps=2, grad_accum=1)
    opt = ts.make_optimizer(tc)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    state = ts.init_train_state(cfg, opt, params)
    step = ts.make_train_step(cfg, tc, opt, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    state, _ = step(state, {"tokens": toks})
    return cfg, state, step, toks


def _matmuls(rows):
    counts = collections.Counter()
    for r in rows:
        if r["name"] in MATMULS:
            counts[_bucket(r)] += 1
    return dict(counts)


@pytest.mark.parametrize("remat_policy",
                         [None, "mlp_only", "attn_save", "dots", "full"])
def test_cpu_step_ops_land_under_the_reference_scopes(remat_policy,
                                                      reference_scopes):
    every, dots = reference_scopes
    cfg, state, step, toks = _tiny_step(remat_policy)
    rows = xc.capture_op_profile(fn=lambda: step(state, {"tokens": toks}))
    fwd = xc.capture_op_profile(fn=lambda: llama.loss_fn(
        cfg, state["params"], {"tokens": toks}))
    assert rows and all(r["category"] == "cpu_op" for r in rows)
    shares = xc.bucket_by_scope(rows, BUCKETS)
    assert {b for b, v in shares.items() if v > 0} - {"other"} == every
    assert abs(sum(shares.values()) - 1.0) < 1e-9
    step_mm, fwd_mm = _matmuls(rows), _matmuls(fwd)
    # Every product, forward, backward and recomputed, in the scope the
    # reference's dot_generals carry.
    assert set(step_mm) == set(fwd_mm) == dots == {"attn", "mlp", "vocab"}
    for b in dots:
        if remat_policy is None:
            assert step_mm[b] == 3 * fwd_mm[b], (b, step_mm, fwd_mm)
        else:
            # Recomputed products (and the selective policies' nested
            # dispatch) come on top of the backward's.
            assert step_mm[b] > 2 * fwd_mm[b], (b, step_mm, fwd_mm)
    assert shares["optimizer"] > 0


def test_flagship_kineto_trace_attributes_every_flash_launch_to_attn():
    """A kineto trace of one flagship step (2 layers, grad accumulation
    2, ``mlp_only``) on an H100: each of B1/B2's 4 launches lands in
    ``attn`` (B2's through the backward's sequence numbers), every cuBLAS
    GEMM in a model scope, and the shares sum to 1."""
    rows = xc.parse_op_profile(str(TRACE))
    assert rows and all(r["category"] in xc.DEVICE_CATS for r in rows)
    flash = collections.Counter()
    for r in rows:
        kernel = xc.base_name(r["name"])
        if kernel.startswith("flash_"):
            assert _bucket(r) == "attn", r
            flash[kernel] += 1
    assert flash == {"flash_fwd_kernel": 4, "flash_dq_kernel": 4,
                     "flash_dkv_kernel": 4}
    gemms = [r for r in rows if r["name"].startswith("nvjet")]
    assert gemms and all(_bucket(r) in ("attn", "mlp", "vocab")
                         for r in gemms)
    shares = xc.bucket_by_scope(rows, BUCKETS)
    assert abs(sum(shares.values()) - 1.0) < 1e-9
    assert all(shares[b] > 0 for b in BUCKETS)


def test_parse_chrome_trace_keeps_device_and_runtime_events():
    events = xc.parse_chrome_trace(str(TRACE))
    device = [e for e in events if e[1]]
    host = [e for e in events if not e[1]]
    assert len(device) == 1300
    assert host and all(n.startswith(("cuda", "cu")) for n, *_ in host)
    import gzip

    base = json.load(gzip.open(TRACE))["baseTimeNanoseconds"] / 1e3
    shifted = xc.parse_chrome_trace(str(TRACE), since_epoch_us=base)
    assert [e[2] for e in shifted] == [e[2] for e in events]


def _churn(stop):
    x = torch.ones(64, 64)
    while not stop.is_set():
        x = torch.tanh(x @ x / 100.0)


def _optimizer_step():
    p = torch.nn.Parameter(torch.ones(4))
    p.grad = torch.ones(4)
    torch.optim.AdamW([p], lr=0.1).step()


def test_trigger_file_drives_a_host_only_capture(tmp_path, monkeypatch):
    """In a process that has stepped, the trigger file starts a capture
    at once; without a CUDA context the window records the host only
    and says so."""
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"xlacap{os.getpid()}")
    monkeypatch.setattr(xc, "_stepped", threading.Event())
    xc._arm_step_hook()
    _optimizer_step()
    listener = xc.XlaCaptureListener(local_rank=0, interval_s=3600.0,
                                     capture_s=0.2)
    stop = threading.Event()
    t = threading.Thread(target=_churn, args=(stop,), daemon=True)
    t.start()
    listener.start()
    try:
        xc.request_xla_capture(0)
        deadline = time.time() + 60
        while time.time() < deadline and listener.captures == 0:
            time.sleep(0.1)
        assert listener.captures >= 1
        assert not os.path.exists(xc.trigger_path(0))
        assert not xc.cuda_context()
        assert {"opened", "started", "closed"} <= set(xc.last_window)
    finally:
        stop.set()
        listener.stop()
        t.join(timeout=10)
    text = get_timer().metrics_text()
    assert 'tpu_timer_span_count{name="xla_capture_window"}' in text


def test_listener_waits_for_the_first_step(monkeypatch):
    """Before its process's first optimizer step (a waiting standby) the
    listener opens no window, automatic or triggered, and leaves the
    trigger to the worker; after it, it takes both."""
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"xlawait{os.getpid()}")
    monkeypatch.setattr(xc, "_stepped", threading.Event())
    listener = xc.XlaCaptureListener(local_rank=0, interval_s=0.2,
                                     capture_s=0.05)
    listener.start()
    try:
        xc.request_xla_capture(0)
        time.sleep(2.0)
        assert listener.captures == 0 and os.path.exists(xc.trigger_path(0))
        _optimizer_step()
        deadline = time.time() + 60
        while time.time() < deadline and listener.captures < 2:
            time.sleep(0.1)
        assert listener.captures >= 2
        assert not os.path.exists(xc.trigger_path(0))
    finally:
        listener.stop()
        if os.path.exists(xc.trigger_path(0)):
            os.unlink(xc.trigger_path(0))


def test_stalled_capture_trips_the_native_watchdog(monkeypatch):
    timer = get_timer()
    timer._lib.tt_init(50)  # 50ms hang timeout
    try:
        listener = xc.XlaCaptureListener(local_rank=0, capture_s=0.01)

        def stuck(*a, **k):
            time.sleep(0.3)  # well past the watchdog timeout
            return []

        monkeypatch.setattr(xc, "capture_device_events", stuck)
        done = threading.Event()

        def run():
            listener.capture_once()
            done.set()

        threading.Thread(target=run, daemon=True).start()
        deadline = time.time() + 5
        tripped = False
        while time.time() < deadline:
            if timer.hang_count() >= 1:
                tripped = True
                break
            time.sleep(0.02)
        assert tripped, "watchdog did not flag the stalled capture"
        assert done.wait(5) and listener.captures == 1
    finally:
        timer._lib.tt_init(600_000)


def test_listener_is_idempotent_and_off_by_default(monkeypatch):
    monkeypatch.setattr(xc, "_started_listener", None)
    monkeypatch.delenv("DLROVER_TPU_TIMER_XLA", raising=False)
    assert xc.maybe_start_listener(0) is None
    monkeypatch.setenv("DLROVER_TPU_TIMER_XLA", "1")
    monkeypatch.setenv("DLROVER_TPU_TIMER_XLA_INTERVAL", "3600")
    first = xc.maybe_start_listener(0)
    try:
        assert first is not None and xc.maybe_start_listener(1) is first
    finally:
        first.stop()


def test_one_session_at_a_time():
    """A window waits for the one in flight instead of failing."""
    box = {}

    def side():
        box["rows"] = xc.capture_op_profile(fn=lambda: time.sleep(0.3))

    t = threading.Thread(target=side)
    t.start()
    time.sleep(0.05)
    rows = xc.capture_op_profile(
        fn=lambda: torch.ones(8, 8) @ torch.ones(8, 8))
    t.join(timeout=60)
    assert "rows" in box and any(r["name"] == "aten::mm" for r in rows)


_INJECTED = r"""
import json, sys, time
early = "torch" in sys.modules
import dlrover_tpu_torch.tpu_timer.xla_capture as xc
chained = sys.modules.get("_dlrover_tpu_torch_chained_sitecustomize")
print(json.dumps({
    "torch_at_start": early,
    "listener": xc._started_listener is not None,
    "chained": getattr(chained, "MARK", None),
}))
"""


@pytest.mark.parametrize("on", [True, False])
def test_injection_arms_the_listener_and_chain_loads(tmp_path, on):
    """``launch.build_env`` puts ``_inject`` first: a script that never
    imports the port gets the listener at interpreter start, torch is
    not imported by it, and a shadowed sitecustomize still runs; with
    the switch off, no listener."""
    from dlrover_tpu_torch.tpu_timer import launch

    shadowed = tmp_path / "site"
    shadowed.mkdir()
    (shadowed / "sitecustomize.py").write_text("MARK = 'chained'\n")
    env = launch.build_env(3600.0, 0.1, env=dict(
        os.environ, PYTHONPATH=str(shadowed)))
    if not on:
        env["DLROVER_TPU_TIMER_XLA"] = "0"
    env["DLROVER_TPU_JOB_NAME"] = f"inject{os.getpid()}{on}"
    proc = subprocess.run([sys.executable, "-c", _INJECTED], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"torch_at_start": False, "listener": on,
                   "chained": "chained"}
