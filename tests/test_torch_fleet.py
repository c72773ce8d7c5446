"""The port's serving fleet (counterpart of ``tests/test_fleet.py`` and
``tests/test_fleet_migration.py``) on the CPU.

- **Router.** One scripted scenario drives the JAX package's
  ``FleetRouter`` and the port's over the same fake replicas and fake
  clock: every scenario must give equal ``FleetResult``s and equal
  values in every fleet metric family.
- **Fault schedule.** One schedule file, armed from the environment,
  fires at the same hits in both packages and leaves the same trace.
- **Thread fleet** of tiny paged port engines: two-phase dispatch and
  live drain, token-exact against an unmigrated engine with no retry.
  The live drain steps the router itself and slows the drained replica
  through a ``delay`` fault rule, so its request is still decoding when
  the drain starts (no sleep decides the outcome).
- **Engine hooks**: the ``serving.step.error`` fault point takes the
  step-error path; spec decoding's draft/verify sub-spans.
- **Subprocess fleet** of port workers on the CPU
  (``SubprocessReplica(..., device="cpu")``): a replica killed
  mid-decode, every request completed exactly once.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import jax

from dlrover_tpu.fault import registry as jax_fault
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.observability.registry import (
    MetricsRegistry as JaxRegistry,
)
from dlrover_tpu.serving import fleet as jax_fleet
from dlrover_tpu_torch.fault import registry as port_fault
from dlrover_tpu_torch.models import convert, llama
from dlrover_tpu_torch.observability.registry import MetricsRegistry
from dlrover_tpu_torch.serving import fleet as port_fleet
from dlrover_tpu_torch.serving.kvpool import PagedServingEngine

pytestmark = pytest.mark.fleet

PACKAGES = {
    "jax": (jax_fleet, JaxRegistry),
    "port": (port_fleet, MetricsRegistry),
}


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeReplica:
    """Mailbox double with the migration control surface: ``send``
    records ops and (with ``auto_migrate``) answers export/import at
    once, so a live drain completes inside ``drain_replica``'s pump."""

    mode = "fake"

    def __init__(self, replica_id, clock, dead_error, role="mixed",
                 auto_migrate=False):
        self.replica_id = str(replica_id)
        self.role = role
        self._clock = clock
        self._dead = dead_error
        self.inbox, self.outbox, self.ops = [], [], []
        self.generation = 0
        self.is_alive = True
        self.beating = True
        self.auto_migrate = auto_migrate

    def start(self):
        self.is_alive = True

    def wait_ready(self, timeout=0.0):
        return True

    def alive(self):
        return self.is_alive

    def kill(self):
        self.is_alive = False
        self.beating = False

    def stop(self):
        self.is_alive = False

    def restart(self):
        self.generation += 1
        self.inbox = []
        self.is_alive = self.beating = True

    def submit(self, item):
        if not self.is_alive:
            raise self._dead(f"fake {self.replica_id} dead")
        self.inbox.append(item)

    def send(self, payload):
        if not self.is_alive:
            raise self._dead(f"fake {self.replica_id} dead")
        self.ops.append(payload)
        if not self.auto_migrate:
            return
        key = dict(request_id=payload["request_id"],
                   attempt=payload["attempt"], generation=self.generation)
        if payload["op"] == "export":
            self.outbox.append(dict(kind="exported", payload="QUJD", **key))
        elif payload["op"] == "import":
            self.outbox.append(dict(kind="imported", ok=True, **key))

    def poll(self):
        out, self.outbox = self.outbox, []
        return out

    def last_heartbeat(self):
        return self._clock() if self.beating else 0.0

    # -- script helpers ------------------------------------------------------

    def take(self):
        assert self.inbox, f"replica {self.replica_id} has no work"
        return self.inbox.pop(0)

    def _event(self, kind, item, **fields):
        self.outbox.append(dict(kind=kind, request_id=item.request_id,
                                attempt=item.attempt,
                                generation=self.generation, **fields))

    def export(self, item):
        self._event("exported", item, payload="QUJD")

    def export_failed(self, item):
        self._event("exported", item, error="MigrationError")

    def imported(self, item, ok=True):
        fields = {} if ok else {"reason": "MigrationRefused"}
        self._event("imported", item, ok=ok, **fields)

    def complete(self, item, tokens=(1, 2), ttft_s=0.001):
        self._event("done", item, ok=True, tokens=list(tokens),
                    truncated=False, failure_reason="", ttft_s=ttft_s)

    def fail(self, item, reason):
        self._event("done", item, ok=False, tokens=[], truncated=False,
                    failure_reason=reason, ttft_s=None)


def _router(mod, registry_cls, roles=("prefill", "decode"),
            auto_migrate=False, **cfg_kw):
    clock = FakeClock()
    cfg_kw.setdefault("retry_backoff_s", 0.1)
    cfg_kw.setdefault("retry_jitter_frac", 0.0)
    cfg_kw.setdefault("auto_restart", False)
    cfg_kw.setdefault("health", mod.HealthPolicy(
        heartbeat_timeout_s=5.0, probe_cooldown_s=1.0, probe_successes=1))
    reps = [FakeReplica(i, clock, mod.ReplicaDeadError, role=role,
                        auto_migrate=auto_migrate)
            for i, role in enumerate(roles)]
    router = mod.FleetRouter(reps, mod.RouterConfig(**cfg_kw), clock=clock,
                             registry=registry_cls())
    router.start()
    return router, reps, clock


# ---- scripted scenarios (each returns the requests it submitted) -----------


def _two_phase(mod, reg):
    router, (pre, dec), clock = _router(mod, reg)
    req = router.submit(list(range(20)), 8)
    router.step()
    item = pre.take()
    assert item.migrate_after_prefill
    pre.export(item)
    router.step()
    assert dec.ops[-1]["op"] == "import"
    dec.imported(item)
    clock.advance(0.01)
    router.step()
    assert pre.ops[-1]["op"] == "release"
    dec.complete(item, tokens=(7,) * 8)
    clock.advance(0.02)
    router.step()
    return router, [req]


def _import_refused(mod, reg):
    router, (pre, dec), clock = _router(mod, reg)
    req = router.submit(list(range(20)), 8)
    router.step()
    item = pre.take()
    pre.export(item)
    router.step()
    dec.imported(item, ok=False)
    router.step()
    pre.complete(item, tokens=(5,) * 8)
    clock.advance(0.03)
    router.step()
    return router, [req]


def _no_destination(mod, reg):
    router, (pre, dec), clock = _router(mod, reg)
    req = router.submit(list(range(20)), 8)
    router.step()
    item = pre.take()
    dec.kill()
    pre.export(item)
    router.step()
    pre.complete(item)
    router.step()
    return router, [req]


def _export_failure(mod, reg):
    router, (pre, dec), clock = _router(mod, reg)
    req = router.submit(list(range(20)), 8)
    router.step()
    item = pre.take()
    pre.export_failed(item)
    router.step()
    pre.complete(item)
    router.step()
    return router, [req]


def _ack_timeout(mod, reg):
    router, (pre, dec), clock = _router(mod, reg, migration_timeout_s=5.0)
    req = router.submit(list(range(20)), 8)
    router.step()
    item = pre.take()
    pre.export(item)
    router.step()
    dec.kill()
    clock.advance(6.0)
    router.step()
    pre.complete(item, tokens=(3,) * 8)
    router.step()
    return router, [req]


def _destination_death(mod, reg):
    router, (pre, dec), clock = _router(mod, reg)
    req = router.submit(list(range(20)), 8)
    router.step()
    item = pre.take()
    pre.export(item)
    router.step()
    dec.imported(item)
    router.step()
    dec.kill()
    router.step()
    item2 = pre.take()
    pre.complete(item2, tokens=(4,) * 8)
    clock.advance(0.5)
    router.step()
    return router, [req]


def _crash_reclaim(mod, reg):
    router, reps, clock = _router(mod, reg, roles=("mixed",) * 3)
    reqs = [router.submit(list(range(i, i + 20)), 4) for i in range(3)]
    router.step()
    victim = next(r for r in reps if r.inbox)
    victim.kill()
    clock.advance(0.1)
    router.step()
    for rep in reps:
        while rep.inbox:
            rep.complete(rep.take())
    clock.advance(0.1)
    router.step()
    return router, reqs


def _hedge(mod, reg):
    router, (a, b), clock = _router(
        mod, reg, roles=("mixed", "mixed"), hedge_enabled=True,
        hedge_after_s=0.5, hedge_max_new_tokens=8)
    req = router.submit([1, 2], 4)
    router.step()
    first = next(r for r in (a, b) if r.inbox)
    other = b if first is a else a
    clock.advance(0.6)
    router.step()                       # the hedge twin dispatches
    item1, item2 = first.take(), other.take()
    other.complete(item2, tokens=(9, 9, 9, 9))
    router.step()
    first.complete(item1, tokens=(8, 8, 8, 8))   # a counted duplicate
    router.step()
    return router, [req]


def _deadline_shed(mod, reg):
    router, (a, b), clock = _router(mod, reg, roles=("mixed", "mixed"))
    a.kill()
    b.kill()
    router.step()
    req = router.submit([1, 2], 4, deadline_s=1.0)
    router.step()
    clock.advance(1.5)
    router.step()
    a.restart()
    req2 = router.submit([3, 4], 4, deadline_s=0.5)
    router.step()
    item = a.take()
    a.fail(item, reason="deadline")
    clock.advance(0.6)
    router.step()
    return router, [req, req2]


def _live_drain(mod, reg):
    router, reps, clock = _router(mod, reg, roles=("mixed", "mixed"),
                                  auto_migrate=True)
    req = router.submit(list(range(20)), 8)
    router.step()
    src = next(r for r in reps if r.inbox)
    dst = next(r for r in reps if r is not src)
    item = src.take()
    assert router.drain_replica(src.replica_id)
    assert router.replica_ids() == [dst.replica_id]
    dst.complete(item, tokens=(2,) * 8)
    router.step()
    return router, [req]


SCENARIOS = {
    "two_phase": _two_phase,
    "import_refused": _import_refused,
    "no_destination": _no_destination,
    "export_failure": _export_failure,
    "ack_timeout": _ack_timeout,
    "destination_death": _destination_death,
    "crash_reclaim": _crash_reclaim,
    "hedge": _hedge,
    "deadline_shed": _deadline_shed,
    "live_drain": _live_drain,
}


def _metric_values(metrics):
    """Every family of a FleetMetrics handle: its children (counters,
    gauges) or its cumulative bucket state (histograms)."""
    out = {}
    for name, fam in vars(metrics).items():
        out[name] = (dict(fam._children),
                     {k: list(v) for k, v in getattr(fam, "_hist",
                                                     {}).items()})
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_matches_the_jax_router(scenario):
    got = {}
    for pkg, (mod, reg) in PACKAGES.items():
        router, reqs = SCENARIOS[scenario](mod, reg)
        assert all(r.done for r in reqs), (pkg, scenario)
        got[pkg] = ([dataclasses.asdict(r.result) for r in reqs],
                    _metric_values(router.metrics))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    # The scenario ran the path it names.
    m = got["port"][1]
    counter = {name: vals.get((), 0.0) for name, (vals, _) in m.items()}
    if scenario in ("two_phase", "destination_death", "live_drain"):
        assert counter["migrations"] == 1
    if scenario == "hedge":
        assert counter["hedges"] == 1 and counter["duplicates"] == 1
    if scenario == "crash_reclaim":
        assert counter["reroutes"] == 1


# ---- fault schedule ---------------------------------------------------------


def test_one_schedule_file_arms_both_packages_alike(tmp_path, monkeypatch):
    assert (port_fault.SCHEDULE_ENV, port_fault.TRACE_ENV) == (
        jax_fault.SCHEDULE_ENV, jax_fault.TRACE_ENV)
    sched = port_fault.FaultSchedule([
        port_fault.FaultRule("fleet.replica.step", nth=3, once=False,
                             every=2, match={"replica": "r1"}),
        port_fault.FaultRule("serving.*", action="delay", nth=2,
                             delay_s=0.0),
        port_fault.FaultRule("fleet.replica.import", action="truncate",
                             nth=1, truncate_bytes=7),
    ], seed=5, label="both")
    path = tmp_path / "schedule.json"
    path.write_text(sched.to_json())
    hits = ([("fleet.replica.step", {"replica": r}) for r in
             ("r0", "r1") * 6]
            + [("serving.step.error", {"step_idx": i}) for i in range(4)]
            + [("fleet.replica.import", {"replica": "r1"})] * 2)
    traces, fired = {}, {}
    for pkg, mod in (("jax", jax_fault), ("port", port_fault)):
        trace_file = tmp_path / f"trace_{pkg}.jsonl"
        monkeypatch.setenv(mod.SCHEDULE_ENV, str(path))
        monkeypatch.setenv(mod.TRACE_ENV, str(trace_file))
        armed = mod.arm_from_env()
        try:
            out = []
            for name, ctx in hits:
                try:
                    out.append(mod.fault_point(name, **ctx))
                except mod.FaultInjected as e:
                    out.append(("raised", e.point, e.rule_id))
        finally:
            mod.disarm()
        fired[pkg] = out
        traces[pkg] = [json.loads(ln) for ln in
                       trace_file.read_text().splitlines()]
        assert traces[pkg] == armed.trace
    assert fired["port"] == fired["jax"]
    assert traces["port"] == traces["jax"]
    # r1's hits 3 and 5 of its 6.
    assert [e["hit"] for e in traces["port"]
            if e["point"] == "fleet.replica.step"] == [3, 5]


def test_step_error_fault_point_takes_the_recovery_path():
    """An armed ``serving.step.error`` raise lands in the engine's
    step-error path: the pool is rebuilt, the request restarts from
    scratch and still gives the tokens of an undisturbed run; the
    flight recorder holds the markers and the spans tile the request."""
    from dlrover_tpu_torch.observability import flight_recorder, tracing

    cfg = llama.tiny_config()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompt = np.arange(3, 14, dtype=np.int32)

    def serve():
        eng = PagedServingEngine(cfg, params, slots=2, max_len=32,
                                 prefill_chunk=4, block_size=8,
                                 registry=MetricsRegistry(), device="cpu")
        req = eng.submit(prompt, 6)
        eng.run_until_idle()
        return eng, req

    _, want = serve()
    rec = flight_recorder.install_recorder()
    tracer = tracing.arm(tracing.Tracer(service="test"))
    port_fault.arm(port_fault.FaultSchedule([port_fault.FaultRule(
        "serving.step.error", nth=3)]))
    try:
        eng, req = serve()
    finally:
        port_fault.disarm()
        tracing.disarm()
        flight_recorder.reset_recorder()
    assert req.tokens == want.tokens and req.requeues == 1
    assert eng.metrics.step_errors.value() == 1
    events = [r["event"] for r in rec.records()]
    assert "serving_step_error" in events and "serving_finish" in events
    spans = tracer.finished()
    root = next(s for s in spans if s["name"] == "serving.request")
    kids = [s for s in spans if s["parent_id"] == root["span_id"]]
    assert {s["name"] for s in kids} == {
        "serving.queue_wait", "serving.prefill", "serving.decode"}
    assert abs(sum(s["dur_s"] for s in kids) - root["dur_s"]) <= 1e-6


def test_spec_request_spans_split_decode_into_draft_and_verify():
    """Under speculative decoding the decode span carries draft and
    verify sub-spans (the request's ``draft_s`` / ``verify_s``), laid
    inside it."""
    from dlrover_tpu_torch.observability import tracing
    from dlrover_tpu_torch.serving import ServingEngine

    cfg = llama.tiny_config()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    eng = ServingEngine(cfg, params, slots=2, max_len=32, prefill_chunk=8,
                        spec_k=2, registry=MetricsRegistry(), device="cpu")
    tracer = tracing.arm(tracing.Tracer(service="test"))
    try:
        req = eng.submit(np.tile(np.arange(4, dtype=np.int32), 3), 8)
        eng.run_until_idle()
    finally:
        tracing.disarm()
    spans = {s["name"]: s for s in tracer.finished()}
    dec = spans["serving.decode"]
    for name, dur in (("serving.decode.draft", req.draft_s),
                      ("serving.decode.verify", req.verify_s)):
        sub = spans[name]
        assert sub["parent_id"] == dec["span_id"]
        assert sub["dur_s"] == pytest.approx(dur, abs=1e-9)
        assert dec["mono"] <= sub["mono"]
        assert sub["mono"] + sub["dur_s"] <= dec["mono"] + dec["dur_s"]
    assert req.verify_s > 0


# ---- thread fleet of tiny paged port engines --------------------------------


# Heartbeat windows wide enough that a loaded CPU host never reads a
# slow replica as a dead one (only a real death may move work).
_PATIENT = port_fleet.HealthPolicy(heartbeat_timeout_s=30.0)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_llama.tiny_config()
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.device_get(jparams), "cpu")
    return llama.tiny_config(), params


def _paged_factory(tiny, engines=None, name=None):
    cfg, params = tiny

    def factory():
        eng = PagedServingEngine(
            cfg, params, slots=4, max_len=64, prefill_chunk=4,
            block_size=8, registry=MetricsRegistry(), device="cpu")
        eng.warmup()
        if engines is not None:
            engines[name] = eng
        return eng

    return factory


def _reference_tokens(tiny, prompts, max_new):
    eng = _paged_factory(tiny)()
    out = []
    for p in prompts:
        req = eng.submit(np.asarray(p, np.int32), max_new)
        eng.run_until_idle()
        out.append(list(req.tokens))
    return out


def _prompts(cfg, seeds, n=9):
    return [np.random.RandomState(s).randint(0, cfg.vocab_size, n).tolist()
            for s in seeds]


def test_thread_fleet_two_phase_token_exact(tiny):
    cfg, _ = tiny
    prompts = _prompts(cfg, (1, 2, 3))
    expected = _reference_tokens(tiny, prompts, 24)
    router = port_fleet.FleetRouter(
        [port_fleet.ThreadReplica("p0", _paged_factory(tiny),
                                  role="prefill"),
         port_fleet.ThreadReplica("d0", _paged_factory(tiny),
                                  role="decode")],
        port_fleet.RouterConfig(health=_PATIENT),
        registry=MetricsRegistry())
    router.start()
    try:
        reqs = [router.submit(p, 24) for p in prompts]
        router.run_until_idle(timeout_s=120.0)
        for req, want in zip(reqs, expected):
            assert req.result.ok, req.result
            assert req.result.tokens == want
            assert req.result.retries == 0
            assert req.result.replica_id == "d0"
        assert router.metrics.migrations.value() == len(prompts)
    finally:
        router.stop()


def test_thread_fleet_live_drain_token_exact(tiny):
    cfg, _ = tiny
    prompts = _prompts(cfg, (7, 8))
    expected = _reference_tokens(tiny, prompts, 40)
    engines = {}
    router = port_fleet.FleetRouter(
        [port_fleet.ThreadReplica(n, _paged_factory(tiny, engines, n))
         for n in ("m0", "m1")],
        port_fleet.RouterConfig(health=_PATIENT),
        registry=MetricsRegistry())
    # m0's serve loop runs slowly from its first iteration on: its
    # request is mid-decode for well over a second.
    port_fault.arm(port_fault.FaultSchedule([port_fault.FaultRule(
        "fleet.replica.step", action="delay", delay_s=0.05, once=False,
        every=1, match={"replica": "m0"})]))
    try:
        router.start()
        reqs = [router.submit(p, 40) for p in prompts]
        # Step the router until m0's request has sampled its first
        # token (it is decoding).
        until = time.monotonic() + 60.0
        while time.monotonic() < until:
            router.step()
            time.sleep(0.001)  # yield the interpreter to the replicas
            eng = engines.get("m0")
            if eng is not None and any(r is not None and r.tokens
                                       for r in eng.scheduler.by_slot):
                break
        else:
            pytest.fail("m0 never started decoding")
        assert router.drain_replica("m0")
        port_fault.disarm()
        router.run_until_idle(timeout_s=120.0)
        for req, want in zip(reqs, expected):
            assert req.result.ok, req.result
            assert req.result.tokens == want
            assert req.result.retries == 0, "drain must migrate"
            assert req.result.replica_id == "m1"
        assert router.metrics.migrations.value() == 1
        assert router.replica_ids() == ["m1"]
    finally:
        port_fault.disarm()
        router.stop()


# ---- subprocess fleet of port workers on the CPU ----------------------------


def test_subprocess_fleet_kill_mid_decode_completes_once(tmp_path):
    """Two paged port workers on the CPU; one is SIGKILLed with
    requests in its slots. The router re-routes them: every request
    completes exactly once, on the survivor, with the tokens of an
    unkilled engine over the workers' weights (``init_params`` from a
    generator seeded 0)."""
    cfg = llama.tiny_config()
    prompts = _prompts(cfg, (11, 12, 13, 14))
    params = llama.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                               device="cpu")
    expected = _reference_tokens((cfg, params), prompts, 24)

    # Every engine iteration of both workers sleeps 20 ms, so the kill
    # lands mid-decode.
    slow = tmp_path / "slow.json"
    slow.write_text(port_fault.FaultSchedule([port_fault.FaultRule(
        "fleet.replica.step", action="delay", delay_s=0.02, every=1,
    )]).to_json())

    def replica(name):
        return port_fleet.SubprocessReplica(
            name, str(tmp_path), slots=2, max_len=64, prefill_chunk=4,
            paged=True, block_size=8, heartbeat_s=0.1,
            schedule_path=str(slow), device="cpu", config="tiny")

    reps = [replica("s0"), replica("s1")]
    router = port_fleet.FleetRouter(
        reps, port_fleet.RouterConfig(auto_restart=False, health=_PATIENT),
        registry=MetricsRegistry())
    router.start(timeout_s=120.0)
    try:
        assert all(r.wait_ready(0.0) for r in reps)
        reqs = [router.submit(p, 24) for p in prompts]
        got = router.step()
        assert router._ledger["s0"] and router._ledger["s1"]
        # ~10 of s0's 20 ms iterations: past its prefill (3 chunks),
        # well short of 24 tokens.
        until = time.monotonic() + 0.2
        while time.monotonic() < until:
            got += router.step()
        assert router._ledger["s0"], "s0 finished before the kill"
        reps[0].kill()
        got += router.run_until_idle(timeout_s=120.0)
        assert sorted(r.request_id for r in got) == sorted(
            r.request_id for r in reqs)
        for req, want in zip(reqs, expected):
            assert req.result.ok and req.result.replica_id == "s1"
            assert req.result.tokens == want
        assert router.metrics.reroutes.value() >= 1
        assert router.metrics.duplicates.value() == 0
        assert reps[1].kv_violation is None and reps[1].last_kv
    finally:
        router.stop()
    assert not any(r.alive() for r in reps)
    assert (tmp_path / "replicas0_gen0.log").exists()
