"""The port's dashboard (``master/dashboard.py``), its Prometheus text
(``observability/prom.py``) and ``common/global_context.py`` against the
reference's, on the CPU.

- prom: the same registry, perf monitor and job context give
  byte-identical ``/metrics`` text, which the port's own parser reads
  back;
- the dashboard: both packages' servers over the same inputs (a
  ``DistributedJobManager`` driven through one scripted simulated
  cluster, a perf monitor, rendezvous and task managers, a metric
  context, a trace aggregator, a control-plane provider, autoscaler
  stand-ins) answer every panel with equal JSON, wall-clock ages and
  timestamps aside; a panel whose provider raises answers 503 alone;
- the private attributes the dashboard reads with a default
  (``_rdzv_round``, ``_latest_world``, the task manager's ``_lock`` and
  ``_datasets``, ``role_managers``, ``status_history``) exist in the
  port and carry the values the panels show;
- ``DistributedJobMaster.from_args`` with ``--dashboard_port 0`` and
  ``--brain_addr`` serves the dashboard and reports to a port brain;
- ``global_context``'s defaults and env overrides.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import http.client
import importlib
import json
import random
import re
import threading
import time
import types

import pytest

from dlrover_tpu_torch.diagnosis.collectors import parse_prometheus_text

PKGS = ("dlrover_tpu", "dlrover_tpu_torch")
T0 = 1_700_000_000.0
JOB = "dash-job"


def pkg(base, module):
    return importlib.import_module(f"{base}.{module}")


def _fill_registry(reg, seed):
    """Seeded counters, gauges and histograms, awkward label values
    included (quotes, backslashes, newlines)."""
    rng = random.Random(seed)
    c = reg.counter("zz_requests_total", "requests by outcome",
                    labelnames=("outcome",))
    for outcome in ("ok", 'bad"quote', "back\\slash", "new\nline"):
        c.inc(rng.randint(1, 50), outcome=outcome)
    g = reg.gauge("aa_depth", "")
    g.set(rng.uniform(0, 10))
    g2 = reg.gauge("mm_gauge_by_rank", "per rank", labelnames=("rank",))
    for r in range(3):
        g2.set(rng.uniform(-5, 5), rank=str(r))
    h = reg.histogram("hh_latency_seconds", "latency",
                      labelnames=("verb",), buckets=(0.001, 0.01, 0.1, 1.0))
    for verb in ("get", "report"):
        for _ in range(rng.randint(3, 30)):
            h.observe(rng.expovariate(20.0), verb=verb)
    reg.histogram("hh_empty_seconds", "never observed")
    tokens = reg.counter("serving_tokens_total", "tokens",
                         labelnames=("kind",))
    tokens.inc(123, kind="prefill")
    tokens.inc(456, kind="decode")
    wasted = reg.counter("serving_tokens_wasted_total", "wasted",
                         labelnames=("kind",))
    wasted.inc(7, kind="decode")


def _perf(base, seed):
    rng = random.Random(seed)
    perf = pkg(base, "master.monitor.perf_monitor").PerfMonitor()
    perf._init_time = perf._start_time = T0  # noqa: SLF001 - fixed origin
    t = T0
    for step in range(1, 12):
        t += rng.uniform(0.5, 1.5)
        perf.collect_global_step(step, t, node_id=step % 2,
                                 step_time_s=rng.uniform(0.4, 0.8))
    for node in (0, 1):
        start = T0
        for phase in ("rendezvous", "train", "ckpt", "train", "restart",
                      "train"):
            end = start + rng.uniform(1.0, 5.0)
            perf.collect_phase(node, phase, start, end)
            start = end
    return perf


def _context(base, seed):
    rng = random.Random(seed)
    ctx = pkg(base, "common.metric").JobMetricContext()
    for node in (0, 1, 2):
        ctx.record(node, {"tpu_duty_cycle": rng.uniform(0, 100),
                          "hbm_used_mb": rng.uniform(0, 1e5)},
                   ts=T0 + node)
    ctx.record_unreachable(2)
    return ctx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_text_is_byte_identical(seed):
    texts = {}
    for base in PKGS:
        prom = pkg(base, "observability.prom")
        reg = pkg(base, "observability.registry").MetricsRegistry()
        _fill_registry(reg, seed)
        texts[base] = prom.master_metrics_text(
            perf_monitor=_perf(base, seed), metric_context=_context(base, seed),
            registry=reg)
        assert prom.render_registry(
            pkg(base, "observability.registry").MetricsRegistry()) == ""
        assert prom.render_job_context(None) == ""
    assert texts["dlrover_tpu_torch"] == texts["dlrover_tpu"]
    parsed = parse_prometheus_text(texts["dlrover_tpu_torch"])
    assert parsed["dlrover_global_step"] == 11
    assert parsed["serving_tokens_total/kind=decode"] == 456
    assert "hh_latency_seconds_p99/verb=get" in parsed
    assert "dlrover_job_metric_mean/hbm_used_mb" in parsed
    assert 0 < parsed["dlrover_goodput"] <= 1


# ---- the dashboard over the same inputs ----------------------------------------


def _held_watcher(sim, cluster):
    """The package's sim watcher whose stream the test drains itself:
    every event is processed in order on the test's thread."""

    class Held(sim.SimNodeWatcher):
        def __init__(self):
            super().__init__(JOB, cluster)
            self._held = threading.Event()

        def watch(self):
            self._held.wait()
            return iter(())

        def stop(self):
            self._held.set()

    return Held()


def _drain(mgr, cluster):
    import queue

    events = cluster.events()
    while True:
        try:
            event = events.get_nowait()
        except queue.Empty:
            return
        if event is not None:
            mgr._process_event(event)  # noqa: SLF001


class _Autoscaler:
    """``api_state`` echoes its paging arguments."""

    def api_state(self, last, offset, compact):
        return {"enabled": True, "last": last, "offset": offset,
                "compact": compact}


def _build(base, seed, autoscaler=None):
    """Every input of one package's dashboard, driven the same way."""
    pkg(base, "master.node.job_context").JobContext.reset_singleton()
    sim = pkg(base, "testing.sim_cluster")
    node_mod = pkg(base, "common.node")
    cluster = sim.SimCluster()
    mgr = pkg(base, "master.node.dist_job_manager").DistributedJobManager(
        job_name=JOB,
        node_groups={"worker": node_mod.NodeGroupResource(
            count=3, node_resource=node_mod.NodeResource(
                cpu=4, memory_mb=1024, tpu_chips=8))},
        scaler=sim.SimScaler(JOB, cluster),
        watcher=_held_watcher(sim, cluster),
        max_relaunch_count=2,
    )
    mgr.start()
    _drain(mgr, cluster)
    cluster.fail_node(0, "Killed")
    _drain(mgr, cluster)
    cluster.preempt_node(1)
    _drain(mgr, cluster)
    for node in mgr.worker_manager.nodes.values():
        node.heartbeat_time = time.time() if node.id == 2 else 0
    perf = _perf(base, seed)
    rdzv = pkg(base, "master.elastic_training.rdzv_manager") \
        .create_rdzv_managers()
    training = rdzv["training"]
    training.update_rdzv_params(min_nodes=2, max_nodes=2)
    for rank in (0, 1):
        training.join_rendezvous(rank, rank, 1)
    training.get_comm_world(0)
    training.join_rendezvous(2, 2, 1)
    comm = pkg(base, "common.comm")
    tasks = pkg(base, "master.shard.task_manager").TaskManager(
        perf_monitor=perf)
    tasks.new_dataset(comm.DatasetShardParams(
        dataset_name="ds", dataset_size=100, shard_size=10))
    for node in (0, 1, 1):
        tasks.get_task(node, "ds")
    agg = pkg(base, "observability.tracing").TraceAggregator()
    agg.ingest([
        {"trace_id": "t1", "span_id": "a", "parent_id": "", "name": "rpc",
         "service": "master", "status": "ok", "dur_s": 0.5, "ts": T0},
        {"trace_id": "t1", "span_id": "b", "parent_id": "a",
         "name": "handler", "service": "master", "status": "ok",
         "dur_s": 0.2, "ts": T0},
        {"trace_id": "t2", "span_id": "c", "name": "step",
         "service": "worker", "status": "error", "dur_s": 1.5, "ts": T0},
    ])
    dash = pkg(base, "master.dashboard").DashboardServer(
        mgr, perf, 0, rdzv_managers=rdzv, task_manager=tasks,
        metric_context=_context(base, seed), trace_aggregator=agg,
        autoscaler=autoscaler,
        control_plane=lambda: {"rpc": {"verbs": {"get": {"count": 3}}}},
    )
    return types.SimpleNamespace(dash=dash, mgr=mgr, cluster=cluster,
                                 rdzv=training, tasks=tasks)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), \
            resp.read().decode()
    finally:
        conn.close()


PANELS = ("/", "/index.html", "/api/job", "/api/perf", "/api/nodes",
          "/api/rdzv", "/api/datasets", "/api/phases", "/api/stragglers",
          "/api/goodput", "/api/control_plane", "/api/autoscaler",
          "/api/autoscaler?last=3&offset=1&signals=compact",
          "/api/traces", "/api/traces/t1", "/api/node/worker-0",
          "/api/node/worker-2", "/api/node/worker-99", "/node/worker-0",
          "/metrics", "/nope")

# The /metrics families both servers are given alike: the registry's
# (``_fill_registry``), the perf monitor's and the job context's. The
# families the components register themselves are left out: some keep
# their handles process-wide from their first use (a registry earlier
# tests in the process set), and some time waits on the wall clock;
# ``test_metrics_text_is_byte_identical`` renders whole registries.
_SAME_INPUTS = re.compile(
    r"^(?:# (?:TYPE|HELP) )?(?:(?:aa|mm|zz|hh)_\w*|serving_\w*"
    r"|dlrover_(?:global_step|running_speed_steps_per_s|goodput"
    r"|goodput_phase_seconds|job_node_metric|job_metric_mean))[ {]")


def _same_inputs_lines(text):
    return [line for line in text.splitlines() if _SAME_INPUTS.match(line)]


# Wall-clock fields: ages and the times the nodes' records were made.
_CLOCK_KEYS = {"heartbeat_age_s", "ts", "create_time", "start_time",
               "finish_time"}


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: ("<clock>" if k in _CLOCK_KEYS and v is not None
                    else _scrub(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _answers(base, seed, monkeypatch, autoscaler=None):
    reg = pkg(base, "observability.registry").MetricsRegistry()
    _fill_registry(reg, seed)
    monkeypatch.setattr(pkg(base, "observability.registry"),
                        "default_registry", lambda: reg)
    monkeypatch.setattr(pkg(base, "observability.prom"),
                        "default_registry", lambda: reg)
    built = _build(base, seed, autoscaler)
    built.dash.start()
    try:
        out = {}
        for path in PANELS:
            status, ctype, body = _get(built.dash.port, path)
            if ctype == "application/json":
                body = _scrub(json.loads(body))
            elif path == "/metrics":
                body = _same_inputs_lines(body)
            out[path] = (status, ctype, body)
        return out, built
    finally:
        built.dash.stop()
        built.mgr.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_every_panel_matches_the_reference(seed, monkeypatch):
    answers = {base: _answers(base, seed, monkeypatch)[0] for base in PKGS}
    assert answers["dlrover_tpu_torch"] == answers["dlrover_tpu"]
    port = answers["dlrover_tpu_torch"]
    assert [port[p][0] for p in PANELS] == [
        200] * 17 + [404, 200, 200, 404]
    nodes = port["/api/nodes"][2]
    assert [(n["id"], n["rank"], n["status"], n["relaunch_count"])
            for n in nodes] == [
        (0, 0, "Deleted", 0), (3, 0, "Running", 1), (1, 1, "Deleted", 0),
        (4, 1, "Running", 1), (2, 2, "Running", 0)]
    assert port["/api/rdzv"][2][0]["round"] >= 1
    assert port["/api/datasets"][2] == [{
        "name": "ds", "todo": 7, "doing": 3, "completed": 0,
        "records_done": 0}]
    assert port["/api/goodput"][2]["serving"]["tokens_total"] == 579
    assert port["/api/autoscaler"][2] == {"enabled": False}
    assert port["/api/traces"][2]["stats"]["spans"] == 3
    detail = port["/api/node/worker-2"][2]
    assert detail["resource"]["tpu_chips"] == 8 and len(detail["timeline"])
    metrics = parse_prometheus_text("\n".join(port["/metrics"][2]))
    assert metrics["dlrover_goodput"] == pytest.approx(
        port["/api/perf"][2]["goodput"], rel=1e-9)
    assert metrics["serving_tokens_total/kind=prefill"] == 123


@pytest.mark.parametrize("autoscaler", ["paged", "raising"])
def test_autoscaler_panel_matches_the_reference(autoscaler, monkeypatch):
    class Raising:
        def api_state(self, **kw):
            raise RuntimeError("ledger gone")

    stand_in = _Autoscaler() if autoscaler == "paged" else Raising()
    answers = {}
    for base in PKGS:
        out, _ = _answers(base, 0, monkeypatch, autoscaler=stand_in)
        answers[base] = [out[p] for p in PANELS if "autoscaler" in p]
    assert answers["dlrover_tpu_torch"] == answers["dlrover_tpu"]
    first, paged = (body for _, _, body in answers["dlrover_tpu_torch"])
    if autoscaler == "paged":
        assert first == {"enabled": True, "last": 50, "offset": 0,
                         "compact": False}
        assert paged == {"enabled": True, "last": 3, "offset": 1,
                         "compact": True}
    else:
        assert first == {"enabled": True,
                         "error": "RuntimeError: ledger gone"}


# Each panel and the server method that feeds it.
_PROVIDERS = {
    "/api/job": "_job_detail", "/api/perf": "_perf",
    "/api/nodes": "_nodes", "/api/rdzv": "_rdzv",
    "/api/datasets": "_datasets", "/api/phases": "_phases",
    "/api/stragglers": "_stragglers", "/api/goodput": "_goodput",
    "/api/control_plane": "_control_plane_state",
    "/metrics": "_metrics_text", "/api/autoscaler": "_autoscaler_state",
    "/api/traces": "_traces", "/api/node/worker-2": "_node_detail",
}


@pytest.mark.parametrize("panel", sorted(_PROVIDERS))
def test_a_raising_panel_answers_503_alone(panel):
    answers = {}
    for base in PKGS:
        built = _build(base, 0)

        def boom(*args, **kwargs):
            raise KeyError("subsystem down")

        setattr(built.dash, _PROVIDERS[panel], boom)
        built.dash.start()
        try:
            answers[base] = {p: _get(built.dash.port, p)[0]
                             for p in _PROVIDERS}
            answers[base]["body"] = json.loads(
                _get(built.dash.port, panel)[2])
        finally:
            built.dash.stop()
            built.mgr.stop()
    assert answers["dlrover_tpu_torch"] == answers["dlrover_tpu"]
    port = answers["dlrover_tpu_torch"]
    assert port.pop("body") == {"error": "KeyError: 'subsystem down'",
                                "unavailable": True}
    assert port == {p: 503 if p == panel else 200 for p in _PROVIDERS}


def test_dashboard_reads_the_private_attributes_it_names():
    """The attributes the dashboard reads through ``getattr`` with a
    default exist under those names in the port, and what the panels
    show comes from them (a rename would read 0 or nothing)."""
    built = _build("dlrover_tpu_torch", 0)
    try:
        rdzv, tasks, mgr = built.rdzv, built.tasks, built.mgr
        assert rdzv._rdzv_round == 1  # noqa: SLF001
        assert rdzv._latest_world == {0: 1, 1: 1}  # noqa: SLF001
        assert isinstance(tasks._lock, type(threading.Lock()))  # noqa: SLF001
        assert set(tasks._datasets) == {"ds"}  # noqa: SLF001
        assert set(mgr.role_managers) == {"worker"}
        node = mgr.worker_manager.nodes[3]
        assert [s for _, s in node.status_history] == [
            "Initial", "Pending", "Running"]
        row = [r for r in built.dash._rdzv() if r["world_size"]][0]
        assert (row["round"], row["world_size"], row["waiting"]) == (1, 2, 1)
        assert built.dash._datasets()[0]["doing"] == 3
        assert len(built.dash._nodes()) == 5
        assert len(built.dash._node_detail("worker-3")["timeline"]) == 3
    finally:
        built.mgr.stop()


def test_sim_master_serves_the_dashboard_and_reports_to_the_brain(tmp_path):
    """``DistributedJobMaster.from_args(parse_master_args(["--platform",
    "sim", "--dashboard_port", "0", "--brain_addr", <a port brain>]))``:
    ``prepare()`` serves every panel; the collector's sample and, at
    ``stop()``, the completion record land in the brain; ``/optimize``
    then plans from them."""
    from dlrover_tpu_torch.brain.service import BrainService
    from dlrover_tpu_torch.master.args import parse_master_args
    from dlrover_tpu_torch.master.dist_master import DistributedJobMaster
    from dlrover_tpu_torch.master.node.job_context import JobContext

    brain = BrainService(port=0, data_dir=str(tmp_path / "brain"),
                         store="sqlite")
    brain.start()
    JobContext.reset_singleton()
    master = DistributedJobMaster.from_args(parse_master_args([
        "--platform", "sim", "--node_num", "2", "--dashboard_port", "0",
        "--brain_addr", f"127.0.0.1:{brain.port}", "--job_name", "e2e"]))
    try:
        master.prepare()
        port = master.dashboard.port
        assert port > 0
        assert _get(port, "/")[0] == 200
        assert json.loads(_get(port, "/api/job")[2])["job_name"] == "e2e"
        nodes = json.loads(_get(port, "/api/nodes")[2])
        assert sorted(n["rank"] for n in nodes) == [0, 1]
        plane = json.loads(_get(port, "/api/control_plane")[2])
        assert plane["enabled"] is True and "rpc" in plane
        assert json.loads(_get(port, "/api/autoscaler")[2]) == {
            "enabled": False}
        text = _get(port, "/metrics")[2]
        assert "dlrover_goodput" in parse_prometheus_text(text)
        master.perf_monitor.collect_global_step(1, 100.0)
        master.perf_monitor.collect_global_step(3, 101.0)
        sample = master.metric_collector.collect_once()
        assert sample.speed == 2.0
    finally:
        master.stop()
    try:
        assert master.dashboard._server is not None  # noqa: SLF001
        runtime = brain.store.load("runtime", job_name="e2e")
        assert [(r["global_step"], r["speed"]) for r in runtime] == [
            (3, 2.0)]
        (done,) = brain.store.load("completion", job_name="e2e")
        assert done["success"] is False and done["failure_count"] == 0
        conn = http.client.HTTPConnection("127.0.0.1", brain.port,
                                          timeout=10)
        conn.request("POST", "/optimize", json.dumps({"job_name": "e2e"}))
        body = json.loads(conn.getresponse().read())
        conn.close()
        assert body["plan"]["worker_count"] == runtime[0]["worker_count"]
        assert [a["evaluator"] for a in body["assessments"]] == ["oom_risk"]
    finally:
        brain.stop()


# ---- global_context -----------------------------------------------------------


@pytest.mark.parametrize("env", [
    {}, {"DLROVER_TPU_HANG_DOWNTIME": "60"},
    {"DLROVER_TPU_NETWORK_CHECK": "true"},
    {"DLROVER_TPU_NETWORK_CHECK": "1", "DLROVER_TPU_HANG_DOWNTIME": "5"},
    {"DLROVER_TPU_NETWORK_CHECK": "no"},
])
def test_global_context_defaults_and_env_match(env, monkeypatch):
    monkeypatch.delenv("DLROVER_TPU_HANG_DOWNTIME", raising=False)
    monkeypatch.delenv("DLROVER_TPU_NETWORK_CHECK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    contexts = {}
    for base in PKGS:
        mod = pkg(base, "common.global_context")
        monkeypatch.setattr(mod.Context, "_instance", None)
        ctx = mod.get_context()
        assert mod.get_context() is ctx
        contexts[base] = vars(mod.Context().from_env())
    assert contexts["dlrover_tpu_torch"] == contexts["dlrover_tpu"]
    port = contexts["dlrover_tpu_torch"]
    assert port["hang_downtime_secs"] == int(
        env.get("DLROVER_TPU_HANG_DOWNTIME", 1800))
    assert port["network_check_enabled"] is (
        env.get("DLROVER_TPU_NETWORK_CHECK") in ("1", "true"))


# ---- the reference's dashboard scenarios, on the port ---------------------------
# (``tests/test_whatif.py:690``, ``tests/test_control_plane.py:356-455``)


def _http_json(port, path):
    status, _, body = _get(port, path)
    assert status == 200, body
    return json.loads(body)


def _servicer(**kwargs):
    from dlrover_tpu_torch.master.servicer import MasterServicer

    return MasterServicer(rdzv_managers={}, **kwargs)


def test_dashboard_serves_api_goodput_and_paginated_autoscaler():
    from dlrover_tpu_torch.autoscaler import (
        EVICT_STRAGGLER,
        AutoScaler,
        PolicyConfig,
        RulePolicy,
        SignalBus,
    )
    from dlrover_tpu_torch.common.constants import GoodputPhase
    from dlrover_tpu_torch.master.dashboard import DashboardServer
    from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor

    perf = PerfMonitor()
    t0 = perf._init_time  # noqa: SLF001
    perf.collect_phase(0, GoodputPhase.TRAIN, t0, t0 + 8.0)
    perf.collect_phase(0, GoodputPhase.CKPT, t0 + 8.0, t0 + 10.0)

    class Clock:
        t = 1000.0

        def __call__(self):
            return self.t

    clock = Clock()
    bus = SignalBus(clock=clock)
    bus.add_source("perf", lambda: {
        "straggler_ranks": [1], "straggler_scores": {1: 4.0},
        "median_step_s": 0.01,
    })
    scaler = AutoScaler(
        bus,
        policy=RulePolicy(PolicyConfig(
            straggler_confirm_ticks=1, evict_cooldown_s=0.0,
        )),
        actuators={EVICT_STRAGGLER: lambda d: None},
        clock=clock,
        attribution_window_s=1.0,
    )
    for _ in range(4):
        scaler.tick()
        clock.t += 1.0
    assert scaler.ledger.decisions_total == 4
    dash = DashboardServer(None, perf, 0, autoscaler=scaler)
    dash.start()
    try:
        goodput = _http_json(dash.port, "/api/goodput")
        att = goodput["training"]
        assert att["causes"]["ckpt"]["seconds"] == pytest.approx(2.0)
        assert att["attributed_frac"] == pytest.approx(1.0)
        assert goodput["goodput_basis"]["nodes_reporting"] == 1
        assert "serving" in goodput
        perf_view = _http_json(dash.port, "/api/perf")
        assert perf_view["goodput_basis"]["averaging"] == (
            "per_node_train_fraction_mean"
        )
        # Pagination: last/offset page backward; compact drops the
        # triggering snapshots but keeps their key count.
        page = _http_json(dash.port, "/api/autoscaler?last=2&offset=1")
        assert [d["seq"] for d in page["decisions"]] == [2, 3]
        assert page["ledger_window"]["returned"] == 2
        compact = _http_json(dash.port, "/api/autoscaler?last=1&signals=compact")
        d = compact["decisions"][0]
        assert d["signals_truncated"] is True
        assert d["signals"] == {}
        assert d["signal_keys"] >= 3
        full = _http_json(dash.port, "/api/autoscaler")
        assert full["decisions"][-1]["signals"]
        assert full["outcomes"]["attached"] >= 1
    finally:
        dash.stop()


def test_api_traces_summary_exposes_drop_totals():
    from dlrover_tpu_torch.master.dashboard import DashboardServer
    from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
    from dlrover_tpu_torch.observability import tracing

    agg = tracing.TraceAggregator(max_traces=2)
    for i in range(5):
        agg.ingest([{"trace_id": f"t{i}", "span_id": "s0", "name": "op",
                     "mono": 0.0}])
    dash = DashboardServer(None, PerfMonitor(), port=0,
                           trace_aggregator=agg)
    dash.start()
    try:
        data = _http_json(dash.port, "/api/traces")
    finally:
        dash.stop()
    assert data["stats"]["dropped"]["trace_cap"] == 3
    assert data["stats"]["occupancy"] == 2


def test_dashboard_503_per_panel_not_whole_page():
    """A raising provider answers its endpoint with a 503 and a JSON
    error body; every other panel keeps serving."""
    from dlrover_tpu_torch.master.dashboard import DashboardServer
    from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor

    class WedgedPerf(PerfMonitor):
        def straggler_report(self, *a, **k):
            raise RuntimeError("perf subsystem wedged")

    servicer = _servicer(perf_monitor=PerfMonitor())
    dash = DashboardServer(
        None, WedgedPerf(), port=0, rdzv_managers={},
        control_plane=servicer.control_plane_state,
    )
    dash.start()
    try:
        status, _, body = _get(dash.port, "/api/stragglers")
        assert status == 503
        err = json.loads(body)
        assert err["unavailable"] is True
        assert "perf subsystem wedged" in err["error"]
        assert _http_json(dash.port, "/api/rdzv") == []
        cp = _http_json(dash.port, "/api/control_plane")
        assert cp["enabled"] is True
        assert cp["overload"]["level"] == 0
        assert "rpc" in cp and "buffers" in cp
    finally:
        dash.stop()


def test_control_plane_endpoint_reports_buffers():
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.master.dashboard import DashboardServer
    from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
    from dlrover_tpu_torch.master.shard.task_manager import TaskManager
    from dlrover_tpu_torch.observability import tracing

    perf = PerfMonitor()
    tm = TaskManager(perf_monitor=perf)
    agg = tracing.TraceAggregator()
    servicer = _servicer(task_manager=tm, perf_monitor=perf,
                         trace_aggregator=agg)
    servicer.report(comm.Message(node_id=0, data=comm.DatasetShardParams(
        dataset_name="d", dataset_size=64, shard_size=16,
        task_type="training", storage_type="text", num_epochs=1,
        shuffle=False).serialize()))
    servicer.get(comm.Message(node_id=0, data=comm.MultiTaskRequest(
        dataset_name="d", node_id=0, count=1).serialize()))
    dash = DashboardServer(None, perf, port=0,
                           control_plane=servicer.control_plane_state)
    dash.start()
    try:
        cp = _http_json(dash.port, "/api/control_plane")
    finally:
        dash.stop()
    for name, stats in cp["buffers"].items():
        assert "occupancy" in stats and "drops" in stats, name
    assert "MultiTaskRequest" in cp["rpc"]["verbs"]
    assert cp["rpc"]["verbs"]["MultiTaskRequest"]["p99_s"] is not None
