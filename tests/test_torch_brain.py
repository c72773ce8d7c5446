"""The port's brain (``brain/service.py``, ``brain/evaluators.py``,
``brain/client.py``) against the reference's, on the CPU.

- one seeded record set posted to both packages' services gives the
  same ``/optimize`` plans and assessments, on both stores and both
  optimizers; the admin endpoints and the error answers agree;
- both stores' retention (record count, age) and compaction agree;
- the wire both ways: the port's reporter and optimizer against the
  reference's service, the reference's against the port's;
- the port's stores take concurrent posts from the handler threads;
- ``load_plugin`` resolves ``pkg.module:factory`` paths of a module
  outside both packages, for optimizers and evaluators;
- ``python -m dlrover_tpu_torch.brain.service`` serves until SIGINT;
- the reference's cross-job scenario, on both packages: two jobs'
  collectors feed the brain, a third job's auto-scaler resizes its
  simulated cluster to the brain's plan.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import http.client
import importlib
import json
import os
import random
import re
import signal
import sqlite3
import subprocess
import sys
import threading
import time
import types
import uuid
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKGS = ("dlrover_tpu", "dlrover_tpu_torch")
STORES = ("jsonl", "sqlite")
OPTIMIZERS = ("speedup", "marginal-gain")


def pkg(base, module):
    return importlib.import_module(f"{base}.{module}")


def _request(port, method, path, payload=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        body = raw if raw is not None else (
            json.dumps(payload) if payload is not None else None)
        conn.request(method, path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _post(port, path, payload):
    return _request(port, "POST", path, payload)


def _get(port, path):
    return _request(port, "GET", path)


@pytest.fixture()
def services(tmp_path, request):
    """Start both packages' services with the same settings:
    ``services(store=..., optimizer=...)`` -> {base: service}."""
    started = []

    def start(**kw):
        out = {}
        for base in PKGS:
            svc = pkg(base, "brain.service").BrainService(
                port=0, data_dir=str(tmp_path / f"{base}-{uuid.uuid4().hex}"),
                **kw)
            svc.start()
            started.append(svc)
            out[base] = svc
        return out

    yield start
    for svc in started:
        svc.stop()


def _seeded_records(seed):
    """Runtime samples and completions of three jobs, junk included:
    a degrading job, a job with a straggling worker count and OOM
    deaths, a job scaling with falling efficiency."""
    rng = random.Random(seed)
    records = []
    for i in range(12):
        records.append(("runtime", {
            "job_name": "degrading", "worker_count": 4,
            "speed": 1000.0 - 35 * i + rng.uniform(-5, 5)}))
    for i in range(9):
        count = rng.choice([2, 4])
        records.append(("runtime", {
            "job_name": "flaky", "worker_count": count,
            "speed": count * rng.uniform(50, 150)}))
    for reason in ("oom", "OOM", "Succeeded", "oom"):
        records.append(("completion", {
            "job_name": "flaky", "worker_count": 4,
            "success": reason == "Succeeded", "exit_reason": reason}))
    for count, speed in ((4, 4000), (8, 7000), (16, 8000), (2, 2100)):
        for _ in range(rng.randint(1, 3)):
            records.append(("runtime", {
                "job_name": "scaling", "worker_count": count,
                "speed": speed * rng.uniform(0.97, 1.03)}))
    records += [
        ("runtime", {"job_name": "scaling", "speed": "NaNish"}),
        ("runtime", {"job_name": "scaling", "worker_count": "x",
                     "speed": 5.0}),
        ("runtime", {"job_name": "scaling", "worker_count": 0,
                     "speed": 5.0}),
    ]
    rng.shuffle(records)
    return records


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("store", STORES)
def test_optimize_matches_the_reference(services, store, optimizer):
    svcs = services(store=store, optimizer=optimizer)
    for kind, record in _seeded_records(7):
        for svc in svcs.values():
            assert _post(svc.port, "/persist_metrics",
                         {"kind": kind, "record": record}) == (200, {
                             "ok": True})
    answers = {}
    for base, svc in svcs.items():
        answers[base] = [_post(svc.port, "/optimize", {"job_name": job})
                         for job in ("degrading", "flaky", "scaling",
                                     "nosuchjob")]
    assert answers["dlrover_tpu_torch"] == answers["dlrover_tpu"]
    by_job = dict(zip(("degrading", "flaky", "scaling", "nosuchjob"),
                      (body for _, body in answers["dlrover_tpu_torch"])))
    assessed = {a["evaluator"]: a
                for a in by_job["degrading"]["assessments"]}
    assert assessed["throughput_trend"]["degrading"] is True
    flaky = {a["evaluator"]: a for a in by_job["flaky"]["assessments"]}
    assert flaky["oom_risk"]["at_risk"] is True
    assert flaky["straggler"]["suspected"] is True
    assert by_job["scaling"]["plan"]["worker_count"] == (
        2 if optimizer == "speedup" else 8)
    assert by_job["nosuchjob"] == {"plan": None, "assessments": []}


@pytest.mark.parametrize("store", STORES)
def test_admin_endpoints_match_the_reference(services, store):
    svcs = services(store=store)
    for kind, record in _seeded_records(3):
        for svc in svcs.values():
            _post(svc.port, "/persist_metrics",
                  {"kind": kind, "record": record})
    answers = {}
    for base, svc in svcs.items():
        admin_store = _get(svc.port, "/admin/store")
        admin_store[1].pop("dir" if store == "jsonl" else "path")
        answers[base] = [
            _get(svc.port, "/admin/jobs"), admin_store,
            _get(svc.port, "/admin/evaluators"),
            _get(svc.port, "/admin/nope"),
            _post(svc.port, "/nope", {}),
            _post(svc.port, "/persist_metrics", {"kind": "bogus"}),
            _request(svc.port, "POST", "/optimize", raw="{not json"),
        ]
    assert answers["dlrover_tpu_torch"] == answers["dlrover_tpu"]
    jobs, admin_store, evaluators = answers["dlrover_tpu_torch"][:3]
    assert set(jobs[1]["jobs"]) == {"degrading", "flaky", "scaling"}
    assert admin_store[1]["backend"] == store
    assert evaluators[1]["evaluators"] == [
        "oom_risk", "straggler", "throughput_trend"]
    assert [a[0] for a in answers["dlrover_tpu_torch"][3:]] == [
        404, 404, 400, 400]


def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


@pytest.mark.parametrize("store", STORES)
def test_store_retention_and_compaction_match_the_reference(tmp_path, store):
    loads = {}
    for base in PKGS:
        cls = pkg(base, "brain.service").STORES[store]
        d = str(tmp_path / base)
        st = cls(d, max_records=5, compact_every=3)
        for i in range(11):
            st.append("runtime", {"job_name": f"j{i % 2}", "i": i})
            st.append("completion", {"job_name": "j0", "i": i})
        st.compact("runtime")
        got = [_strip_ts(st.load("runtime")),
               _strip_ts(st.load("runtime", job_name="j1")),
               _strip_ts(st.load("completion")), st.job_names()]
        # Age retention: history older than max_age_s goes at start.
        old = time.time() - 10 * 24 * 3600
        if store == "jsonl":
            with open(os.path.join(d, "runtime.jsonl"), "a") as f:
                f.write(json.dumps({"job_name": "old", "ts": old}) + "\n")
                f.write('{"job_name": "torn", "ts"')  # torn mid-append
        else:
            st.close()
            db = sqlite3.connect(os.path.join(d, "brain.sqlite"))
            db.execute("INSERT INTO metrics (kind, job_name, ts, record) "
                       "VALUES ('runtime', 'old', ?, ?)",
                       (old, json.dumps({"job_name": "old", "ts": old})))
            db.commit()
            db.close()
        st2 = cls(d, max_records=0, max_age_s=24 * 3600.0)
        got.append(sorted(r.get("job_name") for r in st2.load("runtime")))
        # Unlimited count (max_records 0): nothing is cut by number.
        for i in range(7):
            st2.append("runtime", {"job_name": "more", "i": i})
        st2.compact("runtime")
        got.append(len(st2.load("runtime", job_name="more")))
        got.append({k: v for k, v in st2.stats().items()
                    if k not in ("dir", "path")})
        st2.close()
        loads[base] = got
    assert loads["dlrover_tpu_torch"] == loads["dlrover_tpu"]
    runtime = loads["dlrover_tpu_torch"][0]
    assert [r["i"] for r in runtime] == [6, 7, 8, 9, 10]
    assert "old" not in loads["dlrover_tpu_torch"][4]
    assert loads["dlrover_tpu_torch"][5] == 7


def _reporter_round(client_base, port, job):
    """Report through ``client_base``'s client, then ask its optimizer;
    returns the plan's (count, comment)."""
    client = pkg(client_base, "brain.client")
    stats = pkg(client_base, "master.stats.job_collector")
    addr = f"127.0.0.1:{port}"
    reporter = client.BrainStatsReporter(addr, job)
    for _ in range(3):
        for step, speed, workers in ((10, 2.0, 4), (20, 2.4, 8)):
            reporter.report_runtime_sample(stats.RuntimeMetricSample(
                timestamp=0.0, global_step=step, speed=speed, goodput=0.9,
                worker_count=workers))
    reporter.report_job_completion(stats.JobCompletionRecord(
        job, True, "Succeeded", 100.0, 0))
    plan = client.BrainResourceOptimizer(addr, job).generate_plan()
    group = plan.node_group_resources.get("worker")
    return (group.count if group else None, plan.comment)


@pytest.mark.parametrize("client_base, service_base", [
    ("dlrover_tpu_torch", "dlrover_tpu"),
    ("dlrover_tpu", "dlrover_tpu_torch"),
])
def test_the_wire_both_ways(services, client_base, service_base):
    svcs = services()
    across = _reporter_round(client_base, svcs[service_base].port, "wired")
    same = _reporter_round(service_base, svcs[client_base].port, "wired")
    assert across == same == (4, "brain: 4 workers (6 samples)")
    for svc in (svcs[service_base], svcs[client_base]):
        completions = svc.store.load("completion", job_name="wired")
        assert _strip_ts(completions) == [{
            "job_name": "wired", "success": True,
            "exit_reason": "Succeeded", "duration_s": 100.0,
            "failure_count": 0}]
        runtime = svc.store.load("runtime", job_name="wired")
        assert [r["worker_count"] for r in runtime] == [4, 8] * 3
    # An unreachable brain: an empty plan, reports dropped quietly.
    client = pkg(client_base, "brain.client")
    assert client.BrainResourceOptimizer(
        "127.0.0.1:1", "wired").generate_plan().empty()
    stats = pkg(client_base, "master.stats.job_collector")
    client.BrainStatsReporter("127.0.0.1:1", "wired").report_job_completion(
        stats.JobCompletionRecord("wired", False, "x", 1.0, 1))


@pytest.mark.parametrize("store", STORES)
def test_store_takes_concurrent_posts(tmp_path, store):
    """The port's handler threads append to one store at once: every
    post lands, once, and reads stay consistent meanwhile."""
    from dlrover_tpu_torch.brain.service import BrainService

    svc = BrainService(port=0, data_dir=str(tmp_path / "b"), store=store,
                       max_records=0)
    svc.start()
    errors, threads_n, posts_n = [], 8, 25

    def poster(t):
        try:
            for i in range(posts_n):
                status, _ = _post(svc.port, "/persist_metrics", {
                    "kind": "runtime", "record": {
                        "job_name": "c", "t": t, "i": i,
                        "worker_count": 1 + t % 3, "speed": 1.0 + i}})
                assert status == 200
                if i % 10 == 0:
                    status, body = _post(svc.port, "/optimize",
                                         {"job_name": "c"})
                    assert status == 200 and body["plan"] is not None
        except Exception as e:  # noqa: BLE001 - collected, asserted below
            errors.append(e)

    try:
        threads = [threading.Thread(target=poster, args=(t,))
                   for t in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert errors == []
        records = svc.store.load("runtime", job_name="c")
        assert sorted((r["t"], r["i"]) for r in records) == sorted(
            (t, i) for t in range(threads_n) for i in range(posts_n))
        assert svc.store.job_names() == {"c": threads_n * posts_n}
    finally:
        svc.stop()


_PLUGIN = '''
class HalfOptimizer:
    def __init__(self, store):
        self._store = store

    def optimize(self, job_name):
        n = len(self._store.load("runtime", job_name=job_name))
        return {"worker_count": max(n // 2, 1), "optimizer": "half"}


def make_optimizer(store):
    return HalfOptimizer(store)


class CountEvaluator:
    name = "count"

    def __init__(self, store):
        self._store = store

    def evaluate(self, job_name):
        return {"evaluator": "count",
                "n": len(self._store.load("completion", job_name=job_name))}


def make_evaluator(store):
    return CountEvaluator(store)


def make_broken(store):
    class Broken:
        name = "broken"

        def evaluate(self, job_name, runtime=None, completions=None):
            raise TypeError("inside the evaluator")

    return Broken()
'''


def test_plugins_load_from_a_module_outside_both_packages(
        services, tmp_path, monkeypatch):
    mod = f"brain_plugins_{uuid.uuid4().hex[:8]}"
    (tmp_path / f"{mod}.py").write_text(_PLUGIN)
    monkeypatch.syspath_prepend(str(tmp_path))
    svcs = services(optimizer=f"{mod}:make_optimizer",
                    evaluators=[f"{mod}:make_evaluator", "oom_risk",
                                f"{mod}:make_broken"])
    for svc in svcs.values():
        for i in range(6):
            _post(svc.port, "/persist_metrics", {"kind": "runtime", "record": {
                "job_name": "p", "worker_count": 2, "speed": 1.0}})
        _post(svc.port, "/persist_metrics", {"kind": "completion", "record": {
            "job_name": "p", "exit_reason": "oom"}})
    answers = {base: [_post(svc.port, "/optimize", {"job_name": "p"}),
                      _get(svc.port, "/admin/evaluators")]
               for base, svc in svcs.items()}
    assert answers["dlrover_tpu_torch"] == answers["dlrover_tpu"]
    (_, body), (_, evs) = answers["dlrover_tpu_torch"]
    assert body["plan"] == {"worker_count": 3, "optimizer": "half"}
    assert [a["evaluator"] for a in body["assessments"]] == [
        "count", "oom_risk"]
    assert evs == {"optimizer": "HalfOptimizer",
                   "evaluators": ["count", "oom_risk", "broken"]}
    for base in PKGS:
        ev = pkg(base, "brain.evaluators")
        svc_mod = pkg(base, "brain.service")
        with pytest.raises(ValueError, match="unknown evaluator 'nope'"):
            ev.create_evaluator("nope", None)
        with pytest.raises(ValueError, match="failed to load"):
            svc_mod.create_optimizer(f"{mod}:missing", None)
        with pytest.raises(ValueError, match="failed to load"):
            ev.create_evaluator("no_such_module_x:f", None)
        with pytest.raises(ValueError, match="unknown store"):
            svc_mod.BrainService(port=0, data_dir=str(tmp_path / "x"),
                                 store="mysql")


def test_brain_service_cli_serves_until_sigint(tmp_path):
    """``python -m dlrover_tpu_torch.brain.service --port 0 --store
    sqlite --evaluators oom_risk``: it logs its port, takes reports,
    answers ``/optimize``, and exits 0 on SIGINT with the store on
    disk."""
    data = tmp_path / "brain"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.brain.service",
         "--port", "0", "--data_dir", str(data), "--store", "sqlite",
         "--optimizer", "marginal-gain", "--evaluators", "oom_risk"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 60
        while "brain service on port" not in line:
            assert time.monotonic() < deadline and proc.poll() is None
            line = proc.stderr.readline()
        port = int(re.search(r"on port (\d+)", line).group(1))
        for count, speed in ((4, 4000), (8, 7000), (16, 8000)):
            _post(port, "/persist_metrics", {"kind": "runtime", "record": {
                "job_name": "cli", "worker_count": count, "speed": speed}})
        status, body = _post(port, "/optimize", {"job_name": "cli"})
        assert status == 200
        assert body["plan"]["worker_count"] == 8
        assert body["assessments"] == []
        assert _get(port, "/admin/evaluators")[1] == {
            "optimizer": "MarginalGainOptimizer", "evaluators": ["oom_risk"]}
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    store = pkg("dlrover_tpu_torch", "brain.service").SqliteBrainStore(
        str(data))
    assert store.job_names() == {"cli": 3}
    store.close()


def _cross_job_run(base, tmp_path):
    """The reference's cross-job scenario on ``base``: two completed
    jobs of one name feed the brain through the master-side path
    (job manager on a sim cluster -> perf monitor -> collector ->
    ``BrainStatsReporter``); a third job's throughput auto-scaler
    (``BrainResourceOptimizer``) then resizes its cluster."""
    p = types.SimpleNamespace(**{
        name: pkg(base, mod) for name, mod in (
            ("node", "common.node"), ("perf", "master.monitor.perf_monitor"),
            ("mgr", "master.node.dist_job_manager"),
            ("auto", "master.node.job_auto_scaler"),
            ("ctx", "master.node.job_context"),
            ("stats", "master.stats.job_collector"),
            ("sim", "testing.sim_cluster"), ("client", "brain.client"),
            ("service", "brain.service"))})
    job = "learned-job"
    service = p.service.BrainService(port=0, data_dir=str(tmp_path / base))
    service.start()

    def wait_until(pred, timeout=20.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return True
            time.sleep(0.02)
        return False

    def make_mgr(count):
        p.ctx.JobContext.reset_singleton()
        cluster = p.sim.SimCluster()
        mgr = p.mgr.DistributedJobManager(
            job_name=job,
            node_groups={"worker": p.node.NodeGroupResource(
                count=count, node_resource=p.node.NodeResource(tpu_chips=4))},
            scaler=p.sim.SimScaler(job, cluster),
            watcher=p.sim.SimNodeWatcher(job, cluster),
        )
        mgr.start()
        assert wait_until(
            lambda: len(mgr.worker_manager.alive_nodes()) == count)
        return mgr

    addr = f"127.0.0.1:{service.port}"
    try:
        samples = []
        for count, speed in ((4, 2.0), (8, 2.4)):
            mgr = make_mgr(count)
            perf = p.perf.PerfMonitor()
            collector = p.stats.JobMetricCollector(
                job, mgr, perf,
                reporter=p.client.BrainStatsReporter(addr, job))
            t0 = time.time()
            perf.collect_global_step(0, t0)
            perf.collect_global_step(int(speed * 100), t0 + 100.0)
            sample = collector.collect_once()
            samples.append((sample.worker_count, round(sample.speed, 9)))
            collector.report_completion(True, "Succeeded", 0)
            mgr.stop()
        mgr3 = make_mgr(8)
        optimizer = p.client.BrainResourceOptimizer(addr, job)
        plan = optimizer.generate_plan()
        auto = p.auto.AllreduceTrainingAutoScaler(
            mgr3, mgr3._scaler, optimizer, rdzv_managers={})
        auto.scale_once()
        assert wait_until(
            lambda: len(mgr3.worker_manager.alive_nodes()) == 4)
        alive = len(mgr3.worker_manager.alive_nodes())
        mgr3.stop()
        fresh = p.client.BrainResourceOptimizer(
            addr, "fresh-job").generate_plan().empty()
        return (samples, plan.node_group_resources["worker"].count,
                plan.comment, alive, fresh)
    finally:
        p.ctx.JobContext.reset_singleton()
        service.stop()


def test_cross_job_history_shapes_third_jobs_plan(tmp_path):
    runs = {base: _cross_job_run(base, tmp_path) for base in PKGS}
    assert runs["dlrover_tpu_torch"] == runs["dlrover_tpu"]
    assert runs["dlrover_tpu_torch"] == (
        [(4, 2.0), (8, 2.4)], 4, "brain: 4 workers (2 samples)", 4, True)
