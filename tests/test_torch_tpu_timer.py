"""The port's tpu_timer runtime against the JAX package's.

Both packages' native libraries get the same calls in one child process
(spans with flops, out-of-band records, gauges, counters, names with
unsafe characters, stuck spans under a 50 ms hang timeout): their
``/metrics`` families and every value that does not depend on timing
are equal, their timelines share a schema (and equal fields for the
records whose times the caller gave), and their watchdogs count the
same hangs. Then the port's own surfaces: the build into the build
directory, the HTTP daemon (``/timeline`` from memory), the collector,
the fetch tool, GC and function tracing, the stack dumps, the launch
wrapper's env and the runtime's daemon under ``DLROVER_TPU_TIMER``."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dlrover_tpu.diagnosis.collectors import (
    parse_prometheus_text as ref_parse_prometheus_text,
)
from dlrover_tpu_torch.diagnosis.collectors import (
    TpuTimerMetricCollector,
    parse_prometheus_text,
)
from dlrover_tpu_torch.tpu_timer import SpanKind, bridge, dump, get_timer

REPO = Path(__file__).resolve().parents[1]

_PARITY = r"""
import json, os, sys, tempfile, time
from dlrover_tpu.diagnosis.collectors import parse_prometheus_text as ref_parse
from dlrover_tpu.tpu_timer import bridge as ref_bridge
from dlrover_tpu_torch.diagnosis.collectors import parse_prometheus_text
from dlrover_tpu_torch.tpu_timer import bridge as port_bridge

out = {}
for label, b, parse in (("ref", ref_bridge, ref_parse),
                        ("port", port_bridge, parse_prometheus_text)):
    t = b.TpuTimer(hang_timeout_s=0.05)
    K = b.SpanKind
    base = t.now_ns()
    for i, dur in enumerate((2_500_000, 4_000_000, 1_000)):
        t.record("fixed_a", K.STEP, base + i * 10_000_000, dur, 5e9)
    t.record("fixed_b", K.COLLECTIVE, base, 300_000_000)
    t.record('we"ird{name}\nx', K.CUSTOM, base, 7_000)
    for _ in range(2):
        with t.span("timed", K.DATA, flops=1e9):
            time.sleep(0.002)
    t.set_gauge("goodput", 95.5)
    t.counter_add("steps", 3)
    t.counter_add("steps", 2)
    stuck = [t._lib.tt_begin(b"stuck", K.CUSTOM) for _ in range(2)]
    time.sleep(0.3)
    hung = t.hang_count()
    time.sleep(0.7)  # the watchdog's 500 ms tick sets hang_detected
    metrics = parse(t.metrics_text())
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    assert t.dump_timeline(path)
    with open(path) as f:
        timeline = json.load(f)
    os.unlink(path)
    for sid in stuck:
        t._lib.tt_end(sid, 0.0)
    out[label] = {"hung": hung, "hung_after": t.hang_count(),
                  "metrics": metrics, "timeline": timeline,
                  "base": base}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def parity():
    proc = subprocess.run(
        [sys.executable, "-c", _PARITY], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _timing_key(key):
    return key.endswith("/timed") or key.endswith("/stuck")


def test_metrics_families_and_values_match_the_reference(parity):
    ref, port = parity["ref"]["metrics"], parity["port"]["metrics"]
    assert sorted(ref) == sorted(port)
    families = {k.split("/", 1)[0] for k in port}
    assert {"tpu_timer_span_count", "tpu_timer_span_avg_us",
            "tpu_timer_span_p99_us", "tpu_timer_tflops", "tpu_timer_gauge",
            "tpu_timer_counter", "tpu_timer_hang_spans"} <= families
    fixed = {k: v for k, v in port.items()
             if not _timing_key(k) or k.startswith("tpu_timer_span_count")}
    assert fixed == {k: ref[k] for k in fixed}
    assert port["tpu_timer_span_count/fixed_a"] == 3
    assert port["tpu_timer_span_count/timed"] == 2
    assert port["tpu_timer_counter/steps"] == 5
    assert port["tpu_timer_gauge/goodput"] == 95.5
    assert port["tpu_timer_tflops/fixed_a"] == ref["tpu_timer_tflops/fixed_a"]
    assert port["tpu_timer_span_count/we_ird_name__x"] == 1


def test_watchdogs_count_the_same_hangs(parity):
    for label in ("ref", "port"):
        got = parity[label]
        assert (got["hung"], got["hung_after"]) == (2, 0), label
        assert got["metrics"]["tpu_timer_hang_spans"] == 2
        assert got["metrics"]["tpu_timer_gauge/hang_detected"] == 1.0


def test_timelines_share_a_schema(parity):
    ref = parity["ref"]["timeline"]["traceEvents"]
    port = parity["port"]["timeline"]["traceEvents"]
    assert len(ref) == len(port) > 0
    ref_base, port_base = parity["ref"]["base"], parity["port"]["base"]
    for a, b in zip(ref, port):
        assert sorted(a) == sorted(b)
        assert sorted(a["args"]) == sorted(b["args"]) == ["flops", "kind"]
        assert (a["name"], a["ph"], a["args"]) == (b["name"], b["ph"],
                                                   b["args"])
        if b["name"] != "timed":
            # Records whose times the caller gave: the same offsets.
            assert b["dur"] == a["dur"]
            assert abs((b["ts"] - port_base / 1e3)
                       - (a["ts"] - ref_base / 1e3)) < 2e-3


def test_native_library_builds_into_the_build_dir_by_hash(tmp_path,
                                                          monkeypatch):
    """The library lands in ``build/torch_native/`` named by a hash of
    its sources and flags; an edited source builds anew; the source
    tree is not written."""
    path = Path(bridge.library_path())
    assert path.parent == bridge.BUILD_DIR and path.exists()
    assert path.name.startswith("libtpu_timer_") and path.suffix == ".so"
    assert bridge.library_path() == str(path)
    assert sorted(p.name for p in bridge.NATIVE_DIR.iterdir()) == [
        "stack_sampler.cc", "tpu_timer.cc", "tpu_timer.h"]
    src = tmp_path / "native"
    src.mkdir()
    (src / "a.cc").write_text("int f() { return 1; }\n")
    monkeypatch.setattr(bridge, "NATIVE_DIR", src)
    monkeypatch.setattr(bridge, "BUILD_DIR", tmp_path / "build")
    flags = ("-O0", "-fPIC", "-shared")
    first = bridge.native_build("liba.so", ("a.cc",), flags)
    assert bridge.native_build("liba.so", ("a.cc",), flags) == first
    (src / "a.cc").write_text("int f() { return 2; }\n")
    second = bridge.native_build("liba.so", ("a.cc",), flags)
    assert second != first and Path(second).exists()


@pytest.fixture(scope="module")
def timer():
    t = get_timer()
    assert t.start_server(0) > 0
    return t


def _get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), body


def test_http_daemon_serves_metrics_timeline_and_health(timer, tmp_path):
    timer.record("daemon_span", SpanKind.STEP, timer.now_ns(), 1_000_000)
    status, ctype, body = _get(timer.port, "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    assert 'tpu_timer_span_count{name="daemon_span"} 1' in body.decode()
    status, ctype, body = _get(timer.port, "/timeline")
    assert status == 200 and ctype == "application/json"
    served = json.loads(body)
    path = tmp_path / "t.json"
    assert timer.dump_timeline(str(path))
    dumped = json.loads(path.read_text())
    names = {e["name"] for e in served["traceEvents"]}
    assert "daemon_span" in names
    assert names <= {e["name"] for e in dumped["traceEvents"]}
    assert _get(timer.port, "/healthz")[:1] == (200,)
    assert _get(timer.port, "/nothing")[0] == 404


def test_fetch_tool_retries_and_anchors_the_clock(timer, tmp_path, capsys):
    """``dump`` fetches the timeline with a clock_sync anchor (local
    host only), streams it to stdout, and retries a daemon that is not
    up with a bounded backoff."""
    data = dump.fetch_with_retries(timer.port, "/timeline", retries=1)
    trace = json.loads(dump.annotate_clock_sync(data))
    expect = time.time() - time.monotonic()
    assert abs(trace["clock_sync"]["epoch_minus_mono_us"] / 1e6
               - expect) < 5
    assert json.loads(dump.annotate_clock_sync(data, host="10.0.0.1")) == \
        json.loads(data)
    out = tmp_path / "trace.json"
    assert dump.main(["--port", str(timer.port), "--out", str(out)]) == 0
    assert "clock_sync" in json.loads(out.read_text())
    assert dump.main(["--port", str(timer.port), "--metrics"]) == 0
    assert "tpu_timer_hang_spans" in capsys.readouterr().out
    t0 = time.monotonic()
    with pytest.raises(OSError):
        dump.fetch_with_retries(1, "/metrics", retries=2, backoff_s=0.05)
    assert time.monotonic() - t0 < 5


def test_collector_scrapes_parses_and_reports(timer, tmp_path):
    timer.set_gauge("collector_gauge", 2.5)
    text = _get(timer.port, "/metrics")[2].decode()
    assert parse_prometheus_text(text) == ref_parse_prometheus_text(text)

    class Client:
        def __init__(self):
            self.reports = []

        def report_diagnosis_data(self, data_type, payload):
            self.reports.append((data_type, payload))

    port_file = tmp_path / "port"
    port_file.write_text(str(timer.port))
    client = Client()
    c = TpuTimerMetricCollector(master_client=client, node_id=3, port=1,
                                port_file=str(port_file))
    assert c.collect_once()
    data_type, payload = client.reports[0]
    assert data_type == "xpu_timer_metric" and payload["node_rank"] == 3
    assert payload["metrics"]["tpu_timer_gauge/collector_gauge"] == 2.5
    c = TpuTimerMetricCollector(master_client=client, port=1,
                                interval_s=0.05)
    assert c.scrape() is None and not c.collect_once()


@pytest.mark.parametrize("text", [
    'a_total 3\n# HELP x y\nb{name="n1"} 2.5\n',
    'm{name="k}{\\"q\\""} 1e3\nm{le="0.5",name="z"} NaN\nbad line\n',
    'g{name="a"} +Inf\ng{name="b"} -Inf\nh{a="1",b="2"} 7\n',
])
def test_prometheus_parse_matches_the_reference(text):
    import math

    got, want = parse_prometheus_text(text), ref_parse_prometheus_text(text)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == want[k] or (math.isnan(got[k])
                                     and math.isnan(want[k]))


def test_gc_and_function_tracing_record_spans(timer):
    import gc

    from dlrover_tpu_torch.tpu_timer import py_tracing

    py_tracing.trace_gc()
    try:
        gc.collect()
    finally:
        py_tracing.untrace_gc()

    @py_tracing.traced("traced_fn")
    def work(x):
        return x + 1

    assert work(1) == 2
    text = timer.metrics_text()
    assert 'tpu_timer_span_count{name="py_gc_gen2"}' in text
    assert 'tpu_timer_span_count{name="traced_fn"} 1' in text


_SIGUSR2_CHILD = r"""
import sys, time
from dlrover_tpu_torch.tpu_timer.py_tracing import (
    dump_stacks, install_stack_dump_handler)
install_stack_dump_handler()
dump_stacks(sys.stdout)
sys.stdout.write("READY\n"); sys.stdout.flush()
time.sleep(3)
sys.stdout.write("ALIVE\n")
"""


def test_sigusr2_dumps_stacks_and_does_not_kill():
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGUSR2_CHILD], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("READY"):
            break
    os.kill(proc.pid, signal.SIGUSR2)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0 and "ALIVE" in out
    assert any("Current thread" in ln or "Thread 0x" in ln for ln in lines)
    assert "most recent call first" in err


def test_launch_wrapper_env_matches_the_reference_and_execs(tmp_path):
    from dlrover_tpu.tpu_timer import launch as ref_launch
    from dlrover_tpu_torch.tpu_timer import launch

    base = {"PYTHONPATH": "/x", "KEEP": "1"}
    env = launch.build_env(5.0, 0.25, env=base)
    ref = ref_launch.build_env(5.0, 0.25, env=base)
    inject = REPO / "dlrover_tpu_torch" / "tpu_timer" / "_inject"
    assert env["PYTHONPATH"].split(os.pathsep) == [str(inject), str(REPO),
                                                   "/x"]
    assert {k: v for k, v in env.items() if k != "PYTHONPATH"} == {
        k: v for k, v in ref.items() if k != "PYTHONPATH"}
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.tpu_timer.launch",
         "--interval", "9", "--", sys.executable, "-c",
         f"import os; open({str(out)!r}, 'w').write("
         "os.environ['DLROVER_TPU_TIMER_XLA_INTERVAL'])"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out.read_text() == "9.0"


_RUNTIME_CHILD = r"""
import http.client, json, os
from dlrover_tpu_torch.tpu_timer import bridge
from dlrover_tpu_torch.trainer import runtime
ctx = runtime.init_distributed(device="cpu")
with open(bridge.port_file_path(0)) as f:
    port = int(f.read())
conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
conn.request("GET", "/metrics")
text = conn.getresponse().read().decode()
print(json.dumps({"port": port, "hang": "tpu_timer_hang_spans" in text}))
"""


def test_runtime_starts_the_daemon_and_publishes_its_port(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), DLROVER_TPU_TIMER="1",
               DLROVER_TPU_JOB_NAME=f"rt{os.getpid()}",
               DLROVER_TPU_HANG_DEADLINE_S="0", TMPDIR=str(tmp_path),
               DLROVER_TPU_FLIGHT_DIR=str(tmp_path / "flight"))
    proc = subprocess.run([sys.executable, "-c", _RUNTIME_CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["port"] > 0 and got["hang"]
