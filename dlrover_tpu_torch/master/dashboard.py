"""Master web dashboard: job/node/rendezvous/data state over HTTP.

Parity: reference dlrover/dashboard (tornado app wired at
master/main.py:100-107, jobs/nodes UI) — rebuilt on the stdlib HTTP
server: JSON APIs (/api/job, /api/perf, /api/nodes, /api/rdzv,
/api/datasets) plus a single self-contained HTML page rendering the
node table (status, exit history, heartbeat age, slice block), the
rendezvous state, dataset progress, and training perf.

The port's copy of ``dlrover_tpu/master/dashboard.py``.
"""

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dlrover_tpu_torch.common.log import logger

_PAGE = """<!DOCTYPE html>
<html><head><title>dlrover-tpu</title>
<style>
body{font-family:monospace;margin:2em;background:#fafafa}
table{border-collapse:collapse;margin-bottom:1.2em}
td,th{border:1px solid #999;padding:4px 10px}
h1{font-size:1.3em}h2{font-size:1.05em;margin-bottom:.3em}
.Running{color:green}.Failed,.Breakdown{color:red}
.Pending,.Initial{color:#b8860b}.Succeeded{color:blue}
</style></head><body>
<h1>dlrover-tpu job <span id="job"></span></h1>
<p>stage: <b id="stage"></b> | step: <b id="step"></b> |
speed: <b id="speed"></b> steps/s | goodput: <b id="goodput"></b>%</p>
<h2>nodes</h2>
<table id="nodes"><tr><th>id</th><th>role</th><th>rank</th><th>block</th>
<th>status</th><th>relaunches</th><th>exit history</th>
<th>heartbeat</th><th>host</th></tr></table>
<h2>rendezvous</h2>
<table id="rdzv"><tr><th>name</th><th>round</th><th>waiting</th>
<th>world</th></tr></table>
<h2>datasets</h2>
<table id="data"><tr><th>name</th><th>todo</th><th>doing</th>
<th>completed</th><th>records done</th></tr></table>
<script>
async function j(u){return await (await fetch(u)).json();}
function fill(t, rows){
 while(t.rows.length > 1) t.deleteRow(1);
 for(const cells of rows){
  const r = t.insertRow();
  for(const [v, cls, href] of cells){
   const c = r.insertCell();
   if(href){const a=document.createElement('a');a.href=href;
    a.textContent=v;c.appendChild(a);}
   else c.textContent = v;
   if(cls) c.className = cls;
  }
 }
}
async function refresh(){
 const job = await j('/api/job');
 const perf = await j('/api/perf');
 const nodes = await j('/api/nodes');
 const rdzv = await j('/api/rdzv');
 const data = await j('/api/datasets');
 document.getElementById('job').textContent = job.job_name;
 document.getElementById('stage').textContent = job.stage;
 document.getElementById('step').textContent = perf.global_step;
 document.getElementById('speed').textContent = perf.speed.toFixed(2);
 document.getElementById('goodput').textContent = (perf.goodput*100).toFixed(1);
 fill(document.getElementById('nodes'), nodes.map(n => [
  [n.type + '-' + n.id, '', '/node/' + n.type + '-' + n.id],
  [n.type], [n.rank], [n.node_group < 0 ? '-' : n.node_group],
  [n.status, n.status], [n.relaunch_count],
  [n.exit_history.join(',') || '-'],
  [n.heartbeat_age_s == null ? '-' : n.heartbeat_age_s + 's'],
  [n.host || '']]));
 fill(document.getElementById('rdzv'), rdzv.map(r => [
  [r.name], [r.round], [r.waiting], [r.world_size]]));
 fill(document.getElementById('data'), data.map(d => [
  [d.name], [d.todo], [d.doing], [d.completed], [d.records_done]]));
}
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


_NODE_PAGE = """<!DOCTYPE html>
<html><head><title>dlrover-tpu node</title>
<style>
body{font-family:monospace;margin:2em;background:#fafafa}
table{border-collapse:collapse;margin-bottom:1.2em}
td,th{border:1px solid #999;padding:4px 10px}
h1{font-size:1.3em}h2{font-size:1.05em;margin-bottom:.3em}
.Running{color:green}.Failed,.Breakdown{color:red}
.Pending,.Initial{color:#b8860b}.Succeeded{color:blue}
</style></head><body>
<p><a href="/">&larr; job</a></p>
<h1>node <span id="name"></span></h1>
<h2>facts</h2>
<table id="facts"><tr><th>field</th><th>value</th></tr></table>
<h2>status timeline</h2>
<table id="tl"><tr><th>time</th><th>status</th><th>+s</th></tr></table>
<h2>exit history</h2>
<table id="exits"><tr><th>#</th><th>reason</th></tr></table>
<script>
async function refresh(){
 const key = location.pathname.split('/').pop();
 const resp = await fetch('/api/node/' + key);
 if(!resp.ok){document.getElementById('name').textContent =
   key + ' (not found)'; return;}
 const n = await resp.json();
 document.getElementById('name').textContent = n.name;
 const facts = document.getElementById('facts');
 while(facts.rows.length > 1) facts.deleteRow(1);
 const rows = [['type', n.type], ['rank', n.rank],
  ['slice block', n.node_group < 0 ? '-' : n.node_group],
  ['status', n.status], ['reported status', n.reported_status || '-'],
  ['host', (n.host || '-') + (n.host_ip ? ' (' + n.host_ip + ')' : '')],
  ['critical', n.critical], ['relaunches',
   n.relaunch_count + ' / ' + n.max_relaunch_count],
  ['relaunchable', n.relaunchable],
  ['unrecoverable', n.unrecoverable || '-'],
  ['exit reason', n.exit_reason || '-'],
  ['heartbeat age', n.heartbeat_age_s == null ? '-'
    : n.heartbeat_age_s + 's'],
  ['resources', 'cpu ' + n.resource.cpu + ', mem ' +
   n.resource.memory_mb + 'MB, chips ' + n.resource.tpu_chips]];
 for(const [k, v] of rows){
  const r = facts.insertRow();
  r.insertCell().textContent = k;
  const c = r.insertCell(); c.textContent = v;
  if(k == 'status') c.className = n.status;
 }
 const tl = document.getElementById('tl');
 while(tl.rows.length > 1) tl.deleteRow(1);
 const t0 = n.timeline.length ? n.timeline[0].ts : 0;
 for(const ev of n.timeline){
  const r = tl.insertRow();
  r.insertCell().textContent = new Date(ev.ts*1000).toISOString();
  const c = r.insertCell(); c.textContent = ev.status;
  c.className = ev.status;
  r.insertCell().textContent = (ev.ts - t0).toFixed(1);
 }
 const ex = document.getElementById('exits');
 while(ex.rows.length > 1) ex.deleteRow(1);
 n.exit_history.forEach((reason, i) => {
  const r = ex.insertRow();
  r.insertCell().textContent = i + 1;
  r.insertCell().textContent = reason;
 });
}
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


class DashboardServer:
    def __init__(
        self,
        job_manager,
        perf_monitor,
        port: int = 0,
        rdzv_managers=None,
        task_manager=None,
        metric_context=None,
        trace_aggregator=None,
        autoscaler=None,
        control_plane=None,
    ):
        self._job_manager = job_manager
        self._perf_monitor = perf_monitor
        self._rdzv_managers = rdzv_managers or {}
        self._task_manager = task_manager
        self._metric_context = metric_context
        self._trace_aggregator = trace_aggregator
        self._autoscaler = autoscaler
        # Zero-arg callable (the servicer's control_plane_state):
        # overload governor state + per-verb RPC telemetry + bounded
        # buffer occupancy/drops (§32).
        self._control_plane = control_plane
        self._requested_port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self.port = 0
        self._thread: Optional[threading.Thread] = None

    def _make_handler(self):
        dashboard = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            # Exact-path JSON providers. Each call is guarded in
            # do_GET: one raising subsystem answers its own endpoint
            # with a 503 + JSON error body instead of an unhandled
            # exception (empty reply on the wire), and the OTHER
            # endpoints keep serving — an incident dashboard must
            # degrade per-panel, not whole-page.
            _JSON_ROUTES = {
                "/api/job": lambda: dashboard._job_detail(),
                "/api/perf": lambda: dashboard._perf(),
                "/api/nodes": lambda: dashboard._nodes(),
                "/api/rdzv": lambda: dashboard._rdzv(),
                "/api/datasets": lambda: dashboard._datasets(),
                "/api/phases": lambda: dashboard._phases(),
                # Live per-rank step-time skew (the autoscaler's and
                # SRE's "which rank is slow RIGHT NOW" view).
                "/api/stragglers": lambda: dashboard._stragglers(),
                # §34 per-cause goodput attribution: where the
                # non-train wall time went (train + ckpt/rescale/
                # straggler/hang/shed + unattributed residual), the
                # averaging basis, and the serving-side useful-token
                # fraction merged into one view.
                "/api/goodput": lambda: dashboard._goodput(),
                # The §32 saturation plane: overload governor state,
                # per-verb RPC telemetry, bounded-buffer occupancy.
                "/api/control_plane": (
                    lambda: dashboard._control_plane_state()
                ),
            }

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, _PAGE, "text/html")
                elif self.path in self._JSON_ROUTES:
                    self._send_json(self._JSON_ROUTES[self.path])
                elif self.path == "/metrics":
                    # One Prometheus scrape covers the whole job:
                    # process registry (event-drop counters, phase
                    # second counters, ...) + live goodput/speed + the
                    # per-node daemon aggregates the master scraped.
                    try:
                        text = dashboard._metrics_text()
                    except Exception as e:  # noqa: BLE001 — degrade, don't die
                        self._send_unavailable(e)
                        return
                    self._send(200, text, "text/plain; version=0.0.4")
                elif self.path.startswith("/api/autoscaler"):
                    # The §30/§34 resource brain: live signal snapshot,
                    # the decision ledger (with realized outcomes), and
                    # the dry-run diff. Query params page the ledger
                    # (?last=N&offset=M) and ?signals=compact drops the
                    # per-decision triggering snapshots — a full ledger
                    # over a large world is a multi-MB response.
                    self._send_json(
                        lambda: dashboard._autoscaler_state(self.path)
                    )
                elif self.path.startswith("/api/traces"):
                    self._send_json(
                        lambda: dashboard._traces(self.path)
                    )
                elif self.path.startswith("/api/node/"):
                    try:
                        detail = dashboard._node_detail(
                            self.path.rsplit("/", 1)[-1]
                        )
                    except Exception as e:  # noqa: BLE001
                        self._send_unavailable(e)
                        return
                    if detail is None:
                        self._send(404, "no such node", "text/plain")
                    else:
                        self._send(
                            200, json.dumps(detail), "application/json"
                        )
                elif self.path.startswith("/node/"):
                    self._send(200, _NODE_PAGE, "text/html")
                else:
                    self._send(404, "not found", "text/plain")

            def _send_json(self, provider):
                try:
                    body = json.dumps(provider())
                except Exception as e:  # noqa: BLE001 — 503, not a dead panel
                    self._send_unavailable(e)
                    return
                self._send(200, body, "application/json")

            def _send_unavailable(self, exc):
                self._send(
                    503,
                    json.dumps({
                        "error": f"{type(exc).__name__}: {exc}"[:300],
                        "unavailable": True,
                    }),
                    "application/json",
                )

            def _send(self, code, body, ctype):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        return Handler

    def _job_detail(self):
        detail = self._job_manager.get_job_detail()
        return {
            "job_name": detail.job_name,
            "stage": detail.stage,
            "nodes": detail.nodes,
        }

    def _perf(self):
        perf = {
            "global_step": self._perf_monitor.global_step,
            "speed": self._perf_monitor.running_speed(),
            "goodput": self._perf_monitor.goodput(),
        }
        breakdown = getattr(self._perf_monitor, "phase_breakdown", None)
        if callable(breakdown):
            perf["phase_breakdown"] = breakdown()
            perf["phase_fractions"] = breakdown(as_fractions=True)
        # Averaging mode + node count (was only a code comment): a
        # 1-node 0.9 and a 64-node 0.9 are different claims.
        basis = getattr(self._perf_monitor, "goodput_basis", None)
        if callable(basis):
            perf["goodput_basis"] = basis()
        return perf

    def _goodput(self):
        attribution = getattr(
            self._perf_monitor, "goodput_attribution", None
        )
        basis = getattr(self._perf_monitor, "goodput_basis", None)
        out = {
            "training": attribution() if callable(attribution) else None,
            "goodput_basis": basis() if callable(basis) else None,
            "serving": self._serving_useful_tokens(),
        }
        return out

    @staticmethod
    def _serving_useful_tokens():
        """Serving-side useful-token fraction from the registry: tokens
        computed minus tokens thrown away by progress resets
        (step-error requeues, pool preemptions). Families absent (no
        engine in this process) read as disabled."""
        from dlrover_tpu_torch.observability.registry import default_registry

        reg = default_registry()
        tokens = reg.get("serving_tokens_total")
        if tokens is None:
            return {"enabled": False}
        by_kind = {
            labels.get("kind", ""): value
            for _, labels, value in tokens.samples()
        }
        total = sum(by_kind.values())
        wasted_fam = reg.get("serving_tokens_wasted_total")
        wasted = {}
        if wasted_fam is not None:
            wasted = {
                labels.get("kind", ""): value
                for _, labels, value in wasted_fam.samples()
            }
        wasted_total = sum(wasted.values())
        return {
            "enabled": True,
            "tokens_total": total,
            "tokens_by_kind": by_kind,
            "tokens_wasted_total": wasted_total,
            "tokens_wasted_by_kind": wasted,
            "useful_token_frac": round(
                (total - wasted_total) / total, 6
            ) if total > 0 else None,
        }

    def _phases(self):
        records = getattr(self._perf_monitor, "phase_records", None)
        if callable(records):
            return records()
        return {"init_time": 0.0, "max_phase_end": 0.0, "records": []}

    def _stragglers(self):
        report = getattr(self._perf_monitor, "straggler_report", None)
        if callable(report):
            return report()
        return {"ranks": {}, "stragglers": [], "median_step_time_s": 0.0}

    def _autoscaler_state(self, path: str = "/api/autoscaler"):
        if self._autoscaler is None:
            return {"enabled": False}
        query = urllib.parse.parse_qs(
            urllib.parse.urlparse(path).query
        )

        def q_int(name, default):
            try:
                return max(int(query[name][0]), 0)
            except (KeyError, ValueError, IndexError):
                return default

        compact = (
            query.get("signals", [""])[0] == "compact"
            or query.get("compact", ["0"])[0] in ("1", "true")
        )
        try:
            return self._autoscaler.api_state(
                last=q_int("last", 50),
                offset=q_int("offset", 0),
                compact=compact,
            )
        except Exception as e:  # noqa: BLE001 — dashboard never 500s
            return {"enabled": True, "error": f"{type(e).__name__}: {e}"}

    def _traces(self, path: str):
        """``/api/traces`` -> recent trace summaries (+ the
        aggregator's occupancy/drop accounting — a trace view that
        hides its own losses overstates coverage);
        ``/api/traces/<trace_id>`` -> that trace's nested span tree."""
        agg = self._trace_aggregator
        if agg is None:
            return {"traces": [], "enabled": False}
        tail = path[len("/api/traces"):].strip("/")
        if tail:
            return {"trace_id": tail, "tree": agg.tree(tail)}
        return {
            "traces": agg.recent(),
            "enabled": True,
            "stats": agg.stats(),
        }

    def _control_plane_state(self):
        if self._control_plane is None:
            return {"enabled": False}
        state = self._control_plane()
        state["enabled"] = True
        return state

    def _metrics_text(self):
        from dlrover_tpu_torch.observability.prom import master_metrics_text

        return master_metrics_text(
            perf_monitor=self._perf_monitor,
            metric_context=self._metric_context,
        )

    def _nodes(self):
        all_nodes = self._all_nodes()
        now = time.time()
        rows = []
        for node in sorted(
            all_nodes, key=lambda n: (n.type, n.rank_index, n.id)
        ):
            rows.append(
                {
                    "id": node.id,
                    "type": node.type,
                    "rank": node.rank_index,
                    "node_group": node.node_group,
                    "status": node.status,
                    "relaunch_count": node.relaunch_count,
                    "exit_reason": node.exit_reason,
                    "exit_history": list(node.exit_history),
                    "heartbeat_age_s": (
                        round(now - node.heartbeat_time)
                        if node.heartbeat_time > 0
                        else None
                    ),
                    "host": node.host_name,
                }
            )
        return rows

    def _all_nodes(self):
        managers = getattr(self._job_manager, "role_managers", None)
        if managers is None:
            worker = getattr(self._job_manager, "worker_manager", None)
            if worker is None:
                return []
            managers = {"worker": worker}
        all_nodes = []
        for manager in managers.values():
            all_nodes.extend(manager.nodes.values())
        return all_nodes

    def _node_detail(self, key: str):
        """Everything the master knows about one node ("type-id" key or
        bare id) — the drill-down an SRE reads during an incident
        (reference dashboard node_detail.html)."""
        for node in self._all_nodes():
            # Unambiguous keys only: a bare numeric id collides across
            # roles in multi-role jobs (actor-3 vs rollout-3).
            if key in (f"{node.type}-{node.id}", node.name):
                now = time.time()
                return {
                    "id": node.id,
                    "name": node.name,
                    "type": node.type,
                    "rank": node.rank_index,
                    "node_group": node.node_group,
                    "status": node.status,
                    "reported_status": node.reported_status,
                    "host": node.host_name,
                    "host_ip": node.host_ip,
                    "critical": node.critical,
                    "relaunch_count": node.relaunch_count,
                    "max_relaunch_count": node.max_relaunch_count,
                    "relaunchable": node.relaunchable,
                    "exit_reason": node.exit_reason,
                    "exit_history": list(node.exit_history),
                    "unrecoverable": node.is_unrecoverable_failure(),
                    "heartbeat_age_s": (
                        round(now - node.heartbeat_time)
                        if node.heartbeat_time > 0
                        else None
                    ),
                    "create_time": node.create_time,
                    "start_time": node.start_time,
                    "finish_time": node.finish_time,
                    "timeline": [
                        {"ts": ts, "status": status}
                        for ts, status in getattr(
                            node, "status_history", []
                        )
                    ],
                    "resource": {
                        "cpu": node.config_resource.cpu,
                        "memory_mb": node.config_resource.memory_mb,
                        "tpu_chips": node.config_resource.tpu_chips,
                        "used_cpu": node.used_resource.cpu,
                        "used_memory_mb": node.used_resource.memory_mb,
                    },
                }
        return None

    def _rdzv(self):
        rows = []
        for name, mgr in self._rdzv_managers.items():
            rows.append(
                {
                    "name": name,
                    "round": getattr(mgr, "_rdzv_round", 0),
                    "waiting": mgr.num_nodes_waiting(),
                    "world_size": len(getattr(mgr, "_latest_world", {})),
                }
            )
        return rows

    def _datasets(self):
        if self._task_manager is None:
            return []
        rows = []
        with self._task_manager._lock:  # noqa: SLF001 - read-only view
            datasets = dict(self._task_manager._datasets)  # noqa: SLF001
        for name, mgr in datasets.items():
            rows.append(
                {
                    "name": name,
                    "todo": len(mgr.todo),
                    "doing": len(mgr.doing),
                    "completed": getattr(mgr, "_completed_count", 0),
                    "records_done": (
                        mgr.completed_records()
                        if hasattr(mgr, "completed_records")
                        else 0
                    ),
                }
            )
        return rows

    def start(self):
        # Bind lazily and degrade gracefully: a taken port must not take
        # down the master for a monitoring-only feature.
        try:
            self._server = ThreadingHTTPServer(
                ("0.0.0.0", self._requested_port), self._make_handler()
            )
        except OSError as e:
            logger.error(
                "dashboard disabled: cannot bind port %d (%s)",
                self._requested_port,
                e,
            )
            return
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="dashboard",
            daemon=True,
        )
        self._thread.start()
        logger.info("dashboard on port %d", self.port)

    def stop(self):
        if self._server is None:
            return
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
