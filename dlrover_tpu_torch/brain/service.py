"""Brain service: cluster-level stats store + resource optimization.

Parity: reference dlrover/go/brain (gRPC ``optimize`` /
``persist_metrics``, MySQL datastore, optimizer plugins) — re-scoped to
a lightweight HTTP service with a JSON-file datastore: masters report
runtime samples and job completions; ``optimize`` answers with a worker
count learned from completed jobs of the same job name (the cross-job
memory a single-job local optimizer cannot have).

The reference's admin/processor/evaluator architecture is implemented,
scaled to single-service size:

- **datastore**: ``--store jsonl`` (self-compacting JSON-lines) or
  ``--store sqlite`` (persistent DB with indexed job/time filtering —
  the MySQL analogue). Both apply record-count and age retention.
- **optimizer plugins**: ``--optimizer`` picks ``speedup`` (best
  cost-adjusted throughput), ``marginal-gain`` (largest worker count
  still scaling efficiently), or an external ``pkg.module:factory``.
- **evaluators** (brain/evaluators.py): throughput-trend, straggler
  dispersion, and OOM-risk assessments run by the OptimizeProcessor on
  every ``/optimize`` and returned alongside the plan; pluggable the
  same way via ``--evaluators``.
- **admin**: GET ``/admin/jobs`` (known jobs + record counts),
  ``/admin/store`` (backend + retention stats), ``/admin/evaluators``.

Run: ``python -m dlrover_tpu_torch.brain.service --port 8600 --data_dir /var/brain``

The port's copy of ``dlrover_tpu/brain/service.py``.
"""

import argparse
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger


class BrainStore:
    """JSON-lines store of job samples and completions, with retention:
    every ``compact_every`` appends (and at startup) each file is
    rewritten keeping the newest ``max_records`` that are younger than
    ``max_age_s`` — a brain that only ever grows eventually optimizes
    from dead history and fills the disk."""

    def __init__(
        self,
        data_dir: str,
        max_records: int = 10_000,
        max_age_s: float = 30 * 24 * 3600.0,
        compact_every: int = 500,
    ):
        self._dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._max_records = max_records
        self._max_age_s = max_age_s
        self._compact_every = max(compact_every, 1)
        self._appends: Dict[str, int] = {}
        for kind in ("runtime", "completion"):
            self.compact(kind)

    def compact(self, kind: str):
        """Rewrite the file applying retention (atomic replace)."""

        def ts_of(record) -> float:
            # Same junk tolerance as load(): a foreign writer's bad ts
            # must not brick service start (compact runs in __init__).
            try:
                return float(record.get("ts", 0))
            except (TypeError, ValueError):
                return 0.0

        with self._lock:
            records = self._load_unlocked(kind)
            cutoff = time.time() - self._max_age_s
            fresh = [r for r in records if ts_of(r) >= cutoff]
            # max_records <= 0 means NO count cap (age still applies) —
            # the naive [-0:] slice would keep everything, while [] here
            # would irreversibly wipe the store at startup.
            kept = (
                fresh[-self._max_records:]
                if self._max_records > 0
                else fresh
            )
            if len(kept) == len(records):
                return
            path = self._path(kind)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                for r in kept:
                    f.write(json.dumps(r) + "\n")
            os.replace(tmp, path)
            logger.info(
                "brain store %s compacted: %d -> %d records",
                kind, len(records), len(kept),
            )

    def _path(self, kind: str) -> str:
        return os.path.join(self._dir, f"{kind}.jsonl")

    def append(self, kind: str, record: Dict):
        record = dict(record)
        record["ts"] = time.time()
        path = self._path(kind)
        with self._lock:
            # A crash mid-append can leave a torn final line; appending
            # straight after it would merge (and lose) this record too.
            needs_newline = False
            try:
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    if f.tell() > 0:
                        f.seek(-1, os.SEEK_END)
                        needs_newline = f.read(1) != b"\n"
            except OSError:
                pass
            with open(path, "a") as f:
                if needs_newline:
                    f.write("\n")
                f.write(json.dumps(record) + "\n")
            self._appends[kind] = self._appends.get(kind, 0) + 1
            due = self._appends[kind] % self._compact_every == 0
        if due:
            self.compact(kind)

    def load(self, kind: str, job_name: Optional[str] = None) -> List[Dict]:
        with self._lock:
            records = self._load_unlocked(kind)
        if job_name is None:
            return records
        return [r for r in records if r.get("job_name") == job_name]

    def stats(self) -> Dict:
        return {
            "backend": "jsonl",
            "dir": self._dir,
            "records": {
                kind: len(self.load(kind))
                for kind in ("runtime", "completion")
            },
            "max_records": self._max_records,
            "max_age_s": self._max_age_s,
        }

    def job_names(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for kind in ("runtime", "completion"):
            for r in self.load(kind):
                name = r.get("job_name")
                if name:
                    counts[name] = counts.get(name, 0) + 1
        return counts

    def close(self):
        pass

    def _load_unlocked(self, kind: str) -> List[Dict]:
        records = []
        try:
            with open(self._path(kind)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        record = json.loads(line)
                    except ValueError:
                        continue  # torn line from a crash mid-append
                    if isinstance(record, dict):
                        records.append(record)
        except OSError:
            pass
        return records


class SqliteBrainStore:
    """Persistent-DB datastore (reference go/brain rides MySQL; sqlite
    is the stdlib equivalent for this scale): same interface as the
    JSONL store, but filtering happens in SQL over an indexed table and
    retention is a DELETE, not a file rewrite. Select with
    ``--store sqlite``."""

    def __init__(
        self,
        data_dir: str,
        max_records: int = 10_000,
        max_age_s: float = 30 * 24 * 3600.0,
        compact_every: int = 500,
    ):
        import sqlite3

        os.makedirs(data_dir, exist_ok=True)
        self._dir = data_dir
        self._path = os.path.join(data_dir, "brain.sqlite")
        self._max_records = max_records
        self._max_age_s = max_age_s
        self._compact_every = max(compact_every, 1)
        self._appends = 0
        self._lock = threading.Lock()
        self._db = sqlite3.connect(self._path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS metrics ("
            " id INTEGER PRIMARY KEY AUTOINCREMENT,"
            " kind TEXT NOT NULL, job_name TEXT, ts REAL NOT NULL,"
            " record TEXT NOT NULL)"
        )
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS idx_metrics "
            "ON metrics (kind, job_name, ts)"
        )
        self._db.commit()
        self.compact()

    def append(self, kind: str, record: Dict):
        record = dict(record)
        record["ts"] = time.time()
        with self._lock:
            self._db.execute(
                "INSERT INTO metrics (kind, job_name, ts, record) "
                "VALUES (?, ?, ?, ?)",
                (
                    kind,
                    record.get("job_name"),
                    record["ts"],
                    json.dumps(record),
                ),
            )
            self._db.commit()
            self._appends += 1
            due = self._appends % self._compact_every == 0
        if due:
            self.compact()

    def load(self, kind: str, job_name: Optional[str] = None) -> List[Dict]:
        q = "SELECT record FROM metrics WHERE kind = ?"
        args: list = [kind]
        if job_name is not None:
            q += " AND job_name = ?"
            args.append(job_name)
        q += " ORDER BY ts, id"  # id tiebreak: same-tick appends
        with self._lock:
            rows = self._db.execute(q, args).fetchall()
        out = []
        for (blob,) in rows:
            try:
                record = json.loads(blob)
            except ValueError:
                continue
            if isinstance(record, dict):
                out.append(record)
        return out

    def compact(self, kind: Optional[str] = None):
        with self._lock:
            cutoff = time.time() - self._max_age_s
            self._db.execute("DELETE FROM metrics WHERE ts < ?", (cutoff,))
            if self._max_records > 0:
                for k in ("runtime", "completion"):
                    self._db.execute(
                        "DELETE FROM metrics WHERE kind = ? AND id NOT IN"
                        " (SELECT id FROM metrics WHERE kind = ?"
                        "  ORDER BY ts DESC, id DESC LIMIT ?)",
                        (k, k, self._max_records),
                    )
            self._db.commit()

    def stats(self) -> Dict:
        with self._lock:
            rows = self._db.execute(
                "SELECT kind, COUNT(*) FROM metrics GROUP BY kind"
            ).fetchall()
        return {
            "backend": "sqlite",
            "path": self._path,
            "records": {k: n for k, n in rows},
            "max_records": self._max_records,
            "max_age_s": self._max_age_s,
        }

    def job_names(self) -> Dict[str, int]:
        with self._lock:
            rows = self._db.execute(
                "SELECT job_name, COUNT(*) FROM metrics "
                "WHERE job_name IS NOT NULL AND job_name != '' "
                "GROUP BY job_name"
            ).fetchall()
        return {k: n for k, n in rows}

    def close(self):
        with self._lock:
            self._db.close()


STORES = {"jsonl": BrainStore, "sqlite": SqliteBrainStore}


def _job_samples(store: BrainStore, job_name: str):
    samples = []
    for s in store.load("runtime", job_name=job_name):
        try:
            speed = float(s.get("speed", 0))
            count = int(s.get("worker_count", 0))
        except (TypeError, ValueError):
            continue  # records are caller-supplied; skip junk
        if speed > 0 and count > 0:
            samples.append((count, speed))
    return samples


def _mean_speed_by_count(samples) -> Dict[int, float]:
    by_count: Dict[int, List[float]] = {}
    for count, speed in samples:
        by_count.setdefault(count, []).append(speed)
    return {c: sum(v) / len(v) for c, v in by_count.items()}


class SpeedupOptimizer:
    """Cross-job heuristic: among past runs of this job name, prefer the
    worker count with the best observed speed-per-worker (cost-adjusted
    throughput)."""

    def __init__(self, store: BrainStore):
        self._store = store

    def optimize(self, job_name: str) -> Optional[Dict]:
        samples = _job_samples(self._store, job_name)
        if not samples:
            return None
        best_count, best_value = 0, -1.0
        for count, mean in _mean_speed_by_count(samples).items():
            value = mean / count
            if value > best_value:
                best_count, best_value = count, value
        if best_count <= 0:
            return None
        return {
            "worker_count": best_count,
            "evidence_samples": len(samples),
            "optimizer": "speedup",
        }


class MarginalGainOptimizer:
    """Scaling-efficiency heuristic: walk observed worker counts in
    ascending order and keep growing while each scale-up still delivered
    at least ``efficiency`` of its proportional throughput gain —
    answers "how far did this job USEFULLY scale", where speedup answers
    "where was it cheapest"."""

    def __init__(self, store: BrainStore, efficiency: float = 0.7):
        self._store = store
        self._efficiency = efficiency

    def optimize(self, job_name: str) -> Optional[Dict]:
        samples = _job_samples(self._store, job_name)
        if not samples:
            return None
        means = sorted(_mean_speed_by_count(samples).items())
        best_count = means[0][0]
        prev_count, prev_speed = means[0]
        for count, speed in means[1:]:
            ideal = prev_speed * count / prev_count
            if speed >= self._efficiency * ideal:
                best_count = count
                prev_count, prev_speed = count, speed
            else:
                break
        return {
            "worker_count": best_count,
            "evidence_samples": len(samples),
            "optimizer": "marginal-gain",
        }


# Back-compat alias: the original single algorithm.
BrainOptimizer = SpeedupOptimizer

OPTIMIZERS = {
    "speedup": SpeedupOptimizer,
    "marginal-gain": MarginalGainOptimizer,
}


def create_optimizer(name: str, store: BrainStore):
    """Resolve an optimizer: a registry name or an external
    ``pkg.module:factory`` dotted path (the plugin contract — factory
    takes the store, returns an object with ``optimize(job_name)``)."""
    from dlrover_tpu_torch.brain.evaluators import load_plugin

    return load_plugin(name, OPTIMIZERS, store, "optimizer")


class BrainService:
    def __init__(
        self,
        port: int = 0,
        data_dir: str = "/tmp/dlrover_brain",
        optimizer: str = "speedup",
        max_records: int = 10_000,
        max_age_s: float = 30 * 24 * 3600.0,
        store: str = "jsonl",
        evaluators: Optional[List[str]] = None,
    ):
        from dlrover_tpu_torch.brain.evaluators import (
            EVALUATORS,
            OptimizeProcessor,
            create_evaluator,
        )

        if store not in STORES:
            raise ValueError(
                f"unknown store {store!r}; options: {sorted(STORES)}"
            )
        self.store = STORES[store](
            data_dir, max_records=max_records, max_age_s=max_age_s
        )
        self.optimizer = create_optimizer(optimizer, self.store)
        names = (
            evaluators if evaluators is not None
            else sorted(EVALUATORS)
        )
        self.processor = OptimizeProcessor(
            self.optimizer,
            [create_evaluator(n, self.store) for n in names],
            store=self.store,
        )
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._server = ThreadingHTTPServer(
            ("0.0.0.0", port), self._make_handler()
        )
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _make_handler(self):
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def handle(self):
                # In-flight accounting: ThreadingHTTPServer's handler
                # threads are DAEMON threads (server_close joins
                # nothing), so stop() must wait for this count to drain
                # before closing the store under a live handler.
                with service._inflight_cv:
                    service._inflight += 1
                try:
                    super().handle()
                finally:
                    with service._inflight_cv:
                        service._inflight -= 1
                        service._inflight_cv.notify_all()

            def _json(self, code: int, payload):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    self._json(400, {"error": "bad json"})
                    return
                if self.path == "/persist_metrics":
                    kind = body.get("kind", "runtime")
                    if kind not in ("runtime", "completion"):
                        self._json(400, {"error": f"bad kind {kind}"})
                        return
                    service.store.append(kind, body.get("record", {}))
                    self._json(200, {"ok": True})
                elif self.path == "/optimize":
                    # Full processor response: the optimizer's plan
                    # plus every evaluator's assessment ("plan" key
                    # unchanged for existing clients).
                    self._json(
                        200,
                        service.processor.process(
                            body.get("job_name", "")
                        ),
                    )
                else:
                    self._json(404, {"error": "not found"})

            def do_GET(self):
                # Admin surface (reference brain admin service).
                if self.path == "/admin/jobs":
                    self._json(200, {"jobs": service.store.job_names()})
                elif self.path == "/admin/store":
                    self._json(200, service.store.stats())
                elif self.path == "/admin/evaluators":
                    self._json(200, {
                        "optimizer": type(service.optimizer).__name__,
                        "evaluators":
                            service.processor.evaluator_names,
                    })
                else:
                    self._json(404, {"error": "not found"})

        return Handler

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="brain", daemon=True
        )
        self._thread.start()
        logger.info("brain service on port %d", self.port)

    def stop(self):
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        # Handler threads are daemons (server_close joins nothing);
        # wait for in-flight requests to drain before closing the store
        # under them.
        with self._inflight_cv:
            self._inflight_cv.wait_for(
                lambda: self._inflight == 0, timeout=10.0
            )
        self.store.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="dlrover-tpu brain")
    parser.add_argument("--port", type=int, default=8600)
    parser.add_argument("--data_dir", type=str, default="/tmp/dlrover_brain")
    parser.add_argument(
        "--optimizer", type=str,
        default=os.getenv("DLROVER_TPU_BRAIN_OPTIMIZER", "speedup"),
        help="registry name (speedup, marginal-gain) or pkg.module:factory",
    )
    parser.add_argument("--max_records", type=int, default=10_000)
    parser.add_argument(
        "--max_age_days", type=float, default=30.0,
        help="retention window for the store",
    )
    parser.add_argument(
        "--store", type=str, default="jsonl",
        choices=sorted(STORES),
        help="datastore backend (sqlite = the reference's persistent DB)",
    )
    parser.add_argument(
        "--evaluators", type=str, default=None,
        help="comma-separated evaluator names or pkg.module:factory "
        'paths; omit for all built-ins, pass "" to disable evaluators',
    )
    args = parser.parse_args(argv)
    service = BrainService(
        args.port,
        args.data_dir,
        optimizer=args.optimizer,
        max_records=args.max_records,
        max_age_s=args.max_age_days * 24 * 3600.0,
        store=args.store,
        evaluators=(
            None if args.evaluators is None
            else [
                e.strip() for e in args.evaluators.split(",")
                if e.strip()
            ]
        ),
    )
    service.start()
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
