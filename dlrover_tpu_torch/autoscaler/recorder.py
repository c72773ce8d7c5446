"""SignalRecorder: durable, replayable stream of everything the loop saw.

The §30 autoscaler already keeps a bounded in-memory DecisionLedger;
this module makes the *signal stream itself* durable so a recorded run
can be replayed offline through a candidate policy (``replay.py``) —
the measurement half of the ROADMAP's learned-resource-brain item.

Format: schema-versioned JSONL, one record per line, four kinds —

- ``header``  — schema version, pid, wall+mono clock anchor;
- ``policy``  — the PolicyConfig the live loop ran (``dataclasses
  .asdict``), re-emitted after every rotation so each file is
  self-describing;
- ``snapshot`` — one SignalBus sample (seq + ``wall``/``mono``
  timestamp PAIR + the flat values dict);
- ``decision`` / ``outcome`` — ledger entries and their realized-effect
  backfills, keyed by ledger seq.

Every record carries a ``(wall, mono)`` timestamp pair: wall time is
what the clockless policy rules consume (and what humans read), the
monotonic stamp is what :func:`load_recording` ORDERS by — an NTP step
mid-run must not reorder a recording (satellite: no bare
``time.time()`` ordering anywhere in the replay path).

Durability borrows the fault-trace discipline (``fault/registry.py``):
each record is flushed and — by default — fsync'd as it is written, so
a SIGKILL'd run's recording replays up to the instant of death; a torn
final line is tolerated (and counted) by the reader. Rotation keeps the
recording bounded: past ``max_bytes`` the live file rotates to
``<path>.1`` (older generations shift up, the oldest beyond
``max_files`` is deleted) and the reader stitches the chain back
together oldest-first.

Subprocess workers arm from the environment the same way the fault
plane does: ``DLROVER_TPU_AUTOSCALE_RECORD=<path>`` (plus
``DLROVER_TPU_AUTOSCALE_RECORD_FSYNC=0`` to trade durability for
throughput), via :func:`recorder_from_env`.

The port's copy of ``dlrover_tpu/autoscaler/recorder.py``: the same
schema, so a recording that either package writes loads and replays in
the other.
"""

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.autoscaler.signals import SignalSnapshot
from dlrover_tpu_torch.common.log import logger

SCHEMA_VERSION = 1

RECORD_ENV = "DLROVER_TPU_AUTOSCALE_RECORD"
RECORD_FSYNC_ENV = "DLROVER_TPU_AUTOSCALE_RECORD_FSYNC"


class SignalRecorder:
    """Append-only JSONL writer for the autoscaler's signal/decision
    stream. Thread-safe; bounded by rotation; fsync-per-record by
    default so SIGKILL runs stay replayable."""

    def __init__(
        self,
        path: str,
        fsync: bool = True,
        max_bytes: int = 16 << 20,
        max_files: int = 3,
    ):
        self._path = path
        self._fsync = fsync
        self._max_bytes = max(int(max_bytes), 4096)
        self._max_files = max(int(max_files), 1)
        self._lock = threading.Lock()
        self._policy_record: Optional[Dict] = None
        self._records_written = 0
        self._rotations = 0
        self._closed = False
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")
        self._emit(self._header())

    # ---- record kinds ------------------------------------------------------

    def _header(self) -> Dict:
        return {
            "kind": "header",
            "v": SCHEMA_VERSION,
            "pid": os.getpid(),
            "wall": time.time(),
            "mono": time.monotonic(),
            # Rotation ordinal: when the oldest surviving file's header
            # carries rotation > 0, the stream's beginning was deleted
            # by the bound — the reader marks the recording truncated
            # (replay identity cannot be asserted from mid-stream).
            "rotation": self._rotations,
        }

    def record_policy(self, config: Dict):
        """The PolicyConfig the live loop runs — the replay identity
        invariant replays THIS config against the snapshots. Cached so
        rotation re-emits it into every file."""
        rec = {"kind": "policy", "v": SCHEMA_VERSION, "config": dict(config)}
        with self._lock:
            self._policy_record = rec
            self._write_locked(rec)

    def record_snapshot(self, snap: SignalSnapshot):
        self._emit({
            "kind": "snapshot",
            "v": SCHEMA_VERSION,
            "seq": snap.seq,
            "wall": snap.ts,
            "mono": snap.mono,
            "values": snap.values,
        })

    def record_decision(self, decision) -> None:
        """One ledger entry, AFTER actuation so ``outcome`` carries the
        actuation result (actuated/dry_run/advisory/error:<why>)."""
        rec = {"kind": "decision", "v": SCHEMA_VERSION}
        rec.update(decision.to_dict())
        self._emit(rec)

    def record_outcome(self, decision_seq: int, realized: Dict):
        self._emit({
            "kind": "outcome",
            "v": SCHEMA_VERSION,
            "decision_seq": decision_seq,
            "wall": time.time(),
            "mono": time.monotonic(),
            "realized": dict(realized),
        })

    # ---- plumbing ----------------------------------------------------------

    def _emit(self, rec: Dict):
        with self._lock:
            self._write_locked(rec)

    def _write_locked(self, rec: Dict):
        if self._closed:
            return
        line = json.dumps(rec, default=str)
        # Recording must never kill the loop: a failed rotation can
        # leave the handle closed (tell() then raises ValueError, not
        # OSError), so both are caught and a reopen is attempted —
        # degraded-but-writing beats a recorder that poisons every
        # subsequent tick.
        try:
            if self._f.closed:
                self._f = open(self._path, "a")
            if self._f.tell() + len(line) + 1 > self._max_bytes:
                self._rotate_locked()
            self._f.write(line + "\n")
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
            self._records_written += 1
        except (OSError, ValueError) as e:
            logger.warning("signal recorder write failed: %s", e)

    def _rotate_locked(self):
        self._f.close()
        try:
            # Shift generations up; the one past the bound is deleted.
            oldest = f"{self._path}.{self._max_files - 1}"
            if os.path.exists(oldest):
                os.unlink(oldest)
            for i in range(self._max_files - 2, 0, -1):
                src = f"{self._path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self._path}.{i + 1}")
            if self._max_files > 1:
                os.replace(self._path, f"{self._path}.1")
            else:
                os.unlink(self._path)
        finally:
            # Whatever the shuffle did, leave an OPEN handle behind: a
            # half-rotated chain still records (and retries rotation on
            # the next oversize write).
            self._f = open(self._path, "a")
        self._rotations += 1
        # Each file is self-describing: fresh header + the live policy.
        hdr = json.dumps(self._header(), default=str)
        self._f.write(hdr + "\n")
        if self._policy_record is not None:
            self._f.write(
                json.dumps(self._policy_record, default=str) + "\n"
            )
        self._f.flush()

    def stats(self) -> Dict:
        with self._lock:
            return {
                "path": self._path,
                "records_written": self._records_written,
                "rotations": self._rotations,
                "fsync": self._fsync,
                "max_bytes": self._max_bytes,
            }

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.flush()
                if self._fsync:
                    os.fsync(self._f.fileno())
                self._f.close()
            except OSError:
                pass


def recorder_from_env() -> Optional[SignalRecorder]:
    """Arm a recorder from ``DLROVER_TPU_AUTOSCALE_RECORD`` — the
    subprocess-worker rigging, mirroring the fault plane's env arming.
    Returns None when the env var is unset."""
    path = os.getenv(RECORD_ENV, "")
    if not path:
        return None
    fsync = os.getenv(RECORD_FSYNC_ENV, "1") != "0"
    return SignalRecorder(path, fsync=fsync)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


@dataclass
class Recording:
    """A loaded recording: snapshots ordered by the MONOTONIC stamp
    (wall-clock steps cannot reorder them), the recorded policy config,
    the decision stream, and outcome backfills keyed by decision seq."""

    schema_version: int = SCHEMA_VERSION
    policy_config: Optional[Dict] = None
    snapshots: List[SignalSnapshot] = field(default_factory=list)
    decisions: List[Dict] = field(default_factory=list)
    outcomes: Dict[int, Dict] = field(default_factory=dict)
    files: List[str] = field(default_factory=list)
    corrupt_lines: int = 0
    headers: List[Dict] = field(default_factory=list)
    # True when the rotation bound deleted the stream's beginning:
    # policy state accrued in the deleted era is unknowable, so the
    # replay identity invariant cannot be asserted (ranking still can).
    truncated: bool = False
    # Earlier writer incarnations found in the same path (a restarted
    # master appends): the loader keeps only the NEWEST run — mixing
    # runs would interleave reset monotonic clocks and stale policy
    # state into one stream and fail identity with a bogus divergence.
    previous_runs: int = 0


def _recording_chain(path: str, max_files: int = 64) -> List[str]:
    """Rotation chain oldest-first: <path>.N ... <path>.1, <path>."""
    chain = []
    for i in range(max_files, 0, -1):
        gen = f"{path}.{i}"
        if os.path.exists(gen):
            chain.append(gen)
    if os.path.exists(path):
        chain.append(path)
    return chain


def load_recording(path: str) -> Recording:
    """Parse a recording (and its rotated generations). A torn final
    line — the SIGKILL case the fsync discipline exists for — is
    skipped and counted, never fatal; an unknown FUTURE schema version
    raises (old readers must not silently misparse new streams). A
    rotation-0 header marks a fresh writer incarnation (a restarted
    master appending to the same path): each one RESETS the stream so
    only the newest run is returned (``previous_runs`` counts the
    discarded ones) — runs must not interleave, their monotonic clocks
    restart from boot."""
    rec = Recording()
    rec.files = _recording_chain(path)
    if not rec.files:
        raise FileNotFoundError(f"no recording at {path}")
    for file_path in rec.files:
        with open(file_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    rec.corrupt_lines += 1
                    continue
                kind = obj.get("kind")
                version = int(obj.get("v", 0))
                if version > SCHEMA_VERSION:
                    raise ValueError(
                        f"recording schema v{version} is newer than "
                        f"this reader (v{SCHEMA_VERSION}): {file_path}"
                    )
                if kind == "header":
                    if (int(obj.get("rotation", 0)) == 0
                            and rec.headers):
                        # A fresh incarnation: drop everything the
                        # previous run wrote and start over — including
                        # its torn-line count, which must not indict
                        # the clean newest run.
                        rec.previous_runs += 1
                        rec.headers = []
                        rec.policy_config = None
                        rec.snapshots = []
                        rec.decisions = []
                        rec.outcomes = {}
                        rec.corrupt_lines = 0
                    rec.headers.append(obj)
                elif kind == "policy":
                    rec.policy_config = obj.get("config") or {}
                elif kind == "snapshot":
                    rec.snapshots.append(SignalSnapshot(
                        seq=int(obj.get("seq", 0)),
                        ts=float(obj.get("wall", 0.0)),
                        mono=float(obj.get("mono", 0.0)),
                        values=obj.get("values") or {},
                    ))
                elif kind == "outcome":
                    rec.outcomes[int(obj.get("decision_seq", 0))] = (
                        obj.get("realized") or {}
                    )
                elif kind == "decision":
                    rec.decisions.append(obj)
    if rec.headers:
        rec.truncated = min(
            int(h.get("rotation", 0)) for h in rec.headers
        ) > 0
    # Monotonic order is the replay order: a wall-clock step (NTP slew)
    # mid-run must not reorder the stream. Seq breaks mono ties.
    rec.snapshots.sort(key=lambda s: (s.mono, s.seq))
    rec.decisions.sort(
        key=lambda d: (float(d.get("mono", 0.0)), int(d.get("seq", 0)))
    )
    return rec
