"""Clock-aligned job timeline merger (the port's copy of
``dlrover_tpu/observability/trace_merge.py``).

Fuses every timing artifact one job produces into a single
chrome-trace/Perfetto JSON:

- training_event JSONL files (master/agent/trainer control-plane spans;
  begin/end pairs matched by event_id, instants kept as instants),
- tpu_timer chrome-trace dumps (per-rank kernel/step slices on
  CLOCK_MONOTONIC, shifted onto the epoch clock via the ``clock_sync``
  anchor ``tpu_timer/dump.py`` embeds at fetch time),
- flight-recorder dumps (per-rank step slices with data-wait /
  ckpt-blocked sub-slices),
- the master's goodput phase ledger (``PerfMonitor.phase_records()``,
  served at ``/api/phases``), rendered as a job-level phase track plus
  a running-goodput counter lane.

Everything lands on ONE clock (epoch microseconds — chrome tracing
only cares about consistency) with per-rank tracks, so "where did the
job's time go" is one file in ui.perfetto.dev. The merger also
RECONSTRUCTS goodput from the phase records it rendered and reports it
in the metadata, so the timeline can be cross-checked against the
live ``PerfMonitor.goodput()`` number — if they diverge, the trace is
lying and the bug is here.
"""

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import GoodputPhase

# Track (pid) allocation: ranks keep their own number, control-plane
# lanes live far above any plausible rank count.
JOB_PID = 9000
TARGET_PIDS = {"master": 9001, "agent": 9002, "trainer": 9003}
_EXTRA_TARGET_BASE = 9010

# Monotonic microseconds-since-boot never reach this; epoch
# microseconds passed it in 1973.
_EPOCH_US_FLOOR = 1e14


def _meta(pid: int, name: str) -> Dict:
    return {
        "ph": "M",
        "pid": pid,
        "name": "process_name",
        "args": {"name": name},
    }


# ---------------------------------------------------------------------------
# training_event JSONL -> control-plane spans
# ---------------------------------------------------------------------------


def load_events_jsonl(paths: Iterable[str]) -> List[Dict]:
    events: List[Dict] = []
    for path in paths:
        try:
            with open(path, errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(ev, dict) and "name" in ev:
                        events.append(ev)
        except OSError:
            continue
    return events


def _target_pid(target: str, extra: Dict[str, int]) -> int:
    base = (target or "unknown").split("/", 1)[0]
    if base in TARGET_PIDS:
        return TARGET_PIDS[base]
    if base not in extra:
        extra[base] = _EXTRA_TARGET_BASE + len(extra)
    return extra[base]


def events_to_trace(events: List[Dict]) -> List[Dict]:
    """Chrome events from training_event records. Begin/end pairs with
    a shared event_id become one X slice; an unmatched end still yields
    a slice when it carries duration_s; instants become ph="i"."""
    extra_targets: Dict[str, int] = {}
    out: List[Dict] = []
    open_begins: Dict[str, Dict] = {}
    seen_pids: Dict[int, str] = {}

    def pid_of(ev: Dict) -> int:
        target = str(ev.get("target", ""))
        pid = _target_pid(target, extra_targets)
        seen_pids.setdefault(pid, target.split("/", 1)[0] or "unknown")
        return pid

    for ev in sorted(events, key=lambda e: float(e.get("ts", 0.0))):
        etype = ev.get("type", "instant")
        ts_us = float(ev.get("ts", 0.0)) * 1e6
        pid = pid_of(ev)
        tid = int(ev.get("pid", 0))
        if etype == "begin" and ev.get("event_id"):
            open_begins[ev["event_id"]] = ev
            continue
        if etype == "end":
            begin = open_begins.pop(ev.get("event_id", ""), None)
            content = ev.get("content") or {}
            if begin is not None:
                start_us = float(begin.get("ts", 0.0)) * 1e6
                dur_us = max(ts_us - start_us, 0.0)
            elif "duration_s" in content:
                dur_us = float(content["duration_s"]) * 1e6
                start_us = ts_us - dur_us
            else:
                start_us, dur_us = ts_us, 0.0
            out.append(
                {
                    "name": ev.get("name", ""),
                    "ph": "X",
                    "ts": start_us,
                    "dur": dur_us,
                    "pid": pid,
                    "tid": tid,
                    "args": content,
                }
            )
            continue
        out.append(
            {
                "name": ev.get("name", ""),
                "ph": "i",
                "ts": ts_us,
                "pid": pid,
                "tid": tid,
                "s": "t",
                "args": ev.get("content") or {},
            }
        )
    # A begin whose end never arrived (worker died mid-span) is itself
    # a signal: emit it as a zero-duration slice flagged unfinished.
    for ev in open_begins.values():
        out.append(
            {
                "name": f"{ev.get('name', '')} (unfinished)",
                "ph": "X",
                "ts": float(ev.get("ts", 0.0)) * 1e6,
                "dur": 0.0,
                "pid": pid_of(ev),
                "tid": int(ev.get("pid", 0)),
                "args": ev.get("content") or {},
            }
        )
    metas = [_meta(pid, name) for pid, name in sorted(seen_pids.items())]
    return metas + out


# ---------------------------------------------------------------------------
# tpu_timer chrome traces -> aligned kernel slices
# ---------------------------------------------------------------------------


def align_trace_events(
    trace: Dict, rank: int
) -> Tuple[List[Dict], Optional[float]]:
    """Shift a tpu_timer trace onto the epoch clock; returns (events,
    offset_us or None when the trace had no anchor and is left on its
    own clock for the caller to place)."""
    events = [
        e
        for e in trace.get("traceEvents", [])
        if e.get("ph") in ("X", "i", "C")
    ]
    sync = trace.get("clock_sync") or {}
    offset: Optional[float] = None
    if "epoch_minus_mono_us" in sync:
        offset = float(sync["epoch_minus_mono_us"])
    elif events:
        ts_vals = sorted(float(e.get("ts", 0.0)) for e in events)
        if ts_vals[len(ts_vals) // 2] > _EPOCH_US_FLOOR:
            offset = 0.0  # already epoch microseconds
    out = []
    for e in events:
        e2 = dict(e)
        e2["pid"] = rank
        if offset is not None:
            e2["ts"] = float(e2.get("ts", 0.0)) + offset
        out.append(e2)
    return out, offset


# ---------------------------------------------------------------------------
# flight recorder dumps -> per-rank step slices
# ---------------------------------------------------------------------------


# Flight slices get their own thread tracks on the rank's pid: kernel
# slices from the rank's tpu_timer trace keep their native tids
# (usually small ints), and same-tid X events must strictly nest for
# chrome/Perfetto — flight steps only partially overlap kernels.
FLIGHT_STEP_TID = 1001
FLIGHT_WAIT_TID = 1002


def flight_to_trace(dump: Dict, rank: int) -> List[Dict]:
    out: List[Dict] = [
        {
            "ph": "M",
            "pid": rank,
            "tid": FLIGHT_STEP_TID,
            "name": "thread_name",
            "args": {"name": "flight steps"},
        },
        {
            "ph": "M",
            "pid": rank,
            "tid": FLIGHT_WAIT_TID,
            "name": "thread_name",
            "args": {"name": "flight waits"},
        },
    ]
    for rec in dump.get("steps", []):
        end_us = float(rec.get("ts", 0.0)) * 1e6
        dur_us = max(float(rec.get("step_time_s", 0.0)), 0.0) * 1e6
        start_us = end_us - dur_us
        # Event annotations (FlightRecorder.annotate: restore, re-mesh)
        # share the ring with step records; name them by their event.
        name = rec.get("event") or f"step {rec.get('step', '?')}"
        out.append(
            {
                "name": name,
                "ph": "X",
                "ts": start_us,
                "dur": dur_us,
                "pid": rank,
                "tid": FLIGHT_STEP_TID,
                "args": {
                    k: rec[k]
                    for k in (
                        "step",
                        "data_wait_s",
                        "ckpt_block_s",
                        "rdzv_round",
                        "seconds",
                        "mb_per_s",
                    )
                    if k in rec
                },
            }
        )
        # Waits as sub-slices at the front of the step: where the step's
        # wall time went when it was not compute.
        cursor = start_us
        for key, label in (
            ("data_wait_s", "data_wait"),
            ("ckpt_block_s", "ckpt_blocked"),
        ):
            wait_us = max(float(rec.get(key, 0.0)), 0.0) * 1e6
            if wait_us <= 0:
                continue
            out.append(
                {
                    "name": label,
                    "ph": "X",
                    "ts": cursor,
                    "dur": min(wait_us, max(end_us - cursor, 0.0)),
                    "pid": rank,
                    "tid": FLIGHT_WAIT_TID,
                    "args": {},
                }
            )
            cursor += wait_us
    return out


# ---------------------------------------------------------------------------
# goodput phase ledger -> job lane + reconstruction
# ---------------------------------------------------------------------------


def phases_to_trace(phases: Dict) -> List[Dict]:
    """Job-level lane: one slice per (node, phase) interval (tid=node),
    plus a running-goodput counter sampled at every interval end."""
    records = sorted(
        phases.get("records", []), key=lambda r: float(r.get("end", 0.0))
    )
    init_time = float(phases.get("init_time", 0.0))
    out: List[Dict] = [_meta(JOB_PID, "job goodput")]
    train_per_node: Dict[int, float] = {}
    # cause -> node -> seconds: the lane renders the per-node MEAN so
    # it agrees with goodput_attribution()'s averaging basis (a 0.4s
    # lockstep pause reported by 4 nodes is 0.4s of wall, not 1.6s).
    lost_by_cause: Dict[str, Dict[int, float]] = {}
    for rec in records:
        start = float(rec.get("start", 0.0))
        end = float(rec.get("end", 0.0))
        node = int(rec.get("node_id", 0))
        phase = str(rec.get("phase", ""))
        cause = rec.get("cause")
        args: Dict = {"node_id": node}
        if cause:
            args["cause"] = cause
        out.append(
            {
                "name": phase,
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(end - start, 0.0) * 1e6,
                "pid": JOB_PID,
                "tid": node,
                "args": args,
            }
        )
        if cause:
            # §34 lost-time lane: cumulative per-node-mean seconds per
            # cause, a counter track beside the goodput one — the
            # timeline shows WHERE the lost time went as it accrues.
            per_node = lost_by_cause.setdefault(cause, {})
            per_node[node] = per_node.get(node, 0.0) + (end - start)
            out.append(
                {
                    "name": "lost_by_cause",
                    "ph": "C",
                    "ts": end * 1e6,
                    "pid": JOB_PID,
                    "args": {
                        c: round(sum(nodes.values()) / len(nodes), 6)
                        for c, nodes in sorted(lost_by_cause.items())
                    },
                }
            )
        if phase == GoodputPhase.TRAIN:
            train_per_node[node] = (
                train_per_node.get(node, 0.0) + (end - start)
            )
        if train_per_node:
            wall = max(end - init_time, 1e-9)
            ratios = [
                min(t / wall, 1.0) for t in train_per_node.values()
            ]
            out.append(
                {
                    "name": "goodput",
                    "ph": "C",
                    "ts": end * 1e6,
                    "pid": JOB_PID,
                    "args": {
                        "goodput": round(sum(ratios) / len(ratios), 6)
                    },
                }
            )
    return out


def reconstruct_goodput(phases: Dict) -> float:
    """Recompute goodput from the phase records exactly the way
    ``PerfMonitor.goodput()`` does — the merge's cross-check."""
    records = phases.get("records", [])
    init_time = float(phases.get("init_time", 0.0))
    if not records:
        return 0.0
    max_end = max(float(r.get("end", 0.0)) for r in records)
    wall = max(max_end - init_time, 1e-9)
    train_per_node: Dict[int, float] = {}
    for rec in records:
        if str(rec.get("phase", "")) != GoodputPhase.TRAIN:
            continue
        node = int(rec.get("node_id", 0))
        dur = float(rec.get("end", 0.0)) - float(rec.get("start", 0.0))
        if dur > 0:
            train_per_node[node] = train_per_node.get(node, 0.0) + dur
    if not train_per_node:
        return 0.0
    ratios = [min(t / wall, 1.0) for t in train_per_node.values()]
    return sum(ratios) / len(ratios)


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------


def merge_job_timeline(
    event_files: Iterable[str] = (),
    rank_traces: Optional[Dict[int, Dict]] = None,
    flight_dumps: Optional[Dict[int, Dict]] = None,
    phases: Optional[Dict] = None,
) -> Dict:
    """One chrome-trace dict from every signal source; see module doc."""
    merged: List[Dict] = []
    unanchored: List[Tuple[int, List[Dict]]] = []
    clock_offsets: Dict[str, Optional[float]] = {}

    ranks = set()
    for rank in sorted(rank_traces or {}):
        aligned, offset = align_trace_events(
            (rank_traces or {})[rank], rank
        )
        clock_offsets[str(rank)] = offset
        if offset is None:
            unanchored.append((rank, aligned))
        else:
            merged.extend(aligned)
        ranks.add(rank)
    for rank in sorted(flight_dumps or {}):
        merged.extend(flight_to_trace((flight_dumps or {})[rank], rank))
        ranks.add(rank)

    event_list = load_events_jsonl(event_files)
    merged.extend(events_to_trace(event_list))
    if phases:
        merged.extend(phases_to_trace(phases))

    # Best-effort placement for traces with no clock anchor: start them
    # at the earliest epoch timestamp any anchored source produced.
    anchor_ts = [
        float(e.get("ts", 0.0))
        for e in merged
        if e.get("ph") in ("X", "i", "C")
    ]
    base = min(anchor_ts) if anchor_ts else 0.0
    for rank, events in unanchored:
        if not events:
            continue
        t0 = min(float(e.get("ts", 0.0)) for e in events)
        shift = base - t0
        clock_offsets[str(rank)] = shift
        for e in events:
            e["ts"] = float(e.get("ts", 0.0)) + shift
        merged.extend(events)

    rank_metas = [_meta(r, f"rank {r}") for r in sorted(ranks)]
    result = {
        "traceEvents": rank_metas + merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "ranks": sorted(ranks),
            "num_events": len(event_list),
            "clock_offsets_us": clock_offsets,
        },
    }
    if phases:
        result["metadata"]["reconstructed_goodput"] = round(
            reconstruct_goodput(phases), 6
        )
        # Per-node MEAN per cause — the same averaging basis as
        # goodput_attribution(), so the two §34 surfaces agree.
        lost: Dict[str, Dict[int, float]] = {}
        for rec in phases.get("records", []):
            cause = rec.get("cause")
            if not cause:
                continue
            dur = float(rec.get("end", 0.0)) - float(
                rec.get("start", 0.0)
            )
            if dur > 0:
                per_node = lost.setdefault(cause, {})
                node = int(rec.get("node_id", 0))
                per_node[node] = per_node.get(node, 0.0) + dur
        if lost:
            result["metadata"]["lost_seconds_by_cause"] = {
                c: round(sum(nodes.values()) / len(nodes), 6)
                for c, nodes in sorted(lost.items())
            }
    return result


# ---------------------------------------------------------------------------
# Validation (smoke tests / CI)
# ---------------------------------------------------------------------------


def validate_merged(trace: Dict) -> List[str]:
    """Schema problems in a merged trace; empty list means valid."""
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    pids_named = set()
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M", "B", "E"):
            problems.append(f"event {i}: bad ph {ph!r}")
            continue
        if ph == "M":
            if e.get("name") == "process_name":
                pids_named.add(e.get("pid"))
            continue
        if not isinstance(e.get("ts"), (int, float)):
            problems.append(f"event {i}: non-numeric ts")
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            problems.append(f"event {i}: X without numeric dur")
        if "pid" not in e:
            problems.append(f"event {i}: missing pid")
    if not pids_named:
        problems.append("no process_name metadata rows")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems


def write_merged(trace: Dict, path: str, pretty: bool = False):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f, indent=2 if pretty else None)
    os.replace(tmp, path)
