#!/usr/bin/env python
"""One-command job postmortem: merge every timing artifact into one trace
(the port's counterpart of ``tools/merge_timeline.py``, over
``dlrover_tpu_torch.observability.trace_merge``).

Fuses training_event JSONL files, per-rank tpu_timer chrome-trace
dumps, flight-recorder crash dumps, and the master's goodput phase
ledger into a single clock-aligned chrome-trace/Perfetto JSON (per-rank
tracks + control-plane lanes + a job-level goodput lane), then prints
the reconstructed goodput so it can be cross-checked against the live
``PerfMonitor.goodput()`` number.

Typical postmortem::

    python tools/torch_merge_timeline.py \\
        --events /tmp/dlrover_tpu_events/*.jsonl \\
        --trace rank0_trace.json --trace rank1_trace.json \\
        --flight /tmp/dlrover_tpu_flight/*.json \\
        --phases phases.json \\
        --out job_timeline.json

``--phases`` takes the JSON served at the master dashboard's
``/api/phases`` (or a file saved from it); ``--trace -`` reads a trace
from stdin, pairing with ``python -m dlrover_tpu_torch.tpu_timer.dump
--out -``. Rank numbers default to --trace order; prefix with
``RANK:`` (e.g. ``--trace 3:rank3.json``) to override. Open the output
in https://ui.perfetto.dev.
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from dlrover_tpu_torch.observability.trace_merge import (  # noqa: E402
    merge_job_timeline,
    reconstruct_goodput,
    validate_merged,
    write_merged,
)

_RANK_PREFIX = re.compile(r"^(\d+):(.+)$")


def _load_json(path: str):
    if path == "-":
        return json.load(sys.stdin)
    with open(path) as f:
        return json.load(f)


def _parse_rank_paths(specs):
    """[(rank, path, pinned)] from --trace/--flight args: positional
    rank by default (skipping pinned ones), 'RANK:path' to pin. A
    pinned rank colliding with an already-assigned one is an operator
    error — warn loudly instead of silently dropping the earlier
    trace."""
    out = []
    used = set()
    next_rank = 0
    for spec in specs:
        m = _RANK_PREFIX.match(spec)
        pinned = bool(m and (os.path.exists(m.group(2)) or m.group(2) == "-"))
        if pinned:
            rank = int(m.group(1))
            path = m.group(2)
            if rank in used:
                print(
                    f"WARNING: rank {rank} assigned twice; {path} "
                    "overrides the earlier trace for that rank",
                    file=sys.stderr,
                )
        else:
            rank = next_rank
            while rank in used:
                rank += 1
            path = spec
        used.add(rank)
        out.append((rank, path, pinned))
        next_rank = rank + 1
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="merge a job's timing artifacts into one trace"
    )
    parser.add_argument(
        "--events",
        nargs="*",
        default=[],
        help="training_event JSONL files",
    )
    parser.add_argument(
        "--trace",
        action="append",
        default=[],
        help="per-rank tpu_timer trace JSON ('-' for stdin, 'N:path' "
        "to pin the rank); repeatable",
    )
    parser.add_argument(
        "--flight",
        action="append",
        default=[],
        help="flight-recorder dump JSON ('N:path' to pin the rank); "
        "repeatable",
    )
    parser.add_argument(
        "--phases",
        default="",
        help="goodput phase ledger JSON (the master's /api/phases)",
    )
    parser.add_argument(
        "--expect-goodput",
        type=float,
        default=None,
        help="fail (exit 4) if the reconstructed goodput differs from "
        "this value by more than --goodput-tolerance",
    )
    parser.add_argument(
        "--goodput-tolerance", type=float, default=0.01
    )
    parser.add_argument("--out", default="job_timeline.json")
    parser.add_argument("--pretty", action="store_true")
    args = parser.parse_args(argv)

    rank_traces = {}
    for rank, path, _pinned in _parse_rank_paths(args.trace):
        try:
            rank_traces[rank] = _load_json(path)
        except (OSError, ValueError) as e:
            print(f"skipping trace {path}: {e}", file=sys.stderr)

    flight_dumps = {}
    for rank, path, pinned in _parse_rank_paths(args.flight):
        try:
            dump = _load_json(path)
        except (OSError, ValueError) as e:
            print(f"skipping flight dump {path}: {e}", file=sys.stderr)
            continue
        # A dump knows its own global rank (runtime stamps process_id
        # into the meta); trust it over CLI POSITION but never over an
        # explicit 'N:path' pin.
        meta = dump.get("meta") or {}
        if not pinned and "process_id" in meta:
            rank = int(meta["process_id"])
        if rank in flight_dumps:
            print(
                f"WARNING: two flight dumps landed on rank {rank}; "
                f"{path} overrides the earlier one",
                file=sys.stderr,
            )
        flight_dumps[rank] = dump

    phases = None
    if args.phases:
        try:
            phases = _load_json(args.phases)
        except (OSError, ValueError) as e:
            print(f"skipping phases {args.phases}: {e}", file=sys.stderr)

    if not (args.events or rank_traces or flight_dumps or phases):
        print("nothing to merge; pass --events/--trace/--flight/--phases",
              file=sys.stderr)
        return 2

    merged = merge_job_timeline(
        event_files=args.events,
        rank_traces=rank_traces,
        flight_dumps=flight_dumps,
        phases=phases,
    )
    problems = validate_merged(merged)
    if problems:
        for p in problems:
            print(f"invalid merged trace: {p}", file=sys.stderr)
        return 3
    write_merged(merged, args.out, pretty=args.pretty)

    meta = merged["metadata"]
    n_events = sum(
        1 for e in merged["traceEvents"] if e.get("ph") != "M"
    )
    print(
        f"merged -> {args.out}: {n_events} events, ranks "
        f"{meta['ranks']}, clock offsets (us) {meta['clock_offsets_us']}"
    )
    if phases is not None:
        goodput = reconstruct_goodput(phases)
        dropped = int(phases.get("records_dropped", 0))
        print(f"reconstructed goodput: {goodput:.4f}")
        if args.expect_goodput is not None and (
            abs(goodput - args.expect_goodput) > args.goodput_tolerance
        ):
            msg = (
                f"goodput mismatch: reconstructed {goodput:.4f} vs "
                f"expected {args.expect_goodput:.4f} "
                f"(tolerance {args.goodput_tolerance})"
            )
            if dropped:
                # The master's phase ring evicted records; the
                # reconstruction is partial by design, not a lying
                # trace — warn instead of failing.
                print(
                    f"WARNING: {msg} — but {dropped} phase records "
                    "were evicted from the master's ring, so the "
                    "reconstruction is partial",
                    file=sys.stderr,
                )
            else:
                print(msg, file=sys.stderr)
                return 4
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
