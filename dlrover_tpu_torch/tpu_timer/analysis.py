"""Profiler analysis tooling (the port's copy of
``dlrover_tpu/tpu_timer/analysis.py``).

Parity: reference xpu_timer/py_xpu_timer (~2.1k LoC: perfetto timeline
generation, matmul analysis, stack viewer), over this repo's artifacts:

- ``timeline``: aggregate a (chrome-format) native timeline into
  per-name statistics, kernel/collective shares, and device-busy
  fraction inside capture windows.
- ``stacks``: the stack viewer — parse faulthandler all-thread dumps
  and the native sampler's blocks out of worker logs (post-mortems)
  and fold them into collapsed-stack counts (flamegraph input) plus a
  top-frame histogram that answers "where were the workers stuck".
- ``matmul`` (python -m dlrover_tpu_torch.tpu_timer.analysis matmul):
  sweep square bf16 products (``torch.matmul``) on the card, timed with
  CUDA events, and report achieved TFLOP/s and efficiency against the
  card's bf16 dense peak — the host-qualification table the reference's
  matmul analysis produces.
- ``merge``: cross-rank timeline merge (reference
  py_xpu_timer/parse_perfetto.py + gen_trace_timeline.py) — align N
  ranks' chrome traces onto one clock (offsets estimated from matched
  collective END times, which a blocking collective makes simultaneous
  across ranks up to skew), emit a single multi-process trace, and
  flag the STRAGGLER rank per collective (the rank arriving last is
  the one everyone else waited for).

Usage::

    python -m dlrover_tpu_torch.tpu_timer.analysis timeline trace.json
    python -m dlrover_tpu_torch.tpu_timer.analysis stacks worker-*.log
    python -m dlrover_tpu_torch.tpu_timer.analysis matmul --sizes 2048,4096
    python -m dlrover_tpu_torch.tpu_timer.analysis merge rank0.json \
        rank1.json --out merged.json
"""

import argparse
import collections
import json
import re
import sys
from typing import Dict, Iterable, List, Tuple

# ---------------------------------------------------------------------------
# Timeline analysis
# ---------------------------------------------------------------------------


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def summarize_timeline(trace: dict) -> dict:
    """Aggregate a chrome-trace dict into per-name and per-category
    statistics."""
    events = trace.get("traceEvents", [])
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        by_name.setdefault(name, []).append(
            (float(e.get("ts", 0.0)), float(e.get("dur", 0.0)))
        )

    names = {}
    for name, spans in by_name.items():
        durs = sorted(d for _, d in spans)
        names[name] = {
            "count": len(spans),
            "total_us": round(sum(durs), 1),
            "avg_us": round(sum(durs) / len(durs), 1),
            "p50_us": round(_percentile(durs, 0.5), 1),
            "p99_us": round(_percentile(durs, 0.99), 1),
        }

    def cat_total(pred) -> float:
        return sum(
            s["total_us"] for n, s in names.items() if pred(n)
        )

    kernels_us = cat_total(lambda n: n.startswith("xla/"))
    coll_re = re.compile(
        r"all[-_]?reduce|all[-_]?gather|reduce[-_]?scatter|ppermute"
        r"|all[-_]?to[-_]?all|collective",
        re.IGNORECASE,
    )
    collectives_us = cat_total(
        lambda n: n.startswith("xla/") and coll_re.search(n)
    )

    # Device-busy fraction inside xla capture windows: the union of
    # device-kernel intervals over the union of capture spans.
    windows = [
        (ts, ts + d) for ts, d in by_name.get("xla_capture", [])
    ]
    busy = 0.0
    window_total = sum(e - s for s, e in windows)
    if windows:
        kernel_spans = sorted(
            (ts, ts + d)
            for n, spans in by_name.items()
            if n.startswith("xla/")
            for ts, d in spans
        )
        merged: List[List[float]] = []
        for s, e in kernel_spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)

    return {
        "names": dict(
            sorted(
                names.items(),
                key=lambda kv: -kv[1]["total_us"],
            )
        ),
        "device_kernel_us": round(kernels_us, 1),
        "collective_us": round(collectives_us, 1),
        "collective_share": round(
            collectives_us / kernels_us, 4
        ) if kernels_us else 0.0,
        "capture_window_us": round(window_total, 1),
        "device_busy_fraction": round(busy / window_total, 4)
        if window_total
        else 0.0,
    }


def diff_timelines(
    base: dict, other: dict, min_total_us: float = 1.0
) -> dict:
    """Run-over-run trace diff: per-name total/avg deltas between two
    timeline JSONs, worst regressions first.

    Parity: reference py_xpu_timer's timeline tooling covers per-run
    analysis; this answers the cross-RUN question ("the step got 8ms
    slower — which op?"). Names
    present in only one run are reported with the other side at 0 —
    exactly the "op appeared/disappeared after my change" signal a
    kernel A/B needs."""
    sa, sb = summarize_timeline(base), summarize_timeline(other)
    rows = []
    for name in set(sa["names"]) | set(sb["names"]):
        a = sa["names"].get(name, {})
        b = sb["names"].get(name, {})
        ta = a.get("total_us", 0.0)
        tb = b.get("total_us", 0.0)
        if max(ta, tb) < min_total_us:
            continue
        rows.append({
            "name": name,
            "base_total_us": ta,
            "other_total_us": tb,
            "delta_us": round(tb - ta, 1),
            "ratio": round(tb / ta, 3) if ta else None,
            "base_avg_us": a.get("avg_us", 0.0),
            "other_avg_us": b.get("avg_us", 0.0),
        })
    rows.sort(key=lambda r: -abs(r["delta_us"]))
    return {
        "base_device_kernel_us": sa["device_kernel_us"],
        "other_device_kernel_us": sb["device_kernel_us"],
        "device_kernel_delta_us": round(
            sb["device_kernel_us"] - sa["device_kernel_us"], 1
        ),
        "base_collective_share": sa["collective_share"],
        "other_collective_share": sb["collective_share"],
        "rows": rows,
    }


# ---------------------------------------------------------------------------
# Stack viewer (faulthandler dumps in worker logs)
# ---------------------------------------------------------------------------

_THREAD_RE = re.compile(r"^(Current thread|Thread) (0x[0-9a-f]+)")
_FRAME_RE = re.compile(r'^\s+File "(?P<file>[^"]+)", line (?P<line>\d+) in (?P<fn>.+)$')


def parse_faulthandler_dumps(text: str) -> List[List[str]]:
    """Extract per-thread stacks (outermost-first frame lists) from log
    text containing faulthandler all-thread dumps."""
    stacks: List[List[str]] = []
    current: List[str] = []
    in_stack = False
    for line in text.splitlines():
        if _THREAD_RE.match(line.strip()):
            if current:
                stacks.append(current)
            current = []
            in_stack = True
            continue
        m = _FRAME_RE.match(line)
        if m and in_stack:
            frame = f"{m.group('fn')} ({m.group('file').rsplit('/', 1)[-1]}:{m.group('line')})"  # noqa: E501
            current.append(frame)
        elif in_stack and line.strip() == "":
            if current:
                stacks.append(current)
                current = []
            in_stack = False
    if current:
        stacks.append(current)
    # faulthandler prints innermost-first ("most recent call first");
    # flamegraph convention is outermost-first.
    return [list(reversed(s)) for s in stacks]


def fold_stacks(stacks: Iterable[List[str]]) -> Dict[str, int]:
    """Collapsed-stack counts: 'outer;...;inner' -> occurrences
    (flamegraph.pl / speedscope input)."""
    folded: Dict[str, int] = collections.Counter()
    for stack in stacks:
        if stack:
            folded[";".join(stack)] += 1
    return dict(folded)


def top_frames(stacks: Iterable[List[str]], k: int = 10) -> List[Tuple[str, int]]:
    """Histogram of innermost frames: where the threads actually were."""
    counter: collections.Counter = collections.Counter()
    for stack in stacks:
        if stack:
            counter[stack[-1]] += 1
    return counter.most_common(k)


# ---------------------------------------------------------------------------
# Cross-rank timeline merge + straggler attribution
# ---------------------------------------------------------------------------

_COLL_RE = re.compile(
    r"all[-_]?reduce|all[-_]?gather|reduce[-_]?scatter|ppermute"
    r"|all[-_]?to[-_]?all|collective",
    re.IGNORECASE,
)


def _collective_spans(trace: dict) -> Dict[str, List[Tuple[float, float]]]:
    """name -> [(start, end)] in ts order, for collective-looking device
    events."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        if name.startswith("xla/") and _COLL_RE.search(name):
            ts = float(e.get("ts", 0.0))
            out.setdefault(name, []).append((ts, ts + float(e.get("dur", 0.0))))
    for spans in out.values():
        spans.sort()
    return out


def estimate_clock_offsets(
    traces: Dict[int, dict]
) -> Dict[int, float]:
    """Per-rank clock offset (us, subtract to land on rank-0's clock).

    A blocking collective ENDS on every participant at (nearly) the
    same wall instant — the k-th instance of a given collective name is
    the same logical operation on every rank, so the median difference
    of its end times vs rank 0 estimates the clock skew. Host clocks in
    one job are NTP-close but not trace-identical; without this the
    merged timeline misattributes waits to whichever host booted last.
    """
    ranks = sorted(traces)
    base = _collective_spans(traces[ranks[0]])
    offsets = {ranks[0]: 0.0}
    for r in ranks[1:]:
        mine = _collective_spans(traces[r])
        diffs: List[float] = []
        for name, spans0 in base.items():
            spans_r = mine.get(name, [])
            for k in range(min(len(spans0), len(spans_r))):
                diffs.append(spans_r[k][1] - spans0[k][1])
        diffs.sort()
        offsets[r] = diffs[len(diffs) // 2] if diffs else 0.0
    return offsets


def merge_rank_traces(traces: Dict[int, dict]) -> Tuple[dict, dict]:
    """(merged chrome trace, straggler report) from per-rank traces.

    The merged trace keeps every event with pid=rank (plus
    process_name metadata rows), all on rank-0's clock. The report
    gives, per collective name: mean/max arrival spread (latest start −
    earliest start ≈ time the fast ranks wasted waiting) and how often
    each rank was the last to arrive."""
    offsets = estimate_clock_offsets(traces)
    merged_events: List[dict] = []
    for r, trace in sorted(traces.items()):
        merged_events.append({
            "ph": "M", "pid": r, "name": "process_name",
            "args": {"name": f"rank {r}"},
        })
        off = offsets[r]
        for e in trace.get("traceEvents", []):
            e2 = dict(e)
            e2["pid"] = r
            if "ts" in e2:
                e2["ts"] = float(e2["ts"]) - off
            merged_events.append(e2)

    # Straggler attribution over matched collective instances.
    spans = {
        r: _collective_spans(t) for r, t in traces.items()
    }
    report: Dict[str, dict] = {}
    names = set().union(*(s.keys() for s in spans.values())) if spans else set()
    for name in sorted(names):
        per_rank = {
            r: s.get(name, []) for r, s in spans.items()
        }
        n_inst = min((len(v) for v in per_rank.values()), default=0)
        if n_inst == 0 or len(per_rank) < 2:
            continue
        spreads: List[float] = []
        last_count: collections.Counter = collections.Counter()
        for k in range(n_inst):
            starts = {
                r: per_rank[r][k][0] - offsets[r] for r in per_rank
            }
            latest = max(starts, key=starts.get)
            spreads.append(starts[latest] - min(starts.values()))
            last_count[latest] += 1
        straggler, times = last_count.most_common(1)[0]
        report[name] = {
            "instances": n_inst,
            "mean_wait_us": round(sum(spreads) / len(spreads), 1),
            "max_wait_us": round(max(spreads), 1),
            "straggler_rank": straggler,
            "straggler_share": round(times / n_inst, 3),
            "last_arrival_counts": dict(last_count),
        }
    return (
        {"traceEvents": merged_events, "clock_offsets_us": {
            str(r): round(v, 1) for r, v in offsets.items()
        }},
        report,
    )


# ---------------------------------------------------------------------------
# Matmul analysis
# ---------------------------------------------------------------------------

# Dense bf16 peak of each card (published data sheets, at the full power
# limit), by the prefix of ``torch.cuda.get_device_name``: the H100 SXM.
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_bf16(kind: str) -> float:
    """The card's bf16 dense peak in FLOP/s (0.0 when unknown)."""
    return next(
        (
            v
            for k, v in sorted(
                _PEAK_BF16.items(), key=lambda kv: -len(kv[0])
            )
            if kind.startswith(k)
        ),
        0.0,
    )


def matmul_analysis(sizes: List[int], iters: int = 100,
                    device: str = "cuda") -> List[dict]:
    """Achieved bf16 GEMM TFLOP/s per size vs the card's peak: ``iters``
    back-to-back ``torch.matmul`` of one ``[n, n]`` pair (after a
    warm-up), timed with CUDA events around the whole run. On the CPU
    (``device="cpu"``) the host clock times it and no peak applies."""
    import time

    import torch

    on_cuda = str(device).startswith("cuda")
    kind = (torch.cuda.get_device_name(torch.device(device)) if on_cuda
            else "cpu")
    peak = device_peak_bf16(kind)
    gen = torch.Generator(device).manual_seed(0)
    rows = []
    for n in sizes:
        a = torch.randn(n, n, generator=gen, device=device).bfloat16()
        b = torch.randn(n, n, generator=gen, device=device).bfloat16()
        out = torch.empty(n, n, dtype=torch.bfloat16, device=device)
        for _ in range(3):
            torch.matmul(a, b, out=out)
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                torch.matmul(a, b, out=out)
            end.record()
            end.synchronize()
            total = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                torch.matmul(a, b, out=out)
            total = time.perf_counter() - t0
        per_iter = total / iters
        tflops = 2 * n**3 / per_iter / 1e12
        rows.append(
            {
                "size": n,
                "ms": round(per_iter * 1e3, 3),
                "tflops": round(tflops, 3),
                "efficiency_pct": round(100 * tflops * 1e12 / peak, 1)
                if peak
                else None,
                "device": kind,
            }
        )
        del a, b, out
    return rows


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="tpu_timer analysis")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_tl = sub.add_parser("timeline", help="aggregate a timeline JSON")
    p_tl.add_argument("trace")
    p_tl.add_argument("--top", type=int, default=15)

    p_st = sub.add_parser("stacks", help="stack viewer over worker logs")
    p_st.add_argument("logs", nargs="+")
    p_st.add_argument("--folded", action="store_true",
                      help="print collapsed stacks (flamegraph input)")

    p_mm = sub.add_parser("matmul", help="bf16 GEMM efficiency sweep")
    p_mm.add_argument("--sizes", default="1024,2048,4096,8192")
    p_mm.add_argument("--iters", type=int, default=100)
    p_mm.add_argument("--device", default="cuda")

    p_mg = sub.add_parser(
        "merge", help="merge N ranks' traces; flag stragglers"
    )
    p_mg.add_argument("traces", nargs="+",
                      help="per-rank trace JSONs, rank = position")
    p_mg.add_argument("--out", default="merged_trace.json")

    p_df = sub.add_parser(
        "diff", help="run-over-run timeline diff (regressions first)"
    )
    p_df.add_argument("base")
    p_df.add_argument("other")
    p_df.add_argument("--top", type=int, default=15)

    args = parser.parse_args(argv)

    if args.cmd == "timeline":
        with open(args.trace) as f:
            report = summarize_timeline(json.load(f))
        top = dict(list(report["names"].items())[: args.top])
        report["names"] = top
        print(json.dumps(report, indent=2))
        return 0

    if args.cmd == "stacks":
        from dlrover_tpu_torch.tpu_timer.native_stack import (
            parse_native_dumps,
        )

        stacks: List[List[str]] = []
        for path in args.logs:
            with open(path, errors="replace") as f:
                text = f.read()
            stacks.extend(parse_faulthandler_dumps(text))
            # Native stacks the agent captured out-of-process (ptrace)
            # live in the same logs; fold them into the same histogram
            # so a hang in the driver or NCCL names its C++ frame.
            stacks.extend(parse_native_dumps(text))
        if not stacks:
            print("no stack dumps found", file=sys.stderr)
            return 1
        if args.folded:
            for stack, count in sorted(fold_stacks(stacks).items()):
                print(f"{stack} {count}")
        else:
            print(f"{len(stacks)} thread stacks")
            for frame, count in top_frames(stacks):
                print(f"{count:6d}  {frame}")
        return 0

    if args.cmd == "matmul":
        sizes = [int(s) for s in args.sizes.split(",") if s]
        for row in matmul_analysis(sizes, args.iters, args.device):
            print(json.dumps(row))
        return 0

    if args.cmd == "merge":
        traces = {}
        for rank, path in enumerate(args.traces):
            with open(path) as f:
                traces[rank] = json.load(f)
        merged, report = merge_rank_traces(traces)
        with open(args.out, "w") as f:
            json.dump(merged, f)
        print(f"merged {len(traces)} ranks -> {args.out} "
              f"(offsets us: {merged['clock_offsets_us']})")
        for name, row in sorted(
            report.items(), key=lambda kv: -kv[1]["mean_wait_us"]
        ):
            print(
                f"  {name}: straggler rank {row['straggler_rank']} "
                f"({row['straggler_share']:.0%} of "
                f"{row['instances']} instances), mean wait "
                f"{row['mean_wait_us']}us max {row['max_wait_us']}us"
            )
        return 0

    if args.cmd == "diff":
        with open(args.base) as f:
            base = json.load(f)
        with open(args.other) as f:
            other = json.load(f)
        report = diff_timelines(base, other)
        report["rows"] = report["rows"][: args.top]
        print(json.dumps(report, indent=2))
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
