"""Timeline/metrics fetch CLI (the port's copy of
``dlrover_tpu/tpu_timer/dump.py``).

Parity: reference py_xpu_timer tools (gen_trace_timeline.py, dump
driver) — the daemon already serves a chrome-trace JSON, so the tool is
a fetch-and-save:

    python -m dlrover_tpu_torch.tpu_timer.dump --port 18889 --out trace.json
    python -m dlrover_tpu_torch.tpu_timer.dump --port 18889 --metrics
    python -m dlrover_tpu_torch.tpu_timer.dump --port 18889 --out - \\
        | python tools/torch_merge_timeline.py --trace - --out merged.json

``--retries``/backoff covers the race where the daemon is still
starting (worker boot) or restarting; ``--out -`` streams to stdout for
piping into the merge tool. Saved timelines get a ``clock_sync`` anchor
(epoch minus CLOCK_MONOTONIC at fetch time, both clocks read on the
daemon's own host) so the merger can land the monotonic trace
timestamps on the job-wide epoch clock.

Open the JSON in chrome://tracing or https://ui.perfetto.dev.
"""

import argparse
import http.client
import json
import sys
import time


def fetch(port: int, path: str, host: str = "127.0.0.1") -> bytes:
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"GET {path} -> {resp.status}")
        return resp.read()
    finally:
        conn.close()


def fetch_with_retries(
    port: int,
    path: str,
    host: str = "127.0.0.1",
    retries: int = 0,
    backoff_s: float = 0.5,
) -> bytes:
    """Fetch, retrying a daemon that is still coming up; exponential
    backoff capped at 8s per wait."""
    err: Exception = RuntimeError("no attempt made")
    for attempt in range(retries + 1):
        if attempt:
            wait = min(backoff_s * (2 ** (attempt - 1)), 8.0)
            print(
                f"fetch attempt {attempt} failed ({err}); retrying in "
                f"{wait:.1f}s",
                file=sys.stderr,
            )
            time.sleep(wait)
        try:
            return fetch(port, path, host)
        except (OSError, RuntimeError) as e:
            err = e
    raise err


_LOCAL_HOSTS = ("127.0.0.1", "localhost", "::1")


def annotate_clock_sync(data: bytes, host: str = "127.0.0.1") -> bytes:
    """Embed the epoch<->monotonic offset into a timeline JSON. The
    daemon stamps events with CLOCK_MONOTONIC (seconds since ITS host
    booted), so the anchor is only valid when this tool runs on the
    daemon's own host — a remote fetch would mix two machines' boot
    epochs and silently misplace the rank on the merged timeline, so
    remote traces are left unanchored (the merge tool then does
    best-effort placement and says so). Non-JSON data passes through
    untouched."""
    if host not in _LOCAL_HOSTS:
        return data
    try:
        trace = json.loads(data)
    except ValueError:
        return data
    if not isinstance(trace, dict):
        return data
    trace["clock_sync"] = {
        "epoch_minus_mono_us": (time.time() - time.monotonic()) * 1e6,
        "fetched_at": time.time(),
    }
    return json.dumps(trace).encode()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="tpu_timer dump tool")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=18889)
    parser.add_argument(
        "--out",
        type=str,
        default="tpu_timer_trace.json",
        help="output path, or '-' to stream to stdout",
    )
    parser.add_argument(
        "--metrics",
        action="store_true",
        help="print Prometheus metrics instead of saving the timeline",
    )
    parser.add_argument(
        "--retries",
        type=int,
        default=0,
        help="retry a daemon that is still starting (with backoff)",
    )
    parser.add_argument(
        "--backoff",
        type=float,
        default=0.5,
        help="initial retry backoff seconds (doubles per attempt)",
    )
    args = parser.parse_args(argv)
    try:
        if args.metrics:
            sys.stdout.write(
                fetch_with_retries(
                    args.port,
                    "/metrics",
                    args.host,
                    retries=args.retries,
                    backoff_s=args.backoff,
                ).decode()
            )
            return 0
        data = annotate_clock_sync(
            fetch_with_retries(
                args.port,
                "/timeline",
                args.host,
                retries=args.retries,
                backoff_s=args.backoff,
            ),
            host=args.host,
        )
        if args.out == "-":
            sys.stdout.buffer.write(data)
            sys.stdout.buffer.flush()
            return 0
        with open(args.out, "wb") as f:
            f.write(data)
        print(f"timeline saved to {args.out} ({len(data)} bytes)")
        return 0
    except (OSError, RuntimeError) as e:
        print(f"fetch failed: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
