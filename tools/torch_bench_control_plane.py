"""Control-plane saturation bench: 1k sim workers vs one master (§32).

Runs ``dlrover_tpu_torch/testing/control_plane_soak.py`` — the ramp /
quorum / shed phases with all three invariants (shed ordering law,
bounded-buffer accounting, metric-vs-span agreement within 15%) — and
prints one flat JSON line: max sustainable RPCs/s, master CPU per 1k
RPCs and time-to-quorum per world (the port's copy of
``tools/bench_control_plane.py``; ``chip_smoke.py``'s ``control_plane``
phase runs it on the card's host).

    python tools/torch_bench_control_plane.py [--workers 1024] [--fast]

Note the harness is in-process (clients and master share the GIL), so
``max_rps`` is a *lower bound* on real master capacity — but a
consistent one, which is what a tracked trajectory needs.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dlrover_tpu_torch.testing.control_plane_soak import (  # noqa: E402
    ControlPlaneSoakConfig,
    run_control_plane_soak,
)


def run_bench(workers: int = 1024, fast: bool = False) -> dict:
    if fast:
        cfg = ControlPlaneSoakConfig(
            workers=min(workers, 64),
            driver_threads=4,
            stage_duration_s=0.5,
            max_stages=3,
            quorum_worlds=(8, 64),
            shed_duration_s=0.5,
        )
    else:
        cfg = ControlPlaneSoakConfig(
            workers=workers,
            driver_threads=16,
            stage_duration_s=1.2,
            max_stages=5,
            quorum_worlds=(8, 64, 256, 1024),
            shed_duration_s=0.8,
        )
    rep = run_control_plane_soak(cfg)
    out = {
        "workers": rep["workers"],
        "max_rps": rep["max_sustainable_rps"],
        "cpu_s_per_1k_rpcs": rep["cpu_s_per_1k_rpcs"],
        "rpcs_total": rep["rpcs_total"],
        "inflight_high_water": rep["inflight_high_water"],
        "dispatch_p99_s": rep["dispatch_p99_s"],
        "shed_diagnostic": rep["shed"]["shed_diagnostic"],
        "shed_telemetry": rep["shed"]["shed_telemetry"],
        "shed_lease_rpcs": rep["shed"]["lease_rpcs_during_shed"],
        "span_agree_worst_rel":
            rep["metric_span_agreement"]["worst_rel_diff"],
        "span_agree_verbs":
            rep["metric_span_agreement"]["verbs_checked"],
        "invariants": rep["invariants"],
    }
    for world, stats in rep["quorum"].items():
        out[f"quorum_{world}_s"] = stats["time_to_quorum_s"]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="control-plane bench")
    parser.add_argument("--workers", type=int, default=1024)
    parser.add_argument("--fast", action="store_true",
                        help="64-worker smoke (seconds)")
    args = parser.parse_args(argv)
    print(json.dumps(run_bench(workers=args.workers, fast=args.fast)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
