"""Checkpoint-cadence autotuning from measured costs (a copy of
``dlrover_tpu/flash_ckpt/autotune.py``).

Young/Daly optimal checkpoint interval, adapted for ASYNC flash saves:
``tau = sqrt(2 * delta * MTBF)`` where ``delta`` is the cost a save
imposes on training — for flash checkpoints that is the ~ms blocking
launch of the device->host DMA, not the transfer itself (it overlaps
compute). Two floors keep the result physical:

- a new snapshot cannot start before the previous drain finished, so
  the interval never drops below 2x the measured drain time;
- an absolute minimum keeps pathological measurements (zero-cost saves
  on tiny models) from requesting per-step checkpoints.

Parity: the reference's dynamic-optimization design
(docs/design/dynamic-optimization.md) prescribes tuning runtime knobs
from measured job stats instead of constants; its flash-checkpoint
paper pitch is exactly "save as often as the blocking cost allows".
The previous bench hard-coded a 60s cadence; with a measured ~3ms
block cost the optimal cadence is ~5s, which cuts the expected lost
work per failure from ~30s to ~2.5s of steps.
"""

import math
from collections import deque
from typing import Optional


def optimal_save_interval_s(
    save_block_s: float,
    drain_s: float = 0.0,
    mtbf_s: float = 3600.0,
    min_interval_s: float = 2.0,
    max_interval_s: float = 600.0,
) -> float:
    """Interval minimizing expected overhead: per-save blocking cost
    amortized vs expected replay of half an interval per failure."""
    delta = max(float(save_block_s), 1e-4)
    tau = math.sqrt(2.0 * delta * max(float(mtbf_s), 1.0))
    tau = max(tau, 2.0 * max(float(drain_s), 0.0), float(min_interval_s))
    return min(tau, float(max_interval_s))


def expected_goodput_pct(
    save_interval_s: float,
    save_block_s: float,
    recovery_s: float,
    mtbf_s: float = 3600.0,
    drain_s: float = 0.0,
) -> float:
    """Goodput at an operating point: per-MTBF overhead = save blocks +
    one failure's downtime (recovery + expected replay of half an
    interval plus the snapshot's drain lag)."""
    saves = mtbf_s / max(save_interval_s, 1e-6)
    overhead = saves * save_block_s
    downtime = recovery_s + save_interval_s / 2.0 + drain_s
    return 100.0 * mtbf_s / (mtbf_s + overhead + downtime)


class MtbfTracker:
    """Rolling observed mean time between failures.

    The live counterpart of the constant ``mtbf_s`` the bench assumes:
    the autoscaler feeds failure arrival timestamps in (node deaths,
    worker SIGKILLs) and reads the windowed mean inter-arrival back out
    to drive :func:`optimal_save_interval_s`. ``None`` until at least
    ``min_failures`` arrivals landed — one failure is an anecdote, not
    a rate.
    """

    def __init__(self, window: int = 32, min_failures: int = 2):
        self._times = deque(maxlen=max(window, 2))
        self._min_failures = max(min_failures, 2)

    def record_failure(self, ts: float):
        self._times.append(float(ts))

    @property
    def failures_seen(self) -> int:
        return len(self._times)

    def observed_mtbf_s(self) -> Optional[float]:
        if len(self._times) < self._min_failures:
            return None
        times = sorted(self._times)
        gaps = [b - a for a, b in zip(times, times[1:]) if b > a]
        if not gaps:
            return None
        return sum(gaps) / len(gaps)


class SaveCostTracker:
    """Rolling medians of measured save costs, feeding the autotuner."""

    def __init__(self, window: int = 16):
        self._block = deque(maxlen=window)
        self._drain = deque(maxlen=window)

    def record_block(self, seconds: float):
        self._block.append(float(seconds))

    def record_drain(self, seconds: float):
        self._drain.append(float(seconds))

    @staticmethod
    def _median(values) -> Optional[float]:
        if not values:
            return None
        vals = sorted(values)
        return vals[len(vals) // 2]

    @property
    def block_s(self) -> Optional[float]:
        return self._median(self._block)

    @property
    def drain_s(self) -> Optional[float]:
        return self._median(self._drain)

    def recommended_interval_s(
        self, mtbf_s: float = 3600.0, **kwargs
    ) -> Optional[float]:
        """None until at least one save was measured."""
        block = self.block_s
        if block is None:
            return None
        return optimal_save_interval_s(
            block, self.drain_s or block, mtbf_s, **kwargs
        )
