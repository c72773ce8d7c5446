"""Elastic trainer: fixed global batch across world-size changes (the
port of ``dlrover_tpu/trainer/elastic/trainer.py``). The training
semantics (global batch, LR schedule) must not depend on how many hosts
are alive: the global batch is ``micro_batch_per_device x dp_size x
grad_accum``, and on a re-scale the trainer recomputes grad_accum for
the new dp size (the caller rebuilds its step with it).

Master reporting runs only when a client is passed. Each completed step
beats the process's hang watchdog when one is installed.
"""

import time
from dataclasses import dataclass
from typing import Callable, List

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point
from dlrover_tpu_torch.observability import tracing


@dataclass
class ElasticBatchConfig:
    global_batch_size: int
    micro_batch_per_device: int

    def grad_accum_for(self, dp_size: int) -> int:
        """Microbatch steps per update for a data-parallel size."""
        denom = self.micro_batch_per_device * dp_size
        if denom <= 0 or self.global_batch_size % denom != 0:
            raise ValueError(
                f"global batch {self.global_batch_size} not divisible by "
                f"micro({self.micro_batch_per_device}) x dp({dp_size})"
            )
        return self.global_batch_size // denom

    def is_legal_dp(self, dp_size: int) -> bool:
        denom = self.micro_batch_per_device * dp_size
        return denom > 0 and self.global_batch_size % denom == 0

    def legal_dp_sizes(self, max_dp: int) -> List[int]:
        """Data-parallel sizes this batch config can train at."""
        return [dp for dp in range(1, max_dp + 1) if self.is_legal_dp(dp)]

    def legal_node_counts_fn(
        self, local_world_size: int = 1
    ) -> Callable[[int, int], List[int]]:
        """A ``legal_counts_fn`` for ``RendezvousManager`` and
        ``RescaleCoordinator``: node counts that are both topology-legal
        (multiples of ``node_unit``) AND batch-legal (``global_batch %
        (micro * nodes * local_world_size) == 0``). Without this wiring
        a 3-of-4-survivors rendezvous would form a world whose
        ``grad_accum_for`` raises — crashing the job it just saved."""

        def legal_counts(max_nodes: int, node_unit: int) -> List[int]:
            unit = max(node_unit, 1)
            return [
                n
                for n in range(unit, max_nodes + 1, unit)
                if self.is_legal_dp(n * max(local_world_size, 1))
            ]

        return legal_counts


class ElasticTrainer:
    """Step/epoch bookkeeping + master perf reporting around a train
    step whose grad_accum tracks the live world."""

    def __init__(
        self,
        batch_config: ElasticBatchConfig,
        dp_size: int,
        master_client=None,
        report_interval_s: float = 15.0,
        flight_recorder=None,
    ):
        self.batch_config = batch_config
        self.dp_size = dp_size
        self.grad_accum = batch_config.grad_accum_for(dp_size)
        self._client = master_client
        self._report_interval_s = report_interval_s
        self.global_step = 0
        self._train_started = 0.0
        self._last_report = 0.0
        self._last_step_ts = 0.0
        # Per-step flight recording: explicit recorder, else whatever
        # runtime.init_distributed armed for this process (never create
        # one here — library code must not grab crash hooks).
        if flight_recorder is None:
            from dlrover_tpu_torch.observability.flight_recorder import (
                active_recorder,
            )

            flight_recorder = active_recorder()
        self._flight_recorder = flight_recorder

    # ---- re-scale ----------------------------------------------------------

    def rescale(self, dp_size: int) -> bool:
        """Adopt a new data-parallel size; True if grad_accum changed
        (caller must rebuild its step with the new accumulation)."""
        new_accum = self.batch_config.grad_accum_for(dp_size)
        changed = new_accum != self.grad_accum
        if changed:
            logger.info(
                "elastic re-scale: dp %d -> %d, grad_accum %d -> %d "
                "(global batch stays %d)",
                self.dp_size,
                dp_size,
                self.grad_accum,
                new_accum,
                self.batch_config.global_batch_size,
            )
        self.dp_size = dp_size
        self.grad_accum = new_accum
        return changed

    # ---- step bookkeeping --------------------------------------------------

    def start_training(self):
        self._train_started = time.time()
        self._last_step_ts = self._train_started

    def step_completed(
        self,
        steps: int = 1,
        data_wait_s: float = 0.0,
        ckpt_block_s: float = 0.0,
        allreduce_wait_s: float = 0.0,
    ):
        self.global_step += steps
        # Chaos site: "mid-step" from the job's perspective — the step
        # landed on device but nothing downstream (reports, checkpoints
        # of this step) has run. A crash action here is the worker
        # SIGKILL the soak's recovery invariants are proved against.
        fault_point("agent.worker.crash", step=self.global_step)
        now = time.time()
        prev = self._last_step_ts or now
        step_time_s = max(now - prev, 0.0) / max(steps, 1)
        if self._flight_recorder is not None:
            # Host-side bookkeeping between steps. Step wall time is the
            # gap since the last completion (dispatch + device + data).
            self._flight_recorder.record_step(
                self.global_step,
                step_time_s=step_time_s,
                data_wait_s=data_wait_s,
                ckpt_block_s=ckpt_block_s,
            )
        self._emit_step_spans(
            step_time_s * max(steps, 1),
            data_wait_s, allreduce_wait_s, ckpt_block_s,
        )
        # Progress beacon for the rolling-deadline hang watchdog: one
        # global check when none is installed.
        from dlrover_tpu_torch.observability.hang_watchdog import (
            active_watchdog,
        )

        watchdog = active_watchdog()
        if watchdog is not None:
            watchdog.beat()
        self._last_step_ts = now
        if (
            self._client is not None
            and now - self._last_report > self._report_interval_s
        ):
            self._last_report = now
            elapsed = now - self._train_started if self._train_started else 0
            try:
                self._client.report_global_step(
                    self.global_step,
                    elapsed_train_secs=elapsed,
                    # Straggler signal: the master skews this against
                    # the other ranks' reports.
                    step_time_s=step_time_s,
                )
                # Finished spans ride the same cadence (separate
                # best-effort verb; no-op when tracing is disarmed).
                report_spans = getattr(
                    self._client, "report_trace_spans", None
                )
                if callable(report_spans):
                    report_spans()
            except Exception:
                logger.warning("global step report failed", exc_info=True)

    def _emit_step_spans(
        self,
        step_wall_s: float,
        data_wait_s: float,
        allreduce_wait_s: float,
        ckpt_block_s: float,
    ):
        """Retrospective per-step phase tree: one ``train.step`` root
        per completed step with data-fetch / compute / allreduce-wait /
        ckpt-persist children cut from the durations the caller already
        measured. Phase placement inside the step is the canonical
        order (fetch -> compute -> allreduce -> persist); the exact
        durations ride as attrs. Disarmed: one global check."""
        tracer = tracing.active_tracer()
        if tracer is None:
            return
        end = time.monotonic()
        start = end - max(step_wall_s, 0.0)
        root = tracer.record_span(
            "train.step", start, end,
            attrs={"step": self.global_step, "dp_size": self.dp_size},
        )
        waits = data_wait_s + allreduce_wait_s + ckpt_block_s
        compute_s = max(step_wall_s - waits, 0.0)
        cursor = start
        for name, dur in (
            ("train.data_fetch", data_wait_s),
            ("train.step_compute", compute_s),
            ("train.allreduce_wait", allreduce_wait_s),
            ("train.ckpt_persist", ckpt_block_s),
        ):
            if dur <= 0.0:
                continue
            tracer.record_span(
                name, cursor, min(cursor + dur, end), parent=root,
                attrs={"seconds": round(dur, 6)},
            )
            cursor += dur

    def epoch_of(self, dataset_size: int) -> int:
        consumed = self.global_step * self.batch_config.global_batch_size
        return consumed // max(dataset_size, 1)

    # ---- data pipeline -----------------------------------------------------

    def device_prefetch(self, batches, device="cuda"):
        """Wrap a host-batch iterator (typically a
        ``PrefetchingDataLoader``) with double-buffered host-to-device
        copies: batch n+1's copy overlaps the step on batch n. Yields
        batches on ``device``; safe over reusable ring buffers."""
        from dlrover_tpu_torch.trainer.elastic.dataloader import (
            device_put_prefetch,
        )

        if self._flight_recorder is not None:
            self._flight_recorder.annotate(
                "device_prefetch_start", step=self.global_step
            )
        return device_put_prefetch(batches, device=device)

    # ---- restore -----------------------------------------------------------

    def restore_checkpoint(self, checkpointer, step=None, target=None):
        """Restore the newest (or ``step``) checkpoint, memory first,
        and adopt its step counter. ``target``: a tree whose tensors
        are filled in place (``Checkpointer.load_checkpoint``). Returns
        (state, user_meta) or None; the restore's seconds and bandwidth
        land in the flight recorder."""
        t0 = time.time()
        result = checkpointer.load_checkpoint(step=step, target=target)
        if result is None:
            logger.info("no restorable checkpoint; starting fresh")
            return None
        restored_step, state, user_meta = result
        elapsed = max(time.time() - t0, 1e-9)
        self.global_step = int(restored_step)
        if self._flight_recorder is not None:
            from dlrover_tpu_torch.flash_ckpt.engine import state_nbytes

            self._flight_recorder.annotate(
                "ckpt_restore",
                step=self.global_step,
                seconds=round(elapsed, 4),
                mb_per_s=round(state_nbytes(state) / 1e6 / elapsed, 1),
            )
        logger.info(
            "restored checkpoint step %d in %.2fs", restored_step, elapsed
        )
        return state, user_meta
