"""Brain evaluators + optimize processor.

Parity: reference go/brain's processor/evaluator architecture
(docs/design/brain.md; go/brain/pkg — an OptimizeProcessor selects
algorithm plugins and JobEvaluators turn raw datastore metrics into
assessments that feed the final plan). Scaled to this repo's metric
vocabulary: evaluators read the BrainStore's runtime samples
({job_name, worker_count, speed, ...}) and completion records
({job_name, worker_count, success, exit_reason, ...}) and each returns
one assessment dict; the processor runs the configured set plus the
resource optimizer and assembles the OptimizeResponse.

Evaluators are pluggable exactly like optimizers: registry names or
``pkg.module:factory`` dotted paths (factory takes the store, returns
an object with ``evaluate(job_name) -> Optional[dict]``).

The port's copy of ``dlrover_tpu/brain/evaluators.py``.
"""

from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger


def _runtime_samples(store, job_name: str, runtime=None) -> List[Dict]:
    if runtime is None:
        runtime = store.load("runtime", job_name=job_name)
    out = []
    for s in runtime:
        try:
            if float(s.get("speed", 0)) > 0:
                out.append(s)
        except (TypeError, ValueError):
            continue
    return out


class ThroughputTrendEvaluator:
    """Is this job slowing down? Least-squares slope over the newest
    samples, normalized by the mean — a sustained negative trend is the
    degradation signal the reference's trend evaluators raise (node
    slowdowns, creeping stragglers, thermal throttling)."""

    name = "throughput_trend"

    def __init__(self, store, window: int = 20):
        self._store = store
        self._window = window

    def evaluate(self, job_name: str, runtime=None,
                 completions=None) -> Optional[Dict]:
        samples = _runtime_samples(self._store, job_name, runtime)
        speeds = [float(s["speed"]) for s in samples][-self._window:]
        if len(speeds) < 4:
            return None
        n = len(speeds)
        xs = range(n)
        mx, my = (n - 1) / 2.0, sum(speeds) / n
        cov = sum((x - mx) * (y - my) for x, y in zip(xs, speeds))
        var = sum((x - mx) ** 2 for x in xs)
        slope = cov / var if var else 0.0
        rel = slope / my if my else 0.0
        return {
            "evaluator": self.name,
            "samples": n,
            "relative_slope_per_sample": round(rel, 5),
            "degrading": rel < -0.01,
        }


class StragglerEvaluator:
    """Throughput dispersion at a fixed worker count: high variance
    between samples of the SAME configuration is the straggler/flaky-
    host signature (a healthy job's speed is stable)."""

    name = "straggler"

    def __init__(self, store, threshold: float = 0.15):
        self._store = store
        self._threshold = threshold

    def evaluate(self, job_name: str, runtime=None,
                 completions=None) -> Optional[Dict]:
        by_count: Dict[int, List[float]] = {}
        for s in _runtime_samples(self._store, job_name, runtime):
            try:
                by_count.setdefault(
                    int(s.get("worker_count", 0)), []
                ).append(float(s["speed"]))
            except (TypeError, ValueError):
                continue
        worst = 0.0
        for speeds in by_count.values():
            if len(speeds) < 3:
                continue
            mean = sum(speeds) / len(speeds)
            if mean <= 0:
                continue
            var = sum((x - mean) ** 2 for x in speeds) / len(speeds)
            worst = max(worst, (var ** 0.5) / mean)
        if worst == 0.0:
            return None
        return {
            "evaluator": self.name,
            "speed_cv": round(worst, 4),
            "suspected": worst > self._threshold,
        }


class OOMRiskEvaluator:
    """Fraction of this job's completions that died OOM; past the
    threshold the assessment carries the resource bump the reference's
    job optimizer would apply (the master's resource optimizer consumes
    the same signal locally — this is the cross-job memory of it)."""

    name = "oom_risk"

    def __init__(self, store, threshold: float = 0.2):
        self._store = store
        self._threshold = threshold

    def evaluate(self, job_name: str, runtime=None,
                 completions=None) -> Optional[Dict]:
        comps = (
            completions if completions is not None
            else self._store.load("completion", job_name=job_name)
        )
        if not comps:
            return None
        ooms = sum(
            1 for c in comps
            if str(c.get("exit_reason", "")).lower() == "oom"
        )
        frac = ooms / len(comps)
        out = {
            "evaluator": self.name,
            "completions": len(comps),
            "oom_fraction": round(frac, 4),
            "at_risk": frac >= self._threshold,
        }
        if out["at_risk"]:
            out["suggestion"] = "bump per-worker memory ~50% or escalate remat policy"  # noqa: E501
        return out


EVALUATORS = {
    "throughput_trend": ThroughputTrendEvaluator,
    "straggler": StragglerEvaluator,
    "oom_risk": OOMRiskEvaluator,
}


def load_plugin(name: str, registry: Dict, store, what: str):
    """Shared registry-or-dotted-path resolution for optimizer AND
    evaluator plugins (one contract: factory takes the store)."""
    if name in registry:
        return registry[name](store)
    if ":" in name:
        import importlib

        module, attr = name.split(":", 1)
        try:
            factory = getattr(importlib.import_module(module), attr)
        except (ImportError, AttributeError, ValueError) as e:
            raise ValueError(
                f"{what} plugin {name!r} failed to load ({e}); "
                f"expected pkg.module:factory or one of "
                f"{sorted(registry)}"
            ) from e
        return factory(store)
    raise ValueError(
        f"unknown {what} {name!r}; registry: {sorted(registry)} "
        f"or a pkg.module:factory path"
    )


def create_evaluator(name: str, store):
    return load_plugin(name, EVALUATORS, store, "evaluator")


class OptimizeProcessor:
    """The reference's processor: run the resource optimizer plus every
    configured evaluator and assemble one response. An evaluator
    failing must never take optimize() down with it."""

    @property
    def evaluator_names(self) -> List[str]:
        return [
            getattr(e, "name", type(e).__name__)
            for e, _ in self._evaluators
        ]

    def __init__(self, optimizer, evaluators, store=None):
        import inspect

        self._optimizer = optimizer
        self._store = store
        # Detect each evaluator's signature ONCE: a per-call
        # `except TypeError` would misread a genuine TypeError inside
        # an evaluator as a signature mismatch and run it twice.
        self._evaluators = []
        for ev in evaluators:
            try:
                params = inspect.signature(ev.evaluate).parameters
                wants_data = "runtime" in params or any(
                    p.kind == inspect.Parameter.VAR_KEYWORD
                    for p in params.values()
                )
            except (TypeError, ValueError):
                wants_data = False
            self._evaluators.append((ev, wants_data))

    def process(self, job_name: str) -> Dict:
        plan = None
        try:
            plan = self._optimizer.optimize(job_name)
        except Exception:  # noqa: BLE001 - degrade, don't 500
            logger.exception("optimizer failed for %s", job_name)
        # Prefetch ONCE: three evaluators each re-reading (and the
        # JSONL backend re-parsing) the whole store would triple the
        # request's load time and lock hold.
        runtime = completions = None
        if self._store is not None and self._evaluators:
            runtime = self._store.load("runtime", job_name=job_name)
            completions = self._store.load(
                "completion", job_name=job_name
            )
        assessments = []
        for ev, wants_data in self._evaluators:
            try:
                if wants_data:
                    a = ev.evaluate(
                        job_name, runtime=runtime,
                        completions=completions,
                    )
                else:  # external plugins may keep the simple signature
                    a = ev.evaluate(job_name)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "evaluator %s failed for %s",
                    getattr(ev, "name", type(ev).__name__), job_name,
                )
                continue
            if a is not None:
                assessments.append(a)
        return {"plan": plan, "assessments": assessments}
