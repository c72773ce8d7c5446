"""Per-verb RPC telemetry for the master control plane (DESIGN.md §32).

Every ``get``/``report`` the servicer dispatches lands in four
bounded-cardinality metric families:

- ``master_rpc_seconds{verb}`` — end-to-end dispatch latency histogram
  (deserialize + admission + handler + serialize), with p50/p95/p99
  precomputed at /metrics by the prom exposition;
- ``master_rpc_inflight{verb}`` + ``master_rpc_inflight_high_water`` —
  concurrent dispatches right now, and the worst depth ever seen;
- ``master_rpc_errors_total{verb,kind}`` — handler exceptions by
  exception class, plus the ``no_handler`` protocol error;
- ``master_rpc_dropped_total{verb}`` — requests answered without
  running their handler (overload shed, see ``master/overload.py``).

plus the handler-internal split ``master_rpc_phase_seconds{phase}``
(``deserialize`` / ``handler`` / ``serialize``) — aggregated across
verbs so the family stays three children — which is how lock
contention shows up: a slow verb whose ``handler`` phase dominates is
waiting on a manager lock, not on pickle.

**Cardinality is bounded by construction**: the ``verb`` label only
ever takes values from the servicer's registered handler tables plus
one ``other`` bucket (:data:`OTHER_VERB`); an attacker (or a newer
client) sending unknown request types cannot grow the exposition. The
documented family cap is :data:`MAX_VERB_LABELS` label values.

``master_rpc_cpu_seconds_total`` accumulates *thread* CPU spent inside
dispatch — the load harness divides it by the RPC count for the
"master CPU per 1k RPCs/s" bench number without needing the master in
its own process.

The port's copy of ``dlrover_tpu/master/rpc_metrics.py``.
"""

import threading
import time
from typing import Dict, Iterable, List, Optional

from dlrover_tpu_torch.observability.registry import default_registry

OTHER_VERB = "other"

# Documented cap on distinct ``verb`` label values (registered handler
# types + the collapse bucket). The servicer registers ~40 verbs today;
# the test suite asserts the exposition stays under this bound even
# when flooded with unknown request types.
MAX_VERB_LABELS = 64

# Control-plane handlers run in the tens-of-microseconds to
# tens-of-milliseconds band; the registry defaults start at 5ms and
# would flatten every healthy verb into the first bucket.
RPC_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

PHASE_DESERIALIZE = "deserialize"
PHASE_HANDLER = "handler"
PHASE_SERIALIZE = "serialize"


class RpcTelemetry:
    """One per servicer; all methods thread-safe and cheap (the HTTP
    transport dispatches from a thread per connection)."""

    def __init__(self, known_verbs: Iterable[str],
                 registry=None):
        self._known = frozenset(str(v) for v in known_verbs)
        if len(self._known) + 1 > MAX_VERB_LABELS:
            raise ValueError(
                f"{len(self._known)} registered verbs exceed the "
                f"documented {MAX_VERB_LABELS}-label cardinality cap"
            )
        reg = registry or default_registry()
        self.seconds = reg.histogram(
            "master_rpc_seconds",
            "end-to-end master RPC dispatch latency per verb",
            labelnames=("verb",),
            buckets=RPC_BUCKETS,
        )
        self.phase_seconds = reg.histogram(
            "master_rpc_phase_seconds",
            "dispatch split: deserialize / handler / serialize",
            labelnames=("phase",),
            buckets=RPC_BUCKETS,
        )
        self.inflight = reg.gauge(
            "master_rpc_inflight",
            "RPCs currently being dispatched, per verb",
            labelnames=("verb",),
        )
        self.inflight_high_water = reg.gauge(
            "master_rpc_inflight_high_water",
            "worst concurrent-dispatch depth seen since start",
        )
        self.errors = reg.counter(
            "master_rpc_errors_total",
            "handler failures per verb and exception kind",
            labelnames=("verb", "kind"),
        )
        self.dropped = reg.counter(
            "master_rpc_dropped_total",
            "requests answered without running their handler "
            "(overload shed)",
            labelnames=("verb",),
        )
        self.cpu_seconds = reg.counter(
            "master_rpc_cpu_seconds_total",
            "thread CPU seconds spent inside RPC dispatch",
        )
        self._lock = threading.Lock()
        self._inflight_total = 0
        self._high_water = 0
        self._rpcs_total = 0

    # ---- verb normalization ------------------------------------------------

    def verb(self, request_type_name: str) -> str:
        """Collapse unknown request types into ``other`` so the label
        set stays bounded no matter what arrives on the wire."""
        return (
            request_type_name
            if request_type_name in self._known
            else OTHER_VERB
        )

    # ---- dispatch lifecycle ------------------------------------------------

    def begin(self, verb: str) -> None:
        self.inflight.inc(verb=verb)
        with self._lock:
            self._inflight_total += 1
            if self._inflight_total > self._high_water:
                self._high_water = self._inflight_total
                self.inflight_high_water.set(self._high_water)

    def end(
        self,
        verb: str,
        total_s: float,
        deserialize_s: float = 0.0,
        handler_s: Optional[float] = None,
        serialize_s: float = 0.0,
        cpu_s: float = 0.0,
        error_kind: Optional[str] = None,
        dropped: bool = False,
    ) -> None:
        """``handler_s=None`` means the handler never ran (shed /
        no-handler): no handler-phase sample, so an overload episode's
        flood of shed replies cannot drag the handler split toward
        zero and mask real handler slowness. A shed (``dropped``) RPC
        is likewise excluded from ``master_rpc_seconds`` entirely —
        its microsecond fast-path would collapse the verb's quantiles
        toward zero exactly while its traffic is being dropped; the
        dropped counter is its record."""
        self.inflight.dec(verb=verb)
        with self._lock:
            self._inflight_total = max(self._inflight_total - 1, 0)
            self._rpcs_total += 1
        if not dropped:
            self.seconds.observe(max(total_s, 0.0), verb=verb)
        self.phase_seconds.observe(
            max(deserialize_s, 0.0), phase=PHASE_DESERIALIZE
        )
        if handler_s is not None:
            self.phase_seconds.observe(
                max(handler_s, 0.0), phase=PHASE_HANDLER
            )
        self.phase_seconds.observe(
            max(serialize_s, 0.0), phase=PHASE_SERIALIZE
        )
        if cpu_s > 0:
            self.cpu_seconds.inc(cpu_s)
        if error_kind is not None:
            self.errors.inc(verb=verb, kind=str(error_kind)[:64])
        if dropped:
            self.dropped.inc(verb=verb)

    # ---- read side ---------------------------------------------------------

    def inflight_now(self) -> int:
        with self._lock:
            return self._inflight_total

    def rpcs_total(self) -> int:
        with self._lock:
            return self._rpcs_total

    def high_water(self) -> int:
        with self._lock:
            return self._high_water

    def cpu_seconds_total(self) -> float:
        return self.cpu_seconds.value()

    def verb_names(self) -> List[str]:
        return sorted(self._known) + [OTHER_VERB]

    def summary(self) -> Dict:
        """Per-verb latency/volume table for ``/api/control_plane`` and
        the load harness (only verbs that have actually been seen)."""
        verbs: Dict[str, Dict] = {}
        for name, labels, value in self.seconds.samples():
            if not name.endswith("_count"):
                continue
            verb = labels.get("verb", "")
            if value <= 0:
                continue
            verbs[verb] = {
                "count": int(value),
                "mean_s": self.seconds.sum(verb=verb) / value,
                "p50_s": self.seconds.quantile(0.5, verb=verb),
                "p95_s": self.seconds.quantile(0.95, verb=verb),
                "p99_s": self.seconds.quantile(0.99, verb=verb),
                "errors": _label_total(self.errors, "verb", verb),
                "dropped": self.dropped.value(verb=verb),
                "inflight": self.inflight.value(verb=verb),
            }
        # A verb that has ONLY ever been shed has no latency samples
        # but must still surface — its drop count IS its story.
        for _name, labels, value in self.dropped.samples():
            verb = labels.get("verb", "")
            if value > 0 and verb not in verbs:
                verbs[verb] = {
                    "count": 0, "mean_s": None, "p50_s": None,
                    "p95_s": None, "p99_s": None,
                    "errors": _label_total(self.errors, "verb", verb),
                    "dropped": value,
                    "inflight": self.inflight.value(verb=verb),
                }
        return {
            "rpcs_total": self.rpcs_total(),
            "inflight": self.inflight_now(),
            "inflight_high_water": self.high_water(),
            "cpu_seconds_total": round(self.cpu_seconds_total(), 6),
            "verb_cap": MAX_VERB_LABELS,
            "verbs": verbs,
        }


def _label_total(counter, label: str, value: str) -> float:
    total = 0.0
    for _name, labels, v in counter.samples():
        if labels.get(label) == value:
            total += v
    return total


_MONO = time.monotonic
_THREAD_TIME = getattr(time, "thread_time", time.monotonic)


def clocks() -> tuple:
    """(monotonic, thread_cpu) sampled together — the servicer's
    dispatch timer."""
    return _MONO(), _THREAD_TIME()
