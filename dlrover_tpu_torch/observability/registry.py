"""Process-wide, thread-safe metrics registry (the port's own copy of
``dlrover_tpu/observability/registry.py``).

Counter, gauge and histogram families with labels. Registration is
idempotent: asking for an existing family name returns the existing
collector, but re-registering under a different metric type, label set
or bucket layout is a programming error and raises.
"""

import threading
from typing import Dict, Iterable, List, Optional, Tuple

_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


class _Family:
    """Base: a named metric with labelled children."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], float] = {}
        if not self.labelnames:
            # A label-less family exposes its zero immediately: on a
            # scrape, "0 drops" and "metric missing" must not look the
            # same.
            self._children[()] = 0.0

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != "
                f"declared {sorted(self.labelnames)}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)


class Counter(_Family):
    """Monotonically increasing counter."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._children.get(key, 0.0)


class Gauge(_Family):
    """Set-to-current-value metric."""

    kind = "gauge"

    def set(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._children.get(key, 0.0)


class Histogram(_Family):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: Tuple[str, ...],
        buckets: Tuple[float, ...] = _DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_text, labelnames)
        self.buckets = tuple(sorted(buckets))
        # child -> [bucket counts..., +Inf count, sum]
        self._hist: Dict[Tuple[str, ...], List[float]] = {}
        if not self.labelnames:
            self._hist[()] = [0.0] * (len(self.buckets) + 2)

    def observe(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            state = self._hist.get(key)
            if state is None:
                state = [0.0] * (len(self.buckets) + 2)
                self._hist[key] = state
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    state[i] += 1
            state[len(self.buckets)] += 1  # +Inf / count
            state[len(self.buckets) + 1] += value  # sum

    def count(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            state = self._hist.get(key)
            return state[len(self.buckets)] if state else 0.0


class MetricsRegistry:
    """Family registry; one per process via :func:`default_registry`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _register(self, cls, name, help_text, labelnames, **kwargs):
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}"
                    )
                # Mismatched declarations must fail HERE, at the
                # conflicting registration — not later as a label
                # ValueError on some unrelated update path.
                if tuple(labelnames) != existing.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"labels {existing.labelnames}, not "
                        f"{tuple(labelnames)}"
                    )
                buckets = kwargs.get("buckets")
                if (
                    buckets is not None
                    and tuple(sorted(buckets)) != existing.buckets
                ):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {existing.buckets}"
                    )
                return existing
            if "buckets" in kwargs and kwargs["buckets"] is None:
                kwargs["buckets"] = _DEFAULT_BUCKETS
            family = cls(name, help_text, tuple(labelnames), **kwargs)
            self._families[name] = family
            return family

    def counter(
        self, name: str, help_text: str = "", labelnames: Iterable[str] = ()
    ) -> Counter:
        return self._register(Counter, name, help_text, labelnames)

    def gauge(
        self, name: str, help_text: str = "", labelnames: Iterable[str] = ()
    ) -> Gauge:
        return self._register(Gauge, name, help_text, labelnames)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labelnames: Iterable[str] = (),
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> Histogram:
        """``buckets=None`` means "no opinion": accept an existing
        family's buckets, or the defaults when creating — so modules
        can fetch a histogram without knowing who declared it."""
        return self._register(
            Histogram, name, help_text, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
