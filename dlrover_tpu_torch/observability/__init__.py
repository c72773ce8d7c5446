"""Observability of the port: the metrics registry, the flight
recorder (its event ring and crash and on-demand dumps), the hang
watchdog and the span layer (``tracing``)."""
