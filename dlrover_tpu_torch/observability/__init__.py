"""Observability of the port: the metrics registry, the flight
recorder's event ring and the span layer (``tracing``)."""
