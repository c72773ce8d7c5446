"""Observability of the port: the metrics registry."""
