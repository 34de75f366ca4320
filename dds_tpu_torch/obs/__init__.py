"""Observability of the port: trace context and kernel profiling hooks."""
