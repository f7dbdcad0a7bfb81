"""Metric readers, one module a metric (its name up to the first dot).
Each has ``read(record) -> float | None`` over a ``harness.Record``."""
