"""launches_per_step.warmup: ``readers.launches_per_step`` in the warmup step's cells."""

from benchmark.readers import launches_per_step as read  # noqa: F401
