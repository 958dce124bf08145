"""host_ms_per_step.warmup: ``readers.host_ms_per_step`` in the warmup step's cells."""

from benchmark.readers import host_ms_per_step as read  # noqa: F401
