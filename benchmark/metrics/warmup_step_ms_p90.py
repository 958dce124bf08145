"""warmup_step_ms_p90: ``readers.train_step_ms_p90`` in the warmup step's cells."""

from benchmark.readers import train_step_ms_p90 as read  # noqa: F401
