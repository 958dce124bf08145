"""simt_step_ms_p90: ``readers.train_step_ms_p90`` in the SimT step's cells."""

from benchmark.readers import train_step_ms_p90 as read  # noqa: F401
