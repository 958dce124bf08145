"""host_ms_per_step.simt: ``readers.host_ms_per_step`` in the SimT step's cells."""

from benchmark.readers import host_ms_per_step as read  # noqa: F401
