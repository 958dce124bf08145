"""launches_per_step.simt: ``readers.launches_per_step`` in the SimT step's cells."""

from benchmark.readers import launches_per_step as read  # noqa: F401
