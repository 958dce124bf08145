"""mfu.simt: ``readers.train_mfu`` in the SimT step's cells."""

from benchmark.readers import train_mfu as read  # noqa: F401
