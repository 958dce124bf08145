"""mfu.warmup: ``readers.train_mfu`` in the warmup step's cells."""

from benchmark.readers import train_mfu as read  # noqa: F401
