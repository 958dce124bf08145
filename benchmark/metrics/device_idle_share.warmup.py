"""device_idle_share.warmup: ``readers.train_idle_share`` in the warmup step's cells."""

from benchmark.readers import train_idle_share as read  # noqa: F401
