"""device_idle_share.simt: ``readers.train_idle_share`` in the SimT step's cells."""

from benchmark.readers import train_idle_share as read  # noqa: F401
