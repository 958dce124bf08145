"""conv3x3_launches.warmup: ``readers.train_conv3x3_launches`` in the warmup step's cells."""

from benchmark.readers import train_conv3x3_launches as read  # noqa: F401
