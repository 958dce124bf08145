"""conv3x3_roofline.warmup: ``readers.train_conv3x3_roofline`` in the warmup step's cells."""

from benchmark.readers import train_conv3x3_roofline as read  # noqa: F401
