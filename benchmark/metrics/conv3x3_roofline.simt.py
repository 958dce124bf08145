"""conv3x3_roofline.simt: ``readers.train_conv3x3_roofline`` in the SimT step's cells."""

from benchmark.readers import train_conv3x3_roofline as read  # noqa: F401
