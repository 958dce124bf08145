"""conv3x3_launches.simt: ``readers.train_conv3x3_launches`` in the SimT step's cells."""

from benchmark.readers import train_conv3x3_launches as read  # noqa: F401
