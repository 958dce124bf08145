"""simt_img_s: ``readers.train_img_s`` in the SimT step's cells."""

from benchmark.readers import train_img_s as read  # noqa: F401
