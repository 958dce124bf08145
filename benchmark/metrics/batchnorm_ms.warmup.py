"""batchnorm_ms.warmup: ``readers.batchnorm_ms`` in the warmup step's cells."""

from benchmark.readers import batchnorm_ms as read  # noqa: F401
