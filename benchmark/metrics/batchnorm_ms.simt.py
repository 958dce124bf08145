"""batchnorm_ms.simt: ``readers.batchnorm_ms`` in the SimT step's cells."""

from benchmark.readers import batchnorm_ms as read  # noqa: F401
