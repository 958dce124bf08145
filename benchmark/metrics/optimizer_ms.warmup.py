"""optimizer_ms.warmup: ``readers.optimizer_ms`` in the warmup step's cells."""

from benchmark.readers import optimizer_ms as read  # noqa: F401
