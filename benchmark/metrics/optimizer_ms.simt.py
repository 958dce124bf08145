"""optimizer_ms.simt: ``readers.optimizer_ms`` in the SimT step's cells."""

from benchmark.readers import optimizer_ms as read  # noqa: F401
