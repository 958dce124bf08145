"""cast_copy_ms.warmup: ``readers.cast_copy_ms`` in the warmup step's cells."""

from benchmark.readers import cast_copy_ms as read  # noqa: F401
