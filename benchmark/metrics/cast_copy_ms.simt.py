"""cast_copy_ms.simt: ``readers.cast_copy_ms`` in the SimT step's cells."""

from benchmark.readers import cast_copy_ms as read  # noqa: F401
