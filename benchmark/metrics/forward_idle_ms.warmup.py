"""forward_idle_ms.warmup: device idle ms a warmup step in the host-traced session's gaps
that begin inside the program's range ``forward``."""

from benchmark.program_spans import idle_ms


def read(rec):
    return idle_ms(rec, "train", ("forward",))
