"""inner_w_idle_ms.simt: device idle ms a SimT step in the host-traced session's gaps
that begin inside the program's range ``inner_w`` (the inner W loop)."""

from benchmark.program_spans import idle_ms


def read(rec):
    return idle_ms(rec, "train", ("inner_w",))
