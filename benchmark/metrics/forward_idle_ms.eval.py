"""forward_idle_ms.eval: device idle ms an eval call in the host-traced session's gaps
that begin inside the program's ranges ``eval_forward`` (each scale's forward)."""

from benchmark.program_spans import idle_ms


def read(rec):
    return idle_ms(rec, "eval", ("eval_forward",))
