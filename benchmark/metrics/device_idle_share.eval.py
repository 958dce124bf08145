"""device_idle_share.eval: the same over a few eval calls, in percent."""

from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec, "eval")
