"""mfu.eval: the configuration's counted FLOPs an evaluated image (both scales'
forwards) times the window's images, over its wall seconds and the bf16 peak, in
percent."""

from benchmark.readers import mfu


def read(rec):
    return mfu(rec, "eval")
