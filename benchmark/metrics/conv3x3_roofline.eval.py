"""conv3x3_roofline.eval: the bound of an eval call's B4 calls (both scales'
forwards) over their device ms, in percent."""

from benchmark.readers import conv3x3_roofline


def read(rec):
    return conv3x3_roofline(rec, "eval")
