"""conv3x3_launches.eval: an eval call's B4 launches,
read beside ``conv3x3_roofline.eval``."""

from benchmark.readers import CONV3X3, launches


def read(rec):
    return launches(rec, "eval", CONV3X3)
