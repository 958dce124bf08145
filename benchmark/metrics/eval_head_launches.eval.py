"""eval_head_launches.eval: an eval call's B1 launches,
read beside ``eval_head_roofline.eval``."""

from benchmark.readers import B1, launches


def read(rec):
    return launches(rec, "eval", B1)
