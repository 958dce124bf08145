"""loss_core_launches.simt: a SimT step's B2 / B3 launches,
read beside ``loss_core_roofline.train``."""

from benchmark.readers import LOSS_CORE, launches


def read(rec):
    return launches(rec, "train", LOSS_CORE)
