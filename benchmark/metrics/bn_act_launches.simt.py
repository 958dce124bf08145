"""bn_act_launches.simt: a SimT step's launches of the fused eval-mode BatchNorm kernel
(``bn_fw_act`` in its name): the frozen teacher's forward, 104 (the student trains, so
its BatchNorm never takes the kernel). None where no launch holds the name, as on a
program without the kernel."""

from benchmark.readers import session

WORD = "bn_fw_act"


def read(rec):
    s = session(rec, "train")
    if s is None:
        return None
    n = sum(1 for name, _, _ in s["ops"] if WORD in name.lower())
    return n / s["calls"] if n else None
