"""bn_act_launches.eval: an eval call's launches of the fused eval-mode BatchNorm kernel
(``bn_fw_act`` in its name): 104 a forward of the trunk (the stem, bn1 / bn2 / bn3 of
33 bottlenecks, 4 downsamples), two scales a call. None where no launch holds the name,
as on a program without the kernel."""

from benchmark.readers import session

WORD = "bn_fw_act"


def read(rec):
    s = session(rec, "eval")
    if s is None:
        return None
    n = sum(1 for name, _, _ in s["ops"] if WORD in name.lower())
    return n / s["calls"] if n else None
