"""loss_core_roofline.simt: the bound of B2 + B3 (frozen work() and bound()) over their
device ms, in percent. The work takes ``labelled`` from each step's own labels and counts
every head-pixel as ``place`` (the data decides how many the kernels need), so the
work, and with it the share, is an upper bound. The kernels' recorded device ms are
summed, however many launches carry the work."""

from benchmark.frozen import work
from benchmark.readers import LOSS_CORE, logits_hw, session, whole_ms


def read(rec):
    s = session(rec, "train")
    if s is None or rec["config"]["stage"] != "simt":
        return None
    ms = whole_ms(s, LOSS_CORE)
    if ms is None:
        return None
    m, mix = rec["config"]["model"], rec["mix"]
    h8, w8 = logits_hw(mix["hw"], m["layers"])
    bound_s = 0.0
    for labelled in s["labelled"]:
        w = work.loss_core_work(mix["batch"], h8, w8, *mix["hw"], m["num_classes"],
                                m["open_classes"], place=None, labelled=labelled)
        bound_s += work.bound(*w["fwd"])[0] + work.bound(*w["bwd"])[0]
    return 100.0 * bound_s * 1e3 / ms
