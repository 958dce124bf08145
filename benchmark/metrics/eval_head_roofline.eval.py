"""eval_head_roofline.eval: the bound of B1 (frozen work(): both scales' logits, uint8
gt, the labelled pixels of each call's own gt) over its recorded device ms, in
percent."""

from benchmark.frozen import work
from benchmark.readers import B1, logits_hw, session, whole_ms


def read(rec):
    s = session(rec, "eval")
    if s is None:
        return None
    ms = whole_ms(s, B1)
    if ms is None:
        return None
    m, mix = rec["config"]["model"], rec["mix"]
    (ha, wa), (hb, wb) = (logits_hw(hw, m["layers"]) for hw in mix["scales"])
    bound_s = sum(work.bound(*work.eval_head_work(ha, wa, hb, wb, tuple(mix["out_hw"]),
                                                  m["num_classes"], mix["batch"], c,
                                                  gt_bytes=1), 0)[0]
                  for c in s["counted"])
    return 100.0 * bound_s * 1e3 / ms
