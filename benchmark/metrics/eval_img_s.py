"""eval_img_s: images evaluated over the window: both scales' forwards and B1 into the
running histogram, over the wall seconds from the first call to the read of the
histogram."""

from benchmark.readers import kind, on_card


def read(rec):
    if kind(rec) != "eval" or not on_card(rec):
        return None
    win = rec["window"]
    return win["images"] / win["wall_s"]
