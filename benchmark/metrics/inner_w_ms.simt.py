"""inner_w_ms.simt: device ms a step of the SimT step's span "inner_w" (the inner W
loop), CUDA events of the program's own spans over a few steps after the window."""


def read(rec):
    return rec.get("spans", {}).get("inner_w")
