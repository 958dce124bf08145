"""setup_s: seconds from the start of the run to the window: imports, weights and
inputs made on the device, the port's kernels built (first run of a checkout) and
loaded, the first steps or calls that warm every shape up."""

from benchmark.readers import on_card


def read(rec):
    return rec["setup_s"] if on_card(rec) else None
