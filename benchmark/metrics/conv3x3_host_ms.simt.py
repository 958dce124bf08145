"""conv3x3_host_ms.simt: host ms a SimT step inside the program's ``conv3x3`` ranges
(the B4 / B5 wrappers' calls, forward and backward; the union of their intervals) in
the host-traced session."""

from benchmark.program_spans import host_ms


def read(rec):
    return host_ms(rec, "train", "conv3x3")
