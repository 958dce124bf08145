"""conv3x3_host_ms.warmup: host ms a warmup step inside the program's ``conv3x3`` ranges
(the union of their intervals) in the host-traced session."""

from benchmark.program_spans import host_ms


def read(rec):
    return host_ms(rec, "train", "conv3x3")
