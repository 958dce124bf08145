"""loss_core_host_ms.simt: host ms a SimT step inside the program's ``loss_core`` ranges
(the B2 / B3 wrappers' calls, forward and backward; the union of their intervals) in
the host-traced session."""

from benchmark.program_spans import host_ms


def read(rec):
    return host_ms(rec, "train", "loss_core")
