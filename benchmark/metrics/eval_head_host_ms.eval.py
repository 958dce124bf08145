"""eval_head_host_ms.eval: host ms an eval call inside the program's ``eval_head`` range
(the B1 wrapper's call: both scales' argmax and the histogram) in the host-traced
session."""

from benchmark.program_spans import host_ms


def read(rec):
    return host_ms(rec, "eval", "eval_head")
