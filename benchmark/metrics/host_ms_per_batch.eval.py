"""host_ms_per_batch.eval: host ms from a predict_hist call to its return, the mean over
the untraced window."""

from benchmark.readers import kind, mean, on_card


def read(rec):
    if kind(rec) != "eval" or not on_card(rec):
        return None
    return mean(rec["window"]["host_ms"])
