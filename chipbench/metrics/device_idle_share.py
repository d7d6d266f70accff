"""The share of the traced span in which no device activity ran on any
stream (1 - the union of their intervals over the span), the mean over
the ranks."""


def read(run):
    if not run.traces:
        return None
    vals = [1.0 - t["busy_us"] / t["window_us"] for t in run.traces]
    return 100.0 * sum(vals) / len(vals)
