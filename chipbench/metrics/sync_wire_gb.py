"""GB a rank sends a step through ``ccl.primitives._permute`` (the ZeRO-1
sync's reduce-scatter and all-gather rings, and the step's small
all-sums), over the steps outside the traced ones, the mean over the
ranks."""


def read(run):
    if run.chips < 2 or run.sent_per_step <= 0:
        return None
    return run.sent_per_step / 1e9
