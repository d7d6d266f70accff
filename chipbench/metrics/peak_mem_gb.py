"""``torch.cuda.max_memory_allocated`` over the window (reset at its
start), the largest over the ranks."""


def read(run):
    return run.window_peak / 1e9 if run.window_peak > 0 else None
