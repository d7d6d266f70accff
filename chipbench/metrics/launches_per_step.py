"""Device kernels launched a step (the profiler's count of device
activities over the traced steps), the mean over the ranks."""


def read(run):
    if not run.traces:
        return None
    vals = [sum(c for c, _ in t["kernels"].values()) / t["steps"]
            for t in run.traces]
    return sum(vals) / len(vals)
