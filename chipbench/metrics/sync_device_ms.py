"""Device ms a step of the NCCL kernels, the mean over the ranks."""
from cb import trace

NCCL = r"(?i)nccl"


def read(run):
    if run.chips < 2 or not run.traces:
        return None
    us = trace.per_step_us(run.traces, NCCL)
    return us / 1e3 if us > 0 else None
