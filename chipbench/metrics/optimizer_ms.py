"""Device ms a step of the kernels of ``aten::_foreach_*`` ops: AdamW's
passes (``repro_torch.optim.adamw``) and its clip's norm, the mean over
the ranks.  They are told by name: the foreach ops' CUDA path launches
``multi_tensor_apply_kernel`` and nothing else does."""
from cb import trace

FOREACH = r"multi_tensor_apply_kernel"


def read(run):
    if not run.traces:
        return None
    us = trace.per_step_us(run.traces, FOREACH)
    return us / 1e3 if us > 0 else None
