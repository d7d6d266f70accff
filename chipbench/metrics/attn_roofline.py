"""K1 and K1-bwd's share of their roofline: the least time of a rank's
causal attention work in a step (``cb.work.attention_work``: operations at
the bf16 peak or bytes at the HBM peak, whichever is longer), over the
device time of the attention kernels a step."""
from cb import trace, work

# K1 and K1-bwd (``repro_torch.kernels.flash_attention``): the forward,
# and the backward's three launches
ATTENTION = (r"(?<![A-Za-z0-9_])(flash_attn_(bf16|f32)_kernel|delta_kernel"
             r"|dkdv_(wgmma|f32)_kernel|dq_(wgmma|f32)_kernel)")


def read(run):
    if not run.traces:
        return None
    us = trace.per_step_us(run.traces, ATTENTION)
    if us <= 0:
        return None
    least = work.least_seconds(*work.attention_work(
        run.cell.config, run.rows_per_rank, run.cell.seq_len))
    return 100.0 * least / (us / 1e6)
