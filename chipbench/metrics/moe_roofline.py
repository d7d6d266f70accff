"""K5 and K5-bwd's share of their roofline: the least time of a rank's
routed expert work in a step (top_k x tokens rows, ``cb.work.
moe_routed_work``), over the device time of the expert kernels a step,
whatever they compute beyond the routed rows."""
from cb import trace, work

# K5 and K5-bwd (``repro_torch.kernels.moe_gmm``): the forward's variants
# and the backward's dx and dw
MOE = (r"(?<![A-Za-z0-9_])(gmm_(f32|bf16|wgmma|swap)_kernel"
       r"|gmm_bwd_wgmma_kernel|gemm_(bf16|f32)_kernel)")


def read(run):
    if not run.traces or not run.cell.config.get("num_experts"):
        return None
    us = trace.per_step_us(run.traces, MOE)
    if us <= 0:
        return None
    least = work.least_seconds(*work.moe_routed_work(
        run.cell.config, run.rows_per_rank, run.cell.seq_len))
    return 100.0 * least / (us / 1e6)
