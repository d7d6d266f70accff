"""Parallel strategies of the port (``repro.parallel``): the data axes,
plain DP and ZeRO-1, and expert parallelism of the MoE layers over a model
axis (``planner``)."""
from repro_torch.parallel.planner import (  # noqa: F401
    BUCKET_BYTES,
    FlatLayout,
    ParallelCtx,
    expert_flags,
    flat_layout,
    gather_params,
    make_ctx,
    microbatch_rows,
    shard_params,
)
