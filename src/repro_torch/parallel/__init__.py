"""Parallel strategies of the port (``repro.parallel``): the data axes,
plain DP, ZeRO-1 and FSDP (``fsdp``), tensor parallelism of every layer
over a model axis and expert parallelism of the MoE layers beside it
(``planner``, ``tensor``), collective matmul (``collective_matmul``) and
the GPipe and interleaved pipelines (``pipeline``)."""
from repro_torch.parallel.planner import (  # noqa: F401
    BUCKET_BYTES,
    FlatLayout,
    ParallelCtx,
    expert_flags,
    flat_layout,
    gather_params,
    make_ctx,
    microbatch_rows,
    model_flags,
    shard_params,
)
