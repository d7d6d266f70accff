"""Parallel strategies of the port (``repro.parallel``): the data axes,
plain DP, ZeRO-1 and FSDP (``fsdp``), tensor parallelism of every layer
over a model axis and expert parallelism of the MoE layers beside it
(``planner``, ``tensor``), the decode cache's slots split over the data
axes (``sequence``), collective matmul (``collective_matmul``) and the
GPipe and interleaved pipelines (``pipeline``)."""
from repro_torch.parallel.planner import (  # noqa: F401
    BUCKET_BYTES,
    FlatLayout,
    ParallelCtx,
    batch_specs,
    cache_specs,
    expert_flags,
    flat_layout,
    gather_params,
    make_ctx,
    microbatch_rows,
    model_flags,
    param_specs,
    shard_params,
    validate_spec,
)
