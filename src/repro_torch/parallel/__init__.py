"""Parallel strategies of the port (``repro.parallel``): the data axes so
far, plain DP and ZeRO-1 (``planner``)."""
from repro_torch.parallel.planner import (  # noqa: F401
    BUCKET_BYTES,
    FlatLayout,
    ParallelCtx,
    flat_layout,
    make_ctx,
    microbatch_rows,
)
