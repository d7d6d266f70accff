"""repro_torch.obs — tracing and telemetry of the port's planning layers.

The observability layer of the five-layer engine, copied from
``repro.obs``:

  * ``obs.trace``  — span/counter/instant recorder + Chrome Trace Event
    (Perfetto) export; ``python -m repro_torch.obs.export`` converts
    persisted report JSON;
  * ``obs.meters`` — deterministic counters threaded through FlowSim
    memoization and the synthesizer's cache;
  * ``obs.probe``  — wall-clock spans of the port's executable
    collectives on the ranks of a ``torch.distributed`` group, next to
    ``ccl.cost``'s predictions (imported by name: it is the one module
    here that runs collectives).
"""
from repro_torch.obs.meters import Meters
from repro_torch.obs.trace import (EXPOSED_CNAME, Trace, timeline_tracks,
                                   trace_from_cluster, trace_from_dynamics,
                                   trace_from_report, trace_from_search,
                                   trace_from_serving, validate_chrome)

__all__ = [
    "Meters", "Trace", "EXPOSED_CNAME", "timeline_tracks",
    "trace_from_report", "trace_from_search", "trace_from_cluster",
    "trace_from_dynamics", "trace_from_serving", "validate_chrome",
]
