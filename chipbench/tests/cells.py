"""Small cells for the CPU tests: each of the benchmark's cells, and the
four-chip ZeRO-1 cell that ``BENCHMARK.json`` leaves out until its windows
run steady, with its configuration cut to a few hundred thousand
parameters and its sequences to 64 tokens, its traffic, end-to-end and
per-layer metrics and limits as committed."""
from __future__ import annotations

import copy

from cb import spec

SMALL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 500}
SMALL_MOE = {"num_layers": 1, "d_model": 64, "num_heads": 4,
             "num_kv_heads": 2, "head_dim": 16, "d_ff": 96, "moe_d_ff": 96,
             "vocab_size": 500, "num_experts": 4, "top_k": 2}


# the four-chip cell's entries; its traffic and limits files
# are committed under ``workloads/`` and ``limits/``
DP4 = {"name": "dbrx-1l-zero1-dp4", "config": "dbrx-132b-1l",
       "traffic": "zero1-dp4-b1-s4096", "chips": 4,
       "why": "B 1 x S 4096 a rank on 4 NCCL ranks, ZeRO-1, bf16 gradients: "
              "the reduce-scatter and all-gather"}
SYNC_LAYER = "parallel.planner.FlatLayout, ccl.primitives rings (ZeRO-1 sync)"
DP4_METRICS = [
    {"name": "sync_wire_gb", "unit": "GB", "better": "lower",
     "source": "program_counter", "layer": SYNC_LAYER,
     "moves": "tokens_per_s", "workloads": [DP4["name"]]},
    {"name": "sync_device_ms", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": SYNC_LAYER,
     "moves": "tokens_per_s", "workloads": [DP4["name"]]}]


def with_dp4() -> dict:
    """``BENCHMARK.json`` with the four-chip cell's entries added."""
    bench = spec.load_benchmark()
    bench["workloads"].append(DP4)
    bench["per_layer"] += DP4_METRICS
    return bench


def small_cell(name: str, seq_len: int = 64):
    cell = copy.deepcopy(spec.find_cell(name, with_dp4()))
    cell.config.update(SMALL_MOE if cell.config.get("num_experts")
                       else SMALL)
    cell.traffic["seq_len"] = seq_len
    return cell
