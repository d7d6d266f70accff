#!/usr/bin/env python3
"""Drives the PyTorch / H100 port's paths on one card and checks them.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and nothing else of the repo
but ``src/repro_torch``.  Phases, each printing JSON lines; any failure
exits non-zero:

1. build: compiles every kernel source from ``src/repro_torch`` with nvcc
   into ``build/`` (one nvcc per source, all started together).
2. kernels: each kernel against its plain PyTorch version on the card, at
   the JAX kernel tests' shapes, ragged ones and the paths' own; times at
   the paths' shapes beside the plain version, one PyTorch library call
   (where one exists) and the bound:
   - flash attention K1, SSD scan K6 (also at a long and a ragged L;
     timed with its launches a call, each of its three stages' device time
     from torch.profiler, and its bound on the tensor cores in 3xTF32
     beside the f32 one), grouped expert GEMM K5 (K1 also at seamless's
     B 2 x 1024 x 16 heads x 64, causal and non-causal on the model's
     views; K5 at deepseek-v2's 160 experts of ffn 1536, prefill and
     decode);
   - K1's gradient K1-bwd (three launches a call) over K1's sweep and at
     the training shape (B 4 x S 512, qwen2-0.5b's heads, bf16): f32
     within 2e-5 of the f64 gradient, bf16 within twice the plain
     version's bf16 error plus 1e-3; two calls bit-equal; timed at the
     training shape and at B 1 x S 4096, each launch's device time from
     torch.profiler, beside the plain version, SDPA's backward through
     autograd (the backend named) and its bound, with K1's forward timed
     with and without the row statistics;
   - K6's gradient K6-bwd (four launches a call, reading the forward's
     workspace) at mamba2-130m's training microbatch (B 4 x L 512, H 24,
     P 64, N 128, f32) and two odd shapes: each gradient within 5e-5 of
     its scale of the plain version and of f64 autograd, two calls
     bit-equal, each launch's device time; K5's gradient K5-bwd (two
     launches, dx and dw) at dbrx-132b's training step (E 16, T 512, x
     expanded; and the w_down product), an EP rank's dispatched (8, 160)
     tokens and a sweep (E 160 among it), f32 and bf16, against the plain
     version and (at the step) f64 autograd, beside ``torch.bmm`` of the
     same two products;
   - quantize K2a and dequantize K2b (q and decode bit-equal, scales
     within rtol 1e-6; K2b also bit-equal to torch.mul on each of its
     variants vec16 / vec4 / scalar), sparsify K3 (bit-equal) and the
     PowerSGD matmul K4 (atol and rtol 1e-5; at the path's k up to 152,064,
     1e-5 of |a|@|b|; every route, cols_bulk on the layouts it takes), at
     qwen2-0.5b's whole gradient in rows of 256, a ring chunk of a 64 MiB
     bucket and the embedding gradient's three projections (K3 also as
     the one row the payload-level sparsify passes); each kernel timed
     back to back (ms) and from a CUDA graph (graph_ms), the library call
     both ways.
3. Three serving paths, each at full width, each first in f32 for parity
   (prefill logits through the kernels against replaying the prompt
   through decode_step, at every position, and the greedy next token),
   then in bf16 through the entry points a user calls (make_prefill on
   batches of prompts, then a ContinuousBatcher answering requests, one
   admitted mid-flight), with the launch counts set to 0 just before and
   read just after:
   - qwen2-0.5b, 24 layers (dense GQA: K1);
   - mamba2-130m, 24 layers (SSM: K6);
   - dbrx-132b cut to 2 layers for parity and 4 for serving (MoE: K1 and
     K5);
   - seamless-m4t-medium, 12 encoder + 12 decoder layers (the encoder over
     the stub's B x 1024 frames: K1 causal; the decoder's cross blocks:
     K1 non-causal where S = T = 1024, the plain path at S 128);
   - llama-3.2-vision-90b cut to one period of 5 layers, its layer 4 the
     cross layer over the stub's 1601 patches (K1 in the 4 self layers);
   - deepseek-v2-236b cut to 2 layers, the dense first layer and one MoE
     layer of 160 experts + 2 shared (MLA on the plain path, as in the JAX
     package: q and v head dims 192 and 128; K5).
   The last three open their cross-attention gates first (at init tanh(0)
   = 0 takes the context off the path), check that a zeroed context moves
   the logits beyond the tolerance, and count the prefill's launches
   (``prefill_launches(cfg, S)`` and the encoder's ``encode_launches``).
   Each model's parameters are freed before the next model is built.
3b. training, qwen2-0.5b at full width and depth: one f32 step (B 2 x S
   256) through the kernels against the same step on the host CPU (loss
   and grad_norm within rtol 1e-4, each leaf's first moment within 1e-3 of
   its max); then bf16 training through make_batches, init_opt_state and
   make_train_step (2 microbatches, remat, bf16 gradient cast), 20 steps
   on one fixed batch of B 8 x S 512: losses finite and the last <= 0.9 x
   the first; step time, tokens/s, peak memory, one profiled step, and
   the launches of a step against train_launches.  Then the Mamba and MoE
   families, whose steps run K6-bwd and K5-bwd: mamba2-130m whole, one
   f32 step against the host's (loss and grad_norm within rtol 1e-5,
   parameters and m within the f32 kernel tolerance) and 20 bf16 steps as
   qwen2's; one dbrx-132b MoE layer at full width in f32 (B 1 x S 128),
   the gradients of x and the three expert stacks through the kernels
   against the plain version's; dbrx-132b at full width, 1 layer, 20 bf16
   steps of B 2 x S 256 (one microbatch, no remat), checked as qwen2's.
3c. data-parallel training, qwen2-0.5b at full width and depth, 4 gloo
   ranks sharing the card (the main process frees its tensors first):
   dp_parity, one f32 step of ZeRO-1 and one of plain DP on ``ring`` (B 8
   x S 256, lr 1e-3 from the first step) against the single-card step on
   the whole batch (loss and grad_norm within rtol 1e-4; m and v within
   1e-5 of their max; params within 1e-3 x lr of AdamW written out from
   the run's own moments, and each leaf's update within 1e-2 of the
   single-card step's; the ranks' parameters bit-equal); dp_training,
   ZeRO-1 through the
   launcher's ``run`` (``repro_torch.launch.train``: bf16 gradients, B 8
   x S 512, 2 microbatches, remat, 5 steps on one batch, a checkpoint
   written and restored): losses finite and the last <= 0.9 x the first,
   the optimizer state <= 0.26 of the replicated one, each rank's K1 and
   K1-bwd launches a step equal to ``train_launches``; step wall, compute
   and exchange times, wire and staged bytes, peak memory a rank;
   dp_q8, plain DP on ``ring_q8`` (3 steps): the first step's real
   gradient, before and after the sync, synced again exactly, by
   ``ring_q4`` and by ``ring_q8`` (bit-equal to the step's): errors against
   the exact sum (the stand-in's regime beside them), each within its
   collective's envelope, wire ratios.  Times are gloo over loopback.
3d. expert parallelism, dbrx-132b at full width, 4 gloo ranks sharing the
   card (each phase runs the single-card dense reference first and frees
   it), the model axis splitting the attention heads and the vocabulary
   beside the experts (the logits gathered before they are compared):
   ep_parity (f32, 2 layers, mesh (1, 4)): ``moe_ep_train`` prefill
   of B 2 x S 256 at capacity factor 16 (no drops) and 8 ``moe_ep_decode``
   steps of 4 slots within PARITY_TOL of the dense run, and at factor 1.25
   within PARITY_TOL of the plain emulation (``moe_ep_train_ref``), its
   dropped share printed, then 8 ``moe_ep_decode_ws`` steps on mesh
   (2, 2), each data rank's 2 slots within PARITY_TOL of the dense run's;
   ep_serving (bf16, 4 layers, (1, 4)): prefill
   through ``make_prefill(cfg, ctx)`` and 16 decode steps through
   ``make_serve_step(cfg, ctx=ctx)``, greedy tokens equal to the dense
   run's where its top-2 margin exceeds 8 bf16 ulps, the decode's max
   |logit diff| within ``EP_DECODE_DIFF_BOUND`` (G2) and the same decode
   with the first layer's attention all-reduce skipped beyond it, K5
   launches a rank equal to ``ep_launches`` a prefill and a step, the
   wire bytes (all-to-alls, sequence gathers, the model axis's
   all-reduces, the logits' gather) equal to their formula; ep_ws_decode (bf16, 4 layers, (2, 2)):
   the same decode through ``moe_ep_decode_ws`` and ``moe_ep_decode``;
   ep_training (2 gloo ranks, (1, 2)): dbrx's smoke config, one f32 step
   against the single-card step through the plain emulation at capacity
   1.25 (loss and grad_norm within rtol 1e-5), then dbrx-132b at full
   width, 1 layer, 5 bf16 steps (the loss falls; wire bytes equal their
   formula; launches a rank equal ``train_launches``; peak memory a
   rank).
   Prefill ms, decode step p50/p99 (CUDA events), exchange seconds, wire
   and staged bytes and peak memory a rank; times are gloo over loopback.
3e. tensor parallelism, 4 gloo ranks sharing the card, each drawing only
   its blocks from the seed (each phase's single-card reference run made
   first and freed): tp_parity, granite-3-8b at full width, 2 layers, f32,
   on (1, 4) and (2, 2): prefill B 2 x S 256 through ``make_prefill(cfg,
   ctx)`` and 8 teacher-forced decode steps of 4 slots within PARITY_TOL
   of the single-card run, greedy tokens equal, one training step (B 4 x S
   256, ZeRO-1 on (2, 2)) held as dp_parity holds its own; tp_serving,
   granite-3-8b at full width and depth (40 layers), bf16, (1, 4): prefill
   and a 4-slot ContinuousBatcher over 6 requests (one admitted
   mid-flight), greedy tokens equal to the single-card run's where its
   top-2 margin exceeds 8 bf16 ulps, max |logit diff| printed; tp_mamba,
   mamba2-130m whole on (1, 4) (6 of 24 SSD heads a rank): f32 parity,
   then bf16 serving; tp_training, granite-3-8b at full width, 4 layers,
   bf16, (2, 2), ZeRO-1, B 8 x S 512 in 2 microbatches, remat, 5 steps:
   the loss falls; cmm, ``ag_matmul`` and ``matmul_rs`` at granite's FFN
   shape against the bulk forms; pipeline, GPipe over 4 granite layers
   and the interleaved schedule over 8 (v = 2), 8 microbatches of B 1 x S
   256, f32, outputs and gradients against the sequential composition.
   Every phase prints wall and device ms, wire and staged bytes (held to
   the ring formula), peak memory and K1 / K1-bwd / K6 launches a rank
   (held to their formulas).
3f. the model axis of the other families, 4 gloo ranks sharing the card,
   the references made first and freed, the gates opened: tp_mla,
   deepseek-v2-236b at full width, 2 layers (the dense first and one MoE
   layer of 160 experts + 2 shared), f32, (1, 4): 32 MLA heads and 40
   experts a rank, prefill B 2 x S 256 (K5 on the rank's experts, at
   capacity factor E / k: no drops) and 8 teacher-forced decode steps of
   4 slots within PARITY_TOL of the single card, greedy tokens equal;
   tp_cross, llama-3.2-vision-90b, one 5-layer period, f32 parity as
   tp_mla over the stub's 1601 patches (16 q / 2 KV heads a rank), then
   bf16 serving: prefill and a 4-slot ContinuousBatcher over 6 requests
   (one admitted mid-flight), tokens held where the single card's top-2
   margin exceeds 8 bf16 ulps; tp_encdec, seamless-m4t-medium whole, the
   encoder over 2 x 1024 frames and prefill at S = T = 1024 (K1 causal in
   the encoder and the self layers, non-causal in the cross blocks, 4
   heads a rank), 8 decode steps, then one f32 training step on (2, 2)
   (B 4 x S 256, ZeRO-1, K1-bwd on local heads) held leaf by leaf to the
   single-card step.  Wall and device ms, wire and staged bytes (held to
   ``tp_forward_bytes`` / ``tp_encode_bytes``), launches a rank (held to
   ``prefill_launches`` / ``encode_launches`` / ``ep_launches`` /
   ``train_launches``), bytes of parameters and peak memory a rank.  At
   a token whose router logits nearly tie (within ``ROUTER_TIE``) the
   model axis may pick the (k+1)-th expert: tp_mla re-runs its
   single-card reference with rank 0's experts at those tokens
   (``_forced_routes``) and holds every position to it, the ties
   counted.
4. codecs (K2a, K2b, K3, K4): a stand-in gradient of qwen2-0.5b at full
   width and depth (one seeded tensor per parameter) through the q8, q4,
   topk and lowrank codecs over two error-feedback steps, held to the JAX
   tests' error regime, the specs' wire ratio and the plain versions;
   then the payload-level quantize/dequantize/sparsify over the flattened
   gradient and the projection of every matrix; then the payload-level
   sparsify as one row against the zero-padded rows of 256 it replaced,
   in turns, device ms and peak memory.  Then the four codecs over the
   real gradient of one f32 step (the step's hook), against the plain
   versions, their errors reported beside the stand-in's regime.
5. collectives (K2a, K2b): four gloo ranks share the card, each syncing
   its own stand-in gradient in 64 MiB buckets through ring_q8, ring_q4,
   ring and bidir_ring, and two buckets through the ATP schedule with and
   without q8; results against the sum of the four gradients (regenerated
   from their seeds) and across ranks.  Times are gloo over loopback.
5b. planner: the paradigm's planning layers, plan to execution.  On the
   host, with the port alone: qwen2-0.5b's DP-4 training demand (B 32 x S
   512, 64 MiB gradient buckets; ZeRO-1's reduce-scatters, and the
   all-reduces of plain DP) planned by the co-design engine's
   ``codesign.plan_iteration`` (packed placement, each task priced by
   ``select_for_task`` under FlowSim on ``dgx_cluster(1, 4)`` inside
   ``simulate_iteration``); the ``CodesignReport`` written as a Chrome
   trace (``to_trace``, link counters included) that ``validate_chrome``
   must pass; the predicted iteration time and each bucket's algorithm
   printed.  On the card, 4 gloo ranks,
   one 64 MiB bucket of the stand-in gradient each, through every
   executable of ``IMPLEMENTATIONS``, ``synthesized_collective`` on the
   port's own ``synthesize_schedule(full_mesh(4), task)`` plain and with
   ``bits=8`` (K2a, K2b) and ``atp_schedule``: each held to the f64 sum
   with the collectives' tolerances; each rank's wire bytes against the
   model's flows out of that rank (exact where the model counts the same
   bytes, both printed where it cannot); measured seconds beside
   ``algo_cost``'s prediction (loopback time: printed, not checked).
5c. codesign: the co-design engine on the host (under 30 s): ``search``
   over the placement and the all-reduces' error budget of the planner's
   plain-DP iteration (best JCT, attribution, codecs, telemetry; its trace
   validated), ``plan_cluster`` of two DP-4 tenants sharing the uplinks of
   ``dgx_cluster(2, 4)`` (naive against staggered JCT, contended links),
   ``plan_serving`` of qwen2-0.5b under the JAX serving tests' spec (TTFT
   and TPOT percentiles, goodput) and ``ClusterDynamics`` over an
   arrival, a link failure and a departure (each event's dirty set and
   regret); then ``obs.probe.probe_suite`` on 4 gloo ranks sharing the
   card: every executable of ``MODEL_EQUIVALENTS`` (K2a, K2b in the
   quantized ones) at 64 MiB and 1 MiB, each rank reducing its quarter of
   the probe buffer; each result held to the f64 sum, each rank's wire
   bytes to the model's flows of that operand, the seconds printed beside
   ``algo_cost``'s for the whole size, with ``model_vs_measured``'s
   summary, the probes' trace validated, and the search's executable's
   measured seconds beside its price.
6. The kernels line (all ten kernels, launches from the path that runs
   each, and by every path, the data-parallel ones summed over the
   ranks), the card's name and power limit, and last the line
   {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

try:
    import torch
    import torch.nn.functional as F

    import torch.distributed as dist

    import networkx

    from repro_torch.ccl import primitives as ccl_prim
    from repro_torch.ccl.algorithms import generate_flows
    from repro_torch.ccl.cost import CostParams
    from repro_torch.ccl.select import AlphaBeta
    from repro_torch.ccl.synth import atp_schedule, synthesize_schedule
    from repro_torch.compress import get_codec
    from repro_torch.compress.codec import codec_spec
    from repro_torch.compress.lowrank import _matrix_shape
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import (SOURCES, WRAPPERS, _build, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.compress import ops as cops
    from repro_torch.kernels.compress import ref as cref
    from repro_torch import codesign
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import hw
    from repro_torch.core.demand import CommTask
    from repro_torch.core.demand_builder import DemandParams
    from repro_torch.core.types import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.data import audio_frames, make_batches, vision_patches
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_stats)
    from repro_torch.kernels.flash_attention.ops import \
        LAUNCHES_PER_CALL as FA_BWD_LAUNCHES
    from repro_torch.kernels.moe_gmm import (moe_gmm, moe_gmm_bwd,
                                             moe_gmm_bwd_ref, moe_gmm_ref)
    from repro_torch.kernels.moe_gmm.ops import \
        BWD_LAUNCHES_PER_CALL as GMM_BWD_LAUNCHES
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                              ssd_scan_bwd_ref, ssd_scan_ref,
                                              ssd_scan_workspace)
    from repro_torch.kernels.ssd_scan.ops import \
        BWD_LAUNCHES_PER_CALL as SSD_BWD_LAUNCHES
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.launch.ranks import rank_device, spawn_ranks
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.analysis import record_collectives
    from repro_torch.models import (decode_step, encode, encode_launches,
                                    ep_launches, forward, init_cache,
                                    init_params, param_leaves,
                                    prefill_launches, train_launches,
                                    tree_map)
    from repro_torch.models import moe as moe_mod
    from repro_torch.net.topology import dgx_cluster, fat_tree, full_mesh
    from repro_torch.obs import probe as obs_probe
    from repro_torch.obs.trace import (trace_from_cluster, trace_from_dynamics,
                                       trace_from_search, trace_from_serving,
                                       validate_chrome)
    from repro_torch.optim import gather_opt_state, init_opt_state
    from repro_torch.optim.adamw import UPDATE_CHUNK
    from repro_torch.parallel import (ParallelCtx, expert_flags,
                                      flat_layout, make_ctx)
    from repro_torch.parallel import fsdp as fsdp_mod
    from repro_torch.parallel.planner import (BUCKET_VALUES, _with_paths,
                                              tp_dims, tp_layout)
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.sched.arrivals import PoissonArrivals
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.train import make_train_step
except ImportError as e:  # run outside the repo, or without torch
    sys.exit(f"chip_smoke: cannot import the port ({e}); run it from the "
             f"root of the repository")

SEED = 0
ARCH = "qwen2-0.5b"
SSM_ARCH = "mamba2-130m"
MOE_ARCH = "dbrx-132b"
MOE_PARITY_LAYERS = 2   # 31 GB in f32; all 40 layers (264 GB) fit no card
MOE_SERVE_LAYERS = 4    # 28.6 GB in bf16
# the families with MLA, cross-attention and an encoder (full width)
ENC_DEC_ARCH = "seamless-m4t-medium"  # whole: 12 + 12 layers
VISION_ARCH = "llama-3.2-vision-90b"
VISION_LAYERS = 5       # one period, layer 4 the cross layer: 25.6 GB f32
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 2          # the dense first layer and one of 160 experts
# cross-attention gates start at 0 (tanh(0) = 0: the context would be off
# the path); every run of these families opens them first
GATE = 0.8
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), the
# planner's own (repro_torch.core.hw)
PEAK_BF16_FLOPS = hw.PEAK_FLOPS_BF16
PEAK_F32_FLOPS = hw.PEAK_FLOPS_F32  # CUDA cores, outside the tensor cores
PEAK_BYTES = hw.HBM_BW
KERNEL_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
              torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# K1's row statistics (f32 in both variants) against attention_lse_ref, as
# tests/test_torch_cuda.py::test_forward_statistics_match_plain holds them
LSE_TOL = dict(atol=2e-5, rtol=2e-5)
# prefill vs decode replay in f32 (TF32 off): the two differ only in
# summation order (the kernel's tiled online softmax vs one softmax; cuBLAS
# picks other algorithms for M = 512 than for M = 2), amplified through 24
# layers.  The model-logit tolerance of tests/test_pallas_integration.py.
PARITY_TOL = dict(atol=5e-4, rtol=1e-3)

KERNEL_INFO = {
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
    },
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attn_bwd.cu",
        "replaces": "none: the TPU kernel "
                    "src/repro/kernels/flash_attention/kernel.py:87 is "
                    "forward-only",
    },
    "ssd_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:69",
    },
    "ssd_scan_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "none: the TPU kernel "
                    "src/repro/kernels/ssd_scan/kernel.py:69 is "
                    "forward-only",
    },
    "moe_gmm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:40",
    },
    "moe_gmm_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm_bwd.cu",
        "replaces": "none: the TPU kernel "
                    "src/repro/kernels/moe_gmm/kernel.py:40 is "
                    "forward-only",
    },
}
for _name, _line in (("quantize", 53), ("dequantize", 91), ("sparsify", 113),
                     ("matmul", 136)):
    KERNEL_INFO[_name] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/compress/csrc/compress.cu",
        "replaces": f"src/repro/kernels/compress/kernel.py:{_line}"}

# the codec and collective paths: qwen2-0.5b's gradient
ROW_LEN = 256                  # rows of the payload-level ops
BUCKET_BYTES = 64 * 2 ** 20    # the planner's gradient bucket
RING_RANKS = 4                 # gloo ranks sharing the one card
BUCKET = BUCKET_BYTES // 4     # f32 values of a bucket
RING_CHUNK = BUCKET // RING_RANKS
SYNTH_BUCKETS = 2              # buckets through the ATP schedule
LOWRANK_RANK = 4
# tolerance of the regime of each codec (tests/test_compress.py:40)
CODEC_REGIME = {"q8": 0.02, "q4": 0.25, "topk": 1.0, "lowrank": 1.0}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_capture_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn`` from one CUDA graph of ``iters``
    calls, replayed (``fn`` warmed up before)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def graph_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so that the host work of each call (the
    wrapper's checks, the ctypes call) is not timed; where ``cuda_ms`` is
    larger, the host sets the pace of back-to-back calls.  The calls are
    captured twice and the second graph is timed: the first capture after
    the allocations change can replay several percent slower, whichever
    kernel it holds (``tools/graph_capture_check.py``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph_capture_ms(fn, iters)
    return graph_capture_ms(fn, iters)


def _delta(before: dict) -> dict:
    """The kernels launched since ``before``, by name (none left out)."""
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def _release() -> None:
    """Return the freed blocks of a model to the card before the next one
    is built (the caller has dropped its references)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------

# the tensor-core kernels whose registers and spills get a line each: the
# wgmma / TMA kernels (K1 bf16 and its backward; K5 bf16 prefill and,
# swap-AB, decode; K5-bwd's dx and dw) and K6-bwd's two 3xTF32 mma.sync
# stages at mamba2's (P, N)
TC_KERNELS = ("flash_attn_bf16_kernel<64>", "flash_attn_bf16_kernel<128>",
                 "dkdv_wgmma_kernel<64>", "dkdv_wgmma_kernel<128>",
                 "dq_wgmma_kernel<64>", "dq_wgmma_kernel<128>",
                 "gmm_wgmma_kernel", "gmm_swap_kernel<8>", "gmm_swap_kernel<16>",
                 "gmm_swap_kernel<32>", "gmm_swap_kernel<64>",
                 "gmm_bwd_wgmma_kernel<false>", "gmm_bwd_wgmma_kernel<true>",
                 "chunk_grad_kernel<64, 128>", "dstate_kernel<128, 64>")


def ptxas_summary(log: str) -> dict:
    """nvcc's -Xptxas -v output by kernel: {name: "Used N registers, ...;
    0 bytes stack frame, ... spill loads"}, the name demangled as far as
    the kernel's template argument."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            name = None
            for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", ln):
                n, rest = int(m.group(1)), m.group(2)  # <length><identifier>
                if rest[:n].endswith("_kernel"):
                    args = re.match(r"I((?:L[ib]\d+E)+)E", rest[n:])
                    name = rest[:n] + ("<" + ", ".join(
                        v if k == "i" else ("true" if v == "1" else "false")
                        for k, v in re.findall(r"L([ib])(\d+)E",
                                               args.group(1))) + ">"
                        if args else "")
        elif name and ("registers" in ln or "spill" in ln):
            text = ln.split("ptxas info    :")[-1].strip()
            out[name] = f"{out[name]}; {text}" if name in out else text
    return out


def phase_build() -> None:
    t0 = time.time()
    libs = _build.build(list(SOURCES.values()))
    seconds = time.time() - t0
    ptxas = {}
    for src, lib in libs.items():
        log = lib.with_suffix(".log")
        ptxas[src.name] = ptxas_summary(log.read_text() if log.exists()
                                        else "")
    emit({"phase": "build", "seconds": seconds,
          "libraries": [str(p.relative_to(ROOT)) for p in libs.values()],
          "ptxas": ptxas})
    for src in ptxas.values():  # the tensor-core kernels, one line each
        for name, info in src.items():
            if name in TC_KERNELS:
                emit({"phase": "build", "kernel": name, "ptxas": info})


# --------------------------------------------------------------------------
# 2. kernel against its plain version
# --------------------------------------------------------------------------

def _bound(nbytes: float, flops: float, peak: float):
    """Least time (ms) for the card, and what sets it: the bytes moved once
    over HBM against the operations at ``peak`` (operations a second)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def _attended_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks keep: the work these inputs need."""
    qpos = np.arange(sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_bound(b, h, kv, sq, sk, d, causal, window, dtype):
    """Least time (ms) for the card: the larger of the operations over the
    bf16 tensor-core peak and q, k, v, o each moved once over HBM."""
    flops = 4 * b * h * _attended_pairs(sq, sk, causal, window) * d
    nbytes = (2 * b * h * sq * d + 2 * b * kv * sk * d) * \
        torch.tensor([], dtype=dtype).element_size()
    return _bound(nbytes, flops, PEAK_BF16_FLOPS)


def _qkv(rng, b, h, kv, sq, sk, d, dtype, views=False):
    """q, k, v in (B,H,S,D); with ``views`` as the model passes them:
    (B,S,H,D) tensors transposed, not copied."""
    def mk(b, n, s):
        t = torch.from_numpy(rng.standard_normal(
            (b, s, n, d) if views else (b, n, s, d), dtype=np.float32))
        t = t.to(DEVICE).to(dtype)
        return t.transpose(1, 2) if views else t
    return mk(b, h, sq), mk(b, kv, sk), mk(b, kv, sk)


# the sweep of tests/test_kernels.py:21-28 (both dtypes, causal / full /
# window 128; GQA, MQA, rectangular), plus head dims 32, 80, 128, ragged
# lengths, group size 7, and the serving path's prefill shapes
_SWEEP = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
          (1, 8, 1, 256, 512, 128)]
_MASKS = [(True, None), (False, None), (True, 128)]
PATH_SHAPE = (4, 14, 2, 512, 512, 64)   # qwen2-0.5b prefill, B 4 x S 512
LONG_SHAPE = (1, 14, 2, 4096, 4096, 64)
DBRX_SHAPE = (2, 48, 8, 256, 256, 128)  # dbrx-132b prefill, B 2 x S 256
# seamless-m4t-medium: the encoder (causal) and the decoder's cross blocks
# at S = T = 1024 (non-causal), B 2
SEAMLESS_SHAPE = (2, 16, 16, 1024, 1024, 64)


def _kernel_cases():
    """(shape, causal, window, dtype, views): the sweep in both dtypes, then
    the model's transposed (B,S,H,D) views at every head dim in bf16 (the
    tensor-core variant), ragged and Sq != Sk under both masks."""
    cases = [(s, c, w, dt, False) for dt in (torch.float32, torch.bfloat16)
             for s in _SWEEP for c, w in _MASKS]
    for dt in (torch.float32, torch.bfloat16):
        cases += [((1, 8, 2, 256, 256, 80), True, 128, dt, False),
                  ((2, 4, 2, 200, 200, 32), True, None, dt, False),
                  ((1, 14, 2, 300, 300, 64), True, 128, dt, False),
                  ((1, 4, 1, 100, 300, 128), False, 64, dt, False),
                  ((1, 4, 2, 300, 100, 64), True, 32, dt, False),
                  (PATH_SHAPE, True, None, dt, False),
                  (PATH_SHAPE, True, None, dt, True)]
    cases += [((2, 4, 2, 200, 200, 32), True, None, torch.bfloat16, True),
              ((1, 8, 2, 129, 257, 80), True, 100, torch.bfloat16, True),
              ((1, 4, 2, 257, 129, 128), False, 64, torch.bfloat16, True),
              (DBRX_SHAPE, True, None, torch.bfloat16, True),
              (SEAMLESS_SHAPE, True, None, torch.bfloat16, True),
              (SEAMLESS_SHAPE, False, None, torch.bfloat16, True),
              (LONG_SHAPE, True, None, torch.bfloat16, False)]
    return cases


def phase_kernels(rng) -> dict:
    for shape, causal, window, dtype, views in _kernel_cases():
        q, k, v = _qkv(rng, *shape, dtype, views)
        out = flash_attention(q, k, v, causal=causal, window=window)
        variant = flash_attention.last_variant
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        tol = KERNEL_TOL[dtype]
        bad = int((err > tol["atol"] + tol["rtol"] * ref.float().abs())
                  .sum())
        max_err = float(err.max())
        finite = bool(torch.isfinite(out.float()).all())
        emit({"phase": "kernel_check", "kernel": "flash_attention",
              "shape": list(shape), "dtype": str(dtype).split(".")[-1],
              "layout": "bshd_views" if views else "bhsd",
              "variant": variant, "causal": causal, "window": window,
              "max_abs_err": max_err, "tol": tol, "mismatches": bad,
              "finite": finite})
        check(variant == ("wgmma" if dtype == torch.bfloat16 else "f32"),
              f"flash_attention took the {variant} variant for {dtype}")
        check(finite and bad == 0,
              f"flash_attention disagrees with attention_ref at {shape} "
              f"{dtype} causal={causal} window={window}: {bad} elements "
              f"out of tolerance, max |err| {max_err}")

    timings = {}
    for name, shape, iters, causal, views in (
            ("path", PATH_SHAPE, 50, True, False),
            ("dbrx", DBRX_SHAPE, 50, True, False),
            ("long", LONG_SHAPE, 10, True, False),
            # seamless's cross blocks at S = T, on the model's views
            ("seamless_cross", SEAMLESS_SHAPE, 20, False, True)):
        q, k, v = _qkv(rng, *shape, torch.bfloat16, views)
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), iters)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=causal),
                           max(2, iters // 5))
        # yardstick only: the port never calls it
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), iters)
        graph = graph_ms(lambda: flash_attention(q, k, v, causal=causal),
                         iters // 2)
        library_graph = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), iters // 2)
        lib_err = float((F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True).float()
            - attention_ref(q, k, v, causal=causal).float()).abs().max())
        max_err = float((flash_attention(q, k, v, causal=causal).float()
                         - attention_ref(q, k, v, causal=causal).float())
                        .abs().max())
        bound_ms, bound_by = attention_bound(*shape, causal, None,
                                             torch.bfloat16)
        timings[name] = {"shape": list(shape), "dtype": "bfloat16",
                         "layout": "bshd_views" if views else "bhsd",
                         "variant": flash_attention.last_variant,
                         "causal": causal, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "max_abs_err": max_err,
                         "library_max_abs_err": lib_err, "graph_ms": graph,
                         "library_graph_ms": library_graph}
        emit({"phase": "kernel_time", "kernel": "flash_attention",
              **timings[name]})
    return {"flash_attention": timings}


# --------------------------------------------------------------------------
# 2a. flash-attention backward (K1-bwd) against its plain version
# --------------------------------------------------------------------------

# qwen2-0.5b's training step: B 8 x S 512 in two microbatches of 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 8, 512, 2
TRAIN_SHAPE = (TRAIN_BATCH // TRAIN_MICROBATCHES, 14, 2, TRAIN_SEQ,
               TRAIN_SEQ, 64)


# K1-bwd's three launches (csrc/flash_attn_bwd.cu), bf16: D and the padded
# statistics; dK/dV per query head; dQ, whose launch also sums each KV
# head's partial dK/dV
BWD_STAGES = ("delta_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel")


def attention_bwd_bound(b, h, kv, sq, sk, d, causal, window, dtype):
    """Least time (ms) of the gradient: five D-deep products a kept (query,
    key) pair (S, dP, dV, dK, dQ) at the bf16 tensor-core peak, against q,
    k, v, o, dO and the row statistics read once and dQ, dK, dV written
    once."""
    flops = 10 * b * h * _attended_pairs(sq, sk, causal, window) * d
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (4 * b * h * sq * d + 4 * b * kv * sk * d) * size + \
        4 * b * h * sq
    return _bound(nbytes, flops, PEAK_BF16_FLOPS)


def _bwd_case(rng, shape, causal, window, dtype, views):
    """K1's forward with statistics, then K1-bwd.  The statistics against
    ``attention_lse_ref`` (+inf on the same rows, the others within
    LSE_TOL); the gradient against the f64 one: f32 within KERNEL_TOL;
    bf16 within twice the error of the plain bf16 backward (built from
    ``attention_ref`` and ``attention_lse_ref``, nothing of the kernels')
    plus 1e-3, FlashAttention's convention.  Returns max |kernel - plain|
    (same dtype)."""
    q, k, v = _qkv(rng, *shape, dtype, views)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)) \
        .to(DEVICE, dtype)
    o, lse = flash_attention_stats(q, k, v, causal=causal, window=window)
    n0 = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                window=window)
    variant = flash_attention_bwd.last_variant
    check(flash_attention_bwd.launches == n0 + FA_BWD_LAUNCHES,
          "flash_attention_bwd launches a call")
    lse_p = attention_lse_ref(q, k, causal=causal, window=window)
    plain = attention_bwd_ref(
        q, k, v, attention_ref(q, k, v, causal=causal, window=window), lse_p,
        do, causal=causal, window=window)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    ref = attention_bwd_ref(
        q64, k64, v64, attention_ref(q64, k64, v64, causal=causal,
                                     window=window),
        attention_lse_ref(q64, k64, causal=causal, window=window), do64,
        causal=causal, window=window)
    torch.cuda.synchronize()
    inf_rows = torch.isinf(lse_p)
    lse_ok = bool(torch.equal(torch.isinf(lse), inf_rows))
    lse_err = float((lse - lse_p)[~inf_rows].abs().max()) \
        if bool((~inf_rows).any()) else 0.0
    lse_ok = lse_ok and bool(
        ((lse - lse_p)[~inf_rows].abs() <= LSE_TOL["atol"] + LSE_TOL["rtol"]
         * lse_p[~inf_rows].abs()).all())
    errs, ok = {}, lse_ok
    for name, g, p_, r in zip(("dq", "dk", "dv"), grads, plain, ref):
        err = float((g.double() - r).abs().max())
        finite = bool(torch.isfinite(g.float()).all())
        if dtype == torch.float32:
            tol = KERNEL_TOL[dtype]
            good = bool(((g.double() - r).abs() <= tol["atol"] + tol["rtol"]
                         * r.abs()).all())
        else:
            plain_err = float((p_.double() - r).abs().max())
            good = err <= 2 * plain_err + 1e-3
            errs[name + "_plain_vs_f64"] = plain_err
        errs[name + "_vs_f64"] = err
        ok = ok and finite and good
    max_err = max(float((g.float() - p_.float()).abs().max())
                  for g, p_ in zip(grads, plain))
    emit({"phase": "kernel_check", "kernel": "flash_attention_bwd",
          "shape": list(shape), "dtype": str(dtype).split(".")[-1],
          "layout": "bshd_views" if views else "bhsd", "variant": variant,
          "causal": causal, "window": window, "max_abs_err": max_err,
          "lse_max_abs_err": lse_err, "lse_keyless_rows":
          int(inf_rows.sum()), "lse_ok": lse_ok, **errs, "ok": ok})
    check(variant == ("wgmma" if dtype == torch.bfloat16 else "f32"),
          f"flash_attention_bwd took the {variant} variant for {dtype}")
    check(lse_ok, f"K1's row statistics disagree with attention_lse_ref at "
                  f"{shape} {dtype} causal={causal} window={window}: "
                  f"{lse_err}")
    check(ok, f"flash_attention_bwd disagrees with the plain backward at "
              f"{shape} {dtype} causal={causal} window={window}: {errs}")
    return max_err


def sdpa_backend(q, k, v, do) -> str:
    """The kernel names of one SDPA backward through autograd (device
    kernels of torch.profiler holding "flash", "fmha", "cudnn", "mem_eff"
    or "attention"), joined; the backend that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
    names = sorted({ev.key for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA and any(
                        w in ev.key.lower() for w in (
                            "flash", "fmha", "cudnn", "mem_eff",
                            "attention"))})
    return "; ".join(n[:80] for n in names) or "none found"


def autograd_graph_ms(forward, inputs, grad, iters: int) -> float:
    """Device time of one ``torch.autograd.grad`` of ``forward(*leaves)``
    from a CUDA graph of ``iters`` such calls, the leaves detached copies
    of ``inputs``.  The forward runs (once, outside the graph) on the
    capture stream, where autograd then runs its backward (its leaves are
    made there too); captured twice, the second timed, as ``graph_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = forward(*leaves)
        for _ in range(3):
            torch.autograd.grad(out, leaves, grad, retain_graph=True)
    side.synchronize()
    ms = None
    for _ in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                torch.autograd.grad(out, leaves, grad, retain_graph=True)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (3 * iters)
        del graph
    return ms


def _bwd_times(rng, shape, iters: int) -> dict:
    """K1-bwd at ``shape`` (bf16, causal, the model's (B,S,H,D) views):
    the kernel both ways and by launch, the host's time a call, two calls
    bit-equal, its plain
    version, SDPA's backward through autograd both ways, the bound.
    Returns (those times, (q, k, v))."""
    q, k, v = _qkv(rng, *shape, torch.bfloat16, views=True)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)) \
        .to(DEVICE, torch.bfloat16)
    o, lse = flash_attention_stats(q, k, v, causal=True)

    def bwd():
        return flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    first, second = bwd(), bwd()
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"flash_attention_bwd gave other bits on a second call at {shape}")
    del first, second
    # the host's share of a call: wrapper checks, scratch allocation, the
    # ctypes call and three launches, enqueued without waiting for the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        bwd()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    ms = cuda_ms(bwd, iters)
    graph = graph_ms(bwd, iters // 2)
    plain_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                 causal=True),
                       max(2, iters // 6), warmup=1)
    # yardstick only: the port never calls it
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True,
                                              enable_gqa=True)
    out_l = sdpa(ql, kl, vl)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out_l, (ql, kl, vl), do, retain_graph=True), iters)
    del out_l
    backend = sdpa_backend(ql, kl, vl, do)
    library_graph = autograd_graph_ms(sdpa, (q, k, v), do, iters // 2)
    stages = stage_ms(bwd, iters, BWD_STAGES)
    check(not stages or len(stages) == len(BWD_STAGES),
          f"K1-bwd's launches seen by the profiler: {stages}")
    bound_ms, bound_by = attention_bwd_bound(*shape, True, None,
                                             torch.bfloat16)
    return {"shape": list(shape), "dtype": "bfloat16", "causal": True,
            "layout": "bshd_views",
            "variant": flash_attention_bwd.last_variant,
            "launches_per_call": FA_BWD_LAUNCHES, "stage_ms": stages,
            "ms": ms, "graph_ms": graph, "host_ms": host_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_graph_ms": library_graph,
            "library_backend": backend, "bound_ms": bound_ms,
            "bound_by": bound_by, "bit_equal_calls": True}, (q, k, v)


def phase_bwd_kernel(rng) -> dict:
    """K1-bwd over the forward's sweep (both dtypes; the long prompt in
    bf16) and at the training shape; then times at the training shape and
    at the long prompt: the kernel, its plain version, SDPA's backward
    through autograd, the bound, and at the training shape K1's forward
    with and without the statistics."""
    long_err = None
    for shape, causal, window, dtype, views in _kernel_cases():
        err = _bwd_case(rng, shape, causal, window, dtype, views)
        if shape == LONG_SHAPE:
            long_err = err
    max_err = _bwd_case(rng, TRAIN_SHAPE, True, None, torch.bfloat16, True)

    iters = 30
    path, (q, k, v) = _bwd_times(rng, TRAIN_SHAPE, iters)
    path["max_abs_err"] = max_err
    with torch.no_grad():
        path["forward_ms"] = cuda_ms(
            lambda: flash_attention(q, k, v, causal=True), iters)
        path["forward_graph_ms"] = graph_ms(
            lambda: flash_attention(q, k, v, causal=True), iters // 2)
    path["forward_with_stats_ms"] = cuda_ms(
        lambda: flash_attention_stats(q, k, v, causal=True), iters)
    path["forward_with_stats_graph_ms"] = graph_ms(
        lambda: flash_attention_stats(q, k, v, causal=True), iters // 2)
    emit({"phase": "kernel_time", "kernel": "flash_attention_bwd", **path})
    del q, k, v
    long, _ = _bwd_times(rng, LONG_SHAPE, 10)
    long["max_abs_err"] = long_err
    emit({"phase": "kernel_time", "kernel": "flash_attention_bwd", **long})
    _release()
    return {"path": path, "long": long}


# --------------------------------------------------------------------------
# 2b. SSD scan (K6) against its plain version
# --------------------------------------------------------------------------

# tests/test_kernels.py:53-58, a ragged L, a long scan (64 of the kernel's
# chunks of 64 to carry), an L ragged against the kernel's chunk, and
# mamba2-130m prefill at B 4 x S 512 (H 24, P 64, N 128, f32, the model's
# chunk 256)
SSD_LONG_SHAPE = (1, 4, 4096, 64, 128, 256)  # timed too
_SSD_SWEEP = [(1, 2, 256, 64, 32, 64), (2, 4, 512, 64, 128, 128),
              (1, 2, 256, 128, 64, 256), (1, 3, 200, 32, 16, 256),
              SSD_LONG_SHAPE, (2, 3, 1000, 64, 64, 200)]
SSD_PATH_SHAPE = (4, 24, 512, 64, 128, 256)
SSD_KERNEL_CHUNK = 64  # Q of csrc/ssd_scan_fwd.cu
PEAK_TF32_FLOPS = hw.PEAK_FLOPS_TF32  # tensor cores, dense
# the kernel's three stages, by the names the profiler gives them
SSD_STAGES = ("chunk_state_kernel", "state_pass_kernel", "chunk_out_kernel")


def _ssd_inputs(rng, b, h, l, p, n, dtype, model_decay):
    """The distributions of tests/test_kernels.py:60-68; with
    ``model_decay`` the decays of mamba2 (a = -linspace(1, 16, H)).  x and
    dt are the permuted views the model passes."""
    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * scale).to(DEVICE)
    x = mk(b, l, h, p, scale=0.5).to(dtype).permute(0, 2, 1, 3)
    dt = F.softplus(mk(b, l, h)).permute(0, 2, 1)
    a = (-torch.linspace(1.0, 16.0, h, device=DEVICE) if model_decay
         else -torch.exp(mk(h)))
    return (x, dt, a, mk(b, l, n, scale=0.3).to(dtype),
            mk(b, l, n, scale=0.3).to(dtype))


def ssd_bound(b, h, l, p, n):
    """Least time (ms): x, dt, b, c, y moved once over HBM against the
    least operations of the function at the f32 peak of the CUDA cores (the
    model calls the scan in f32).  The dual form does 2Q(QN + QP + 2PN) per
    (b, h, chunk of Q); the least of that per row over chunk lengths is at
    Q = 1, the recurrence: 2(N + P + 2PN) per row, head and batch.  The
    function does not depend on the chunk, nor does the bound."""
    flops = b * h * l * 2 * (n + p + 2 * p * n)
    nbytes = 4 * (2 * b * h * l * p + b * h * l + 2 * b * l * n + h)
    return _bound(nbytes, flops, PEAK_F32_FLOPS)


def ssd_tc_bound(b, h, l, p, n, q=SSD_KERNEL_CHUNK):
    """Least time (ms) of the kernel's own design: the dual form's least
    operations at its chunk q (G x on and below the diagonal, q (q + 1) / 2
    terms a chunk; C h^T and the state, 2PN each a row; C B^T once per
    batch row, on and below the diagonal), three times over for 3xTF32, at
    the dense TF32 peak of the tensor cores, against the same bytes."""
    flops = 3 * (b * h * l * 2 * (p * (q + 1) / 2 + 2 * p * n)
                 + b * l * 2 * n * (q + 1) / 2)
    nbytes = 4 * (2 * b * h * l * p + b * h * l + 2 * b * l * n + h)
    return _bound(nbytes, flops, PEAK_TF32_FLOPS)


def stage_ms(fn, iters: int, names) -> dict:
    """Device ms a call of each kernel whose name holds one of ``names``,
    from torch.profiler over ``iters`` calls of ``fn`` (empty where the
    profiler records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in ev.key:
                out[name] = out.get(name, 0.0) + \
                    ev.self_device_time_total / 1e3 / iters
    return out


def phase_ssd_kernel(rng) -> dict:
    cases = [(s, dt, False) for dt in (torch.float32, torch.bfloat16)
             for s in _SSD_SWEEP]
    cases += [(SSD_PATH_SHAPE, torch.float32, True),
              (SSD_PATH_SHAPE, torch.bfloat16, True)]
    path_err = None
    for shape, dtype, model_decay in cases:
        b, h, l, p, n, chunk = shape
        args = _ssd_inputs(rng, b, h, l, p, n, dtype, model_decay)
        out = ssd_scan(*args, chunk=chunk)
        ref = ssd_scan_ref(*args, chunk=chunk)
        torch.cuda.synchronize()
        # |err| / max(|ref|, 1) within 3e-5 (f32) or 3e-2 (bf16), as in
        # tests/test_kernels.py:72-76; its 3e-2 rtol only for bf16, so that
        # the f32 check holds the kernel to f32 (no TF32, no bf16 products)
        scale = max(float(ref.float().abs().max()), 1.0)
        atol, rtol = (3e-2, 3e-2) if dtype == torch.bfloat16 else (3e-5, 0.0)
        err = (out.float() - ref.float()).abs()
        bad = int((err > atol * scale + rtol * ref.float().abs()).sum())
        max_err = float(err.max())
        finite = bool(torch.isfinite(out.float()).all())
        emit({"phase": "kernel_check", "kernel": "ssd_scan",
              "shape": list(shape), "dtype": str(dtype).split(".")[-1],
              "model_decay": model_decay, "max_abs_err": max_err,
              "scale": scale, "tol": {"atol": atol, "rtol": rtol,
                                      "scaled_by": "max(|ref|, 1)"},
              "mismatches": bad, "finite": finite})
        check(finite and bad == 0,
              f"ssd_scan disagrees with ssd_scan_ref at {shape} {dtype}: "
              f"{bad} elements out of tolerance, max |err| {max_err}")
        if shape == SSD_PATH_SHAPE and dtype == torch.float32:
            path_err = max_err

    b, h, l, p, n, chunk = SSD_PATH_SHAPE
    args = _ssd_inputs(rng, b, h, l, p, n, torch.float32, True)
    before = ssd_scan.launches
    ssd_scan(*args, chunk=chunk)
    per_call = ssd_scan.launches - before
    ms = cuda_ms(lambda: ssd_scan(*args, chunk=chunk), 50)
    graph = graph_ms(lambda: ssd_scan(*args, chunk=chunk), 25)
    plain_ms = cuda_ms(lambda: ssd_scan_ref(*args, chunk=chunk), 10)
    stages = stage_ms(lambda: ssd_scan(*args, chunk=chunk), 20, SSD_STAGES)
    # bound_ms at the f32 rate of the CUDA cores (the function's floor on
    # any design); bound_tc_ms is this design's own, in 3xTF32
    bound_ms, bound_by = ssd_bound(*SSD_PATH_SHAPE[:5])
    bound_tc_ms, bound_tc_by = ssd_tc_bound(*SSD_PATH_SHAPE[:5])
    timing = {"shape": list(SSD_PATH_SHAPE), "dtype": "float32", "ms": ms,
              "graph_ms": graph, "launches_per_call": per_call,
              "stage_ms": stages,
              "plain_ms": plain_ms, "library_ms": None,  # no single call
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_tc_ms": bound_tc_ms, "bound_tc_by": bound_tc_by,
              "max_abs_err": path_err}
    emit({"phase": "kernel_time", "kernel": "ssd_scan", **timing})
    check(per_call == 3, f"ssd_scan launched {per_call} kernels a call, "
          f"not its three stages")
    b, h, l, p, n, chunk = SSD_LONG_SHAPE
    args = _ssd_inputs(rng, b, h, l, p, n, torch.float32, True)
    long_timing = {
        "shape": list(SSD_LONG_SHAPE), "dtype": "float32",
        "ms": cuda_ms(lambda: ssd_scan(*args, chunk=chunk), 20),
        "graph_ms": graph_ms(lambda: ssd_scan(*args, chunk=chunk), 10),
        "stage_ms": stage_ms(lambda: ssd_scan(*args, chunk=chunk), 10,
                             SSD_STAGES),
        "plain_ms": cuda_ms(lambda: ssd_scan_ref(*args, chunk=chunk), 3),
        "bound_ms": ssd_bound(*SSD_LONG_SHAPE[:5])[0],
        "bound_tc_ms": ssd_tc_bound(*SSD_LONG_SHAPE[:5])[0]}
    emit({"phase": "kernel_time", "kernel": "ssd_scan", "case": "long",
          **long_timing})
    return {"path": timing, "long": long_timing}


# --------------------------------------------------------------------------
# 2c. grouped expert GEMM (K5) against its plain version
# --------------------------------------------------------------------------

# (E, C, d, f, x expanded over experts): tests/test_kernels.py:102-107,
# odd sizes, and dbrx-132b's products: decode (C = 4 slots) gate/up with
# the tokens expanded and down, prefill at B 2 x S 256 (C 512) and the f32
# parity prefill at B 2 x S 128 (C 256)
_GMM_SWEEP = [(2, 128, 256, 128, False), (4, 256, 512, 384, False),
              (16, 128, 256, 256, False), (3, 77, 100, 60, True),
              # C on both sides of the swap-AB threshold, d and f off the
              # tiles, 200-byte rows (not 16-byte aligned: mma.sync)
              (4, 64, 256, 512, True), (3, 200, 200, 1000, False),
              (3, 200, 200, 1000, True), (2, 512, 512, 384, False),
              (2, 63, 128, 256, False), (3, 20, 256, 1000, True)]
_GMM_UNALIGNED = (3, 128, 100, 1000, True)
_GMM_SWEEP.append(_GMM_UNALIGNED)
GMM_DECODE = (16, 4, 6144, 10752, True)
GMM_DECODE_DOWN = (16, 4, 10752, 6144, False)
GMM_PREFILL = (16, 512, 6144, 10752, True)
GMM_PARITY_PREFILL = (16, 256, 6144, 10752, True)
# expert parallelism, 4 ranks: a rank's 4 experts on tp x C = 4 x 40 rows
# (prefill B 2 x S 256), and weight-stationary decode on (2, 2): 8 experts,
# half the ffn dim, 4 slots
GMM_EP_PREFILL = (4, 160, 6144, 10752, False)
GMM_EP_WS = (8, 4, 6144, 5376, False)
# deepseek-v2-236b's MoE layer: 160 experts of ffn 1536 reading every token
# (moe_dense), prefill B 2 x S 256 (gate/up; and down) and 4-slot decode
GMM_DS_PREFILL = (160, 512, 5120, 1536, True)
GMM_DS_PREFILL_DOWN = (160, 512, 1536, 5120, False)
GMM_DS_DECODE = (160, 4, 5120, 1536, True)
GMM_DS_PARITY_PREFILL = (160, 256, 5120, 1536, True)


def _gmm_inputs(rng, gen, e, c, d, f, expand, dtype, w_scale):
    """x from numpy; the weights (up to 4.2 GB) drawn on the card."""
    xs = (c, d) if expand else (e, c, d)
    x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32)).to(
        DEVICE, dtype)
    if expand:
        x = x.expand(e, c, d)  # expert stride 0, as moe_dense passes it
    w = (torch.randn((e, d, f), device=DEVICE, generator=gen)
         * w_scale).to(dtype)
    return x, w


def gmm_bound(e, c, d, f, expand, dtype):
    """Least time (ms): x (once, also when expanded), w and out moved once
    over HBM against 2 E C d f operations at the peak for the dtype."""
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * e * c * d * f
    nbytes = size * ((1 if expand else e) * c * d + e * d * f + e * c * f)
    return _bound(nbytes, flops, PEAK_BF16_FLOPS if dtype == torch.bfloat16
                  else PEAK_F32_FLOPS)


def phase_gmm_kernel(rng) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = [(s, dt) for dt in (torch.float32, torch.bfloat16)
             for s in _GMM_SWEEP]
    cases += [(GMM_DECODE, torch.bfloat16), (GMM_DECODE_DOWN, torch.bfloat16),
              (GMM_PREFILL, torch.bfloat16), (GMM_DECODE, torch.float32),
              (GMM_PARITY_PREFILL, torch.float32),
              (GMM_EP_PREFILL, torch.bfloat16), (GMM_EP_WS, torch.bfloat16),
              (GMM_DS_PREFILL, torch.bfloat16),
              (GMM_DS_PREFILL_DOWN, torch.bfloat16),
              (GMM_DS_DECODE, torch.bfloat16),
              (GMM_DS_PARITY_PREFILL, torch.float32)]
    errs = {}
    for shape, dtype in cases:
        e, c, d, f, expand = shape
        path = shape in (GMM_DECODE, GMM_DECODE_DOWN, GMM_PREFILL,
                         GMM_PARITY_PREFILL, GMM_EP_PREFILL, GMM_EP_WS,
                         GMM_DS_PREFILL, GMM_DS_PREFILL_DOWN, GMM_DS_DECODE,
                         GMM_DS_PARITY_PREFILL)
        # the path's weights have the model's scale (dense_init: 1/sqrt(d));
        # the sweep's that of tests/test_kernels.py:108
        x, w = _gmm_inputs(rng, gen, *shape, dtype,
                           d ** -0.5 if path else 0.05)
        out = moe_gmm(x, w)
        variant = moe_gmm.last_variant
        ref = moe_gmm_ref(x, w)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        tol = KERNEL_TOL[dtype]
        bad = int((err > tol["atol"] + tol["rtol"] * ref.float().abs())
                  .sum())
        max_err = float(err.max())
        finite = bool(torch.isfinite(out.float()).all())
        errs[(shape, dtype)] = max_err
        emit({"phase": "kernel_check", "kernel": "moe_gmm",
              "shape": list(shape[:4]), "x_expert_stride_0": expand,
              "x_strides": list(x.stride()), "variant": variant,
              "dtype": str(dtype).split(".")[-1], "max_abs_err": max_err,
              "tol": tol, "mismatches": bad, "finite": finite})
        want = {(GMM_PREFILL, torch.bfloat16): "wgmma",
                (GMM_DECODE, torch.bfloat16): "wgmma_swap",
                (GMM_DECODE_DOWN, torch.bfloat16): "wgmma_swap",
                (GMM_EP_PREFILL, torch.bfloat16): "wgmma",
                (GMM_EP_WS, torch.bfloat16): "wgmma_swap",
                (GMM_DS_PREFILL, torch.bfloat16): "wgmma",
                (GMM_DS_PREFILL_DOWN, torch.bfloat16): "wgmma",
                (GMM_DS_DECODE, torch.bfloat16): "wgmma_swap",
                (_GMM_UNALIGNED, torch.bfloat16): "mma_sync"
                }.get((shape, dtype))
        check(want in (None, variant),
              f"moe_gmm took the {variant} variant at {shape}, not {want}")
        check(finite and bad == 0,
              f"moe_gmm disagrees with moe_gmm_ref at {shape} {dtype}: "
              f"{bad} elements out of tolerance, max |err| {max_err}")
        del x, w, out, ref, err

    timings = {}
    for name, shape, iters in (("decode", GMM_DECODE, 20),
                               ("prefill", GMM_PREFILL, 5),
                               ("ep_prefill", GMM_EP_PREFILL, 10),
                               ("ep_ws_decode", GMM_EP_WS, 20),
                               ("deepseek_prefill", GMM_DS_PREFILL, 5)):
        x, w = _gmm_inputs(rng, gen, *shape, torch.bfloat16,
                           shape[2] ** -0.5)
        ms = cuda_ms(lambda: moe_gmm(x, w), iters)
        plain_ms = cuda_ms(lambda: moe_gmm_ref(x, w), iters)
        # yardstick only: the port never calls it
        library_ms = cuda_ms(lambda: torch.matmul(x, w), iters)
        graph = graph_ms(lambda: moe_gmm(x, w), iters)
        library_graph = graph_ms(lambda: torch.matmul(x, w), iters)
        bound_ms, bound_by = gmm_bound(*shape, torch.bfloat16)
        timings[name] = {"shape": list(shape[:4]),
                         "x_expert_stride_0": shape[4],
                         "variant": moe_gmm.last_variant,
                         "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "graph_ms": graph,
                         "library_graph_ms": library_graph,
                         "max_abs_err": errs[(shape, torch.bfloat16)]}
        emit({"phase": "kernel_time", "kernel": "moe_gmm", **timings[name]})
        del x, w
    return {"path": timings["decode"],
            **{k: v for k, v in timings.items() if k != "decode"}}


# --------------------------------------------------------------------------
# 2c'. the backward kernels of K6 and K5 against their plain versions
# --------------------------------------------------------------------------

# (B, H, L, P, N): mamba2-130m's training microbatch (B 8 x S 512 in 2,
# H 24, P 64, N 128, the model's chunk 256), a ragged L with P 128, and N
# 16 at P 32 over several chunks
SSD_BWD_PATH_SHAPE = (4, 24, 512, 64, 128)
_SSD_BWD_SWEEP = [(1, 3, 200, 128, 64), (2, 4, 320, 32, 16),
                  SSD_BWD_PATH_SHAPE]
SSD_MODEL_CHUNK = 256
# the backward's four launches, by the names the profiler gives them
SSD_BWD_STAGES = ("dstate_kernel", "carry_kernel", "chunk_grad_kernel",
                  "reduce_kernel")
# |err| / max(|ref|, 1) of each gradient: the SSD pieces' 5e-5
SSD_BWD_TOL = 5e-5


def ssd_bwd_bound(b, h, l, p, n):
    """Least time (ms) of the scan's gradient: its inputs (x, dt, a, b,
    c, dy) read once and its outputs (dx, ddt, da, db, dc) written once
    over HBM, against the least operations at the f32 peak of the CUDA
    cores: the recurrence's gradient, whose two P x N products a row and
    head (the state's update and its read) each take two of the same size
    backward, 8PN, plus 4(N + P) for the rest."""
    flops = b * h * l * (8 * p * n + 4 * (n + p))
    nbytes = 4 * (2 * (2 * b * h * l * p + b * h * l + 2 * b * l * n + h)
                  - b * h * l * p)
    return _bound(nbytes, flops, PEAK_F32_FLOPS)


def ssd_bwd_tc_bound(b, h, l, p, n, q=SSD_KERNEL_CHUNK):
    """Least time (ms) of the backward kernel's own design: its products'
    least operations at its chunk q (D = dy x^T and (M o dt)^T dy on and
    below the diagonal, (q + 1) P a row each; dCB B and dCB^T C, (q + 1) N
    each; (w o B) G^T, dy h, x G and the states' gradient (dy o e)^T C, 2PN
    each), three times over for 3xTF32, at the dense TF32 peak of the
    tensor cores, against the bytes of ``ssd_bwd_bound``."""
    flops = 3 * b * h * l * (2 * (q + 1) * (p + n) + 8 * p * n)
    nbytes = 4 * (2 * (2 * b * h * l * p + b * h * l + 2 * b * l * n + h)
                  - b * h * l * p)
    return _bound(nbytes, flops, PEAK_TF32_FLOPS)


def _ssd_bwd_args(rng, shape):
    """The model's layouts and decays (``_ssd_inputs``, f32) and dy as
    autograd hands it back through the model's permute."""
    b, h, l, p, n = shape
    x, dt, a, bb, cc = _ssd_inputs(rng, b, h, l, p, n, torch.float32, True)
    dy = torch.from_numpy(rng.standard_normal((b, l, h, p), dtype=np.float32)
                          ).to(DEVICE).permute(0, 2, 1, 3)
    return x, dt, a, bb, cc, dy


def _scaled_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1.0)


def phase_ssd_bwd_kernel(rng) -> dict:
    """K6-bwd (four launches reading the forward's workspace, its products
    in 3xTF32 on the tensor cores) against its plain version at the
    kernel's chunk of 64 and against f64 autograd of the plain forward at
    the model's chunk, each gradient within ``SSD_BWD_TOL`` of its scale;
    two calls bit-equal; timed at mamba2's training microbatch beside both
    bounds (f32 CUDA cores, and the design's 3xTF32 at the TF32 rate)."""
    names = ("dx", "ddt", "da", "db", "dc")
    path_err = None
    for shape in _SSD_BWD_SWEEP:
        args = _ssd_bwd_args(rng, shape)
        _, work = ssd_scan_workspace(*args[:5])
        before = ssd_scan_bwd.launches
        got = ssd_scan_bwd(*args, workspace=work)
        again = ssd_scan_bwd(*args, workspace=work)
        torch.cuda.synchronize()
        per_call = (ssd_scan_bwd.launches - before) // 2
        want = ssd_scan_bwd_ref(*args, chunk=SSD_KERNEL_CHUNK)
        ins = [t.double().requires_grad_(True) for t in args[:5]]
        l = shape[2]
        exact = torch.autograd.grad(
            ssd_scan_ref(*ins, chunk=SSD_MODEL_CHUNK if
                         l % SSD_MODEL_CHUNK == 0 else l), ins,
            args[5].double())
        errs = {k: {"plain": _scaled_err(g, w), "f64": _scaled_err(g, t)}
                for k, g, w, t in zip(names, got, want, exact)}
        max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
        bitwise = all(torch.equal(g, h) for g, h in zip(got, again))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        worst = max(max(e.values()) for e in errs.values())
        emit({"phase": "kernel_check", "kernel": "ssd_scan_bwd",
              "shape": list(shape), "dtype": "float32",
              "scaled_err": errs, "max_abs_err": max_abs,
              "tol": {"scaled": SSD_BWD_TOL, "scaled_by": "max(|ref|, 1)"},
              "bit_equal_calls": bitwise, "launches_per_call": per_call,
              "finite": finite})
        check(finite and worst <= SSD_BWD_TOL,
              f"ssd_scan_bwd disagrees at {shape}: {errs}")
        check(bitwise, f"ssd_scan_bwd: two calls differ at {shape}")
        check(per_call == SSD_BWD_LAUNCHES,
              f"ssd_scan_bwd launched {per_call} kernels a call, not "
              f"{SSD_BWD_LAUNCHES}")
        if shape == SSD_BWD_PATH_SHAPE:
            path_err = max_abs
        del args, work, got, again, want, ins, exact

    args = _ssd_bwd_args(rng, SSD_BWD_PATH_SHAPE)
    _, work = ssd_scan_workspace(*args[:5])

    def kernel():
        return ssd_scan_bwd(*args, workspace=work)

    bound_ms, bound_by = ssd_bwd_bound(*SSD_BWD_PATH_SHAPE)
    bound_tc_ms, bound_tc_by = ssd_bwd_tc_bound(*SSD_BWD_PATH_SHAPE)
    timing = {"shape": list(SSD_BWD_PATH_SHAPE), "dtype": "float32",
              "products": "3xtf32 (mma.sync m16n8k8)",
              "ms": cuda_ms(kernel, 20), "graph_ms": graph_ms(kernel, 10),
              "launches_per_call": SSD_BWD_LAUNCHES,
              "stage_ms": stage_ms(kernel, 10, SSD_BWD_STAGES),
              "forward_ms": cuda_ms(lambda: ssd_scan_workspace(*args[:5]),
                                    20),
              "plain_ms": cuda_ms(lambda: ssd_scan_bwd_ref(
                  *args, chunk=SSD_KERNEL_CHUNK), 5),
              "library_ms": None,  # no single PyTorch call
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_tc_ms": bound_tc_ms, "bound_tc_by": bound_tc_by,
              "max_abs_err": path_err}
    emit({"phase": "kernel_time", "kernel": "ssd_scan_bwd", **timing})
    return {"path": timing}


# (E, C, d, f, x expanded): dbrx-132b's training step at B 2 x S 256 (gate
# and up on the tokens every expert reads; down on the (E, T, f)
# activations), an expert-parallel rank's dispatched tokens at (1, 2) (8
# experts, tp x capacity = 2 x 80 rows), and a sweep of odd shapes
GMM_BWD_PATH = (16, 512, 6144, 10752, True)
GMM_BWD_DOWN = (16, 512, 10752, 6144, False)
GMM_BWD_EP = (8, 160, 6144, 10752, False)
_GMM_BWD_SWEEP = [(3, 77, 100, 60, True), (4, 256, 512, 384, False),
                  (160, 8, 64, 48, True), (2, 63, 200, 1000, False)]
# the path shapes take the wgmma variant (ops.gmm_bwd_variant); its two
# launches by the names the profiler gives them
GMM_BWD_STAGES = ("gmm_bwd_wgmma_kernel<false>", "gmm_bwd_wgmma_kernel<true>")


def gmm_bwd_bound(e, c, d, f, expand, dtype):
    """Least time (ms) of the two products: x (once, also when expanded),
    w and dy read and dx and dw written once over HBM, against 4 E C d f
    operations at the peak for the dtype."""
    size = torch.tensor([], dtype=dtype).element_size()
    xs = (1 if expand else e) * c * d
    nbytes = size * (2 * xs + 2 * e * d * f + e * c * f)
    return _bound(nbytes, 4 * e * c * d * f,
                  PEAK_BF16_FLOPS if dtype == torch.bfloat16
                  else PEAK_F32_FLOPS)


def _gmm_bwd_inputs(rng, gen, e, c, d, f, expand, dtype):
    """x from numpy ((C, d) where expanded), w at the model's scale drawn
    on the card, dy standard normal."""
    x = torch.from_numpy(rng.standard_normal((c, d) if expand else (e, c, d),
                                             dtype=np.float32)).to(DEVICE,
                                                                   dtype)
    w = (torch.randn((e, d, f), device=DEVICE, generator=gen)
         * d ** -0.5).to(dtype)
    dy = torch.randn((e, c, f), device=DEVICE, generator=gen).to(dtype)
    return x, w, dy


def phase_gmm_bwd_kernel(rng) -> dict:
    """K5-bwd (two launches: dx, dw) against its plain version (f32
    accumulation, cast) and, at the path shape, against f64 autograd of
    ``moe_gmm_ref``, scaled by max(|ref|, 1) within KERNEL_TOL; two calls
    bit-equal; each call's variant and split printed, the path shapes
    checked to take wgmma; timed at the path shapes, each launch's device
    time in ``stage_ms``, beside the plain version and ``torch.bmm``
    computing the same two products (dx per expert, not summed; the
    library yardstick, never called by the port)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    cases = [(s, dt) for dt in (torch.float32, torch.bfloat16)
             for s in _GMM_BWD_SWEEP]
    cases += [(GMM_BWD_PATH, torch.bfloat16), (GMM_BWD_DOWN, torch.bfloat16),
              (GMM_BWD_EP, torch.bfloat16)]
    errs = {}
    for shape, dtype in cases:
        e, c, d, f, expand = shape
        x, w, dy = _gmm_bwd_inputs(rng, gen, *shape, dtype)
        before = moe_gmm_bwd.launches
        got = moe_gmm_bwd(x, w, dy, expanded=expand)
        again = moe_gmm_bwd(x, w, dy, expanded=expand)
        torch.cuda.synchronize()
        per_call = (moe_gmm_bwd.launches - before) // 2
        bitwise = all(torch.equal(g, h) for g, h in zip(got, again))
        del again
        refs = {"plain": moe_gmm_bwd_ref(x, w, dy, expanded=expand)}
        if shape == GMM_BWD_PATH:
            xi = x.double().requires_grad_(True)
            wi = w.double().requires_grad_(True)
            refs["f64"] = torch.autograd.grad(
                moe_gmm_ref(xi, wi, expanded=expand), (xi, wi),
                dy.double())
            del xi, wi
        tol = KERNEL_TOL[dtype]
        report, ok = {}, True
        for name, want in refs.items():
            for k, g, r in zip(("dx", "dw"), got, want):
                scale = max(float(r.abs().max()), 1.0)
                err = (g.double() - r.double()).abs() / scale
                bad = int((err > tol["atol"] + tol["rtol"]
                           * r.double().abs() / scale).sum())
                report[f"{k}_{name}"] = {"max_scaled_err": float(err.max()),
                                         "mismatches": bad}
                ok = ok and bad == 0
                del err
        max_abs = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(got, refs["plain"]))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        errs[(shape, dtype)] = max_abs
        variant, split = moe_gmm_bwd.last_variant, moe_gmm_bwd.last_split
        emit({"phase": "kernel_check", "kernel": "moe_gmm_bwd",
              "shape": list(shape[:4]), "x_expert_stride_0": expand,
              "dtype": str(dtype).split(".")[-1], "variant": variant,
              "split": split, "errors": report,
              "max_abs_err": max_abs, "tol": {**tol,
                                              "scaled_by": "max(|ref|, 1)"},
              "bit_equal_calls": bitwise, "launches_per_call": per_call,
              "finite": finite})
        check(finite and ok, f"moe_gmm_bwd disagrees at {shape} {dtype}: "
                             f"{report}")
        check(bitwise, f"moe_gmm_bwd: two calls differ at {shape}")
        check(per_call == GMM_BWD_LAUNCHES,
              f"moe_gmm_bwd launched {per_call} kernels a call")
        if shape in (GMM_BWD_PATH, GMM_BWD_DOWN, GMM_BWD_EP):
            check(variant == "wgmma",
                  f"moe_gmm_bwd took {variant} at the path shape {shape}")
        del x, w, dy, got, refs
        _release()

    timings = {}
    for name, shape, iters in (("training", GMM_BWD_PATH, 3),
                               ("training_down", GMM_BWD_DOWN, 3),
                               ("ep_training", GMM_BWD_EP, 5)):
        e, c, d, f, expand = shape
        x, w, dy = _gmm_bwd_inputs(rng, gen, *shape, torch.bfloat16)
        xe = x.expand(e, c, d) if expand else x

        def kernel():
            return moe_gmm_bwd(x, w, dy, expanded=expand)

        def library():  # yardstick only: the port never calls it
            return (torch.bmm(dy, w.transpose(1, 2)),
                    torch.bmm(xe.transpose(1, 2), dy))

        bound_ms, bound_by = gmm_bwd_bound(*shape, torch.bfloat16)
        timings[name] = {
            "shape": list(shape[:4]), "x_expert_stride_0": expand,
            "dtype": "bfloat16", "ms": cuda_ms(kernel, iters),
            "graph_ms": graph_ms(kernel, iters),
            "variant": moe_gmm_bwd.last_variant,
            "split": moe_gmm_bwd.last_split,
            "stage_ms": stage_ms(kernel, iters, GMM_BWD_STAGES),
            "launches_per_call": GMM_BWD_LAUNCHES,
            "plain_ms": cuda_ms(lambda: moe_gmm_bwd_ref(
                x, w, dy, expanded=expand), iters),
            "library_ms": cuda_ms(library, iters),
            "library_graph_ms": graph_ms(library, iters),
            "library": "torch.bmm x 2", "bound_ms": bound_ms,
            "bound_by": bound_by,
            "max_abs_err": errs[(shape, torch.bfloat16)]}
        emit({"phase": "kernel_time", "kernel": "moe_gmm_bwd",
              **timings[name]})
        del x, xe, w, dy
        _release()
    return {"path": timings["training"],
            **{k: v for k, v in timings.items() if k != "training"}}


# --------------------------------------------------------------------------
# 2d. compression kernels (K2a, K2b, K3, K4) against their plain versions
# --------------------------------------------------------------------------

# the compression kernels compute in f32 on the CUDA cores

def quantize_bound(m: int, n: int, stochastic: bool = False):
    """Read x (f32) and the random bits once, write q and the scales; ~6
    operations a value (abs, max, divide, round, two clamps)."""
    return _bound(4 * m * n * (2 if stochastic else 1) + m * n + 4 * m,
                  6 * m * n, PEAK_F32_FLOPS)


def dequantize_bound(m: int, n: int):
    return _bound(m * n + 4 * m + 4 * m * n, m * n, PEAK_F32_FLOPS)


def sparsify_bound(m: int, n: int):
    return _bound(4 * m * n + 4 * m + 4 * m * n, 2 * m * n, PEAK_F32_FLOPS)


def matmul_bound(m: int, k: int, n: int):
    return _bound(4 * (m * k + k * n + m * n), 2 * m * k * n,
                  PEAK_F32_FLOPS)


def gradient_values() -> int:
    """Values of qwen2-0.5b's gradient: its parameters, counted on the meta
    device (nothing allocated)."""
    params = init_params(get_config(ARCH), torch.Generator(), device="meta")
    return sum(t.numel() for t in param_leaves(params))


def _gradient_rows(n_values: int) -> int:
    return -(-n_values // ROW_LEN)


def _check_quantize(x, bits: int, stochastic: bool, label: str):
    """K2a and K2b on x (m, n) against their plain versions on the card:
    q and the decode bit-equal, scales within rtol 1e-6.  Returns the max
    |err| of q and of the decode."""
    rand = (cref.random_bits(x.shape, torch.Generator(device=DEVICE)
                             .manual_seed(x.numel()), DEVICE)
            if stochastic else None)
    q, s = cops.quantize_kernel(x, rand, bits=bits, stochastic=stochastic)
    out = cops.dequantize_kernel(q, s)
    q_ref, s_ref = cref.quantize_ref(x, bits, stochastic, rand, per_row=True)
    out_ref = cref.dequantize_ref(q, s)
    torch.cuda.synchronize()
    q_bad = int((q != q_ref).sum())
    s_rel = float(((s - s_ref).abs() / s_ref).max())
    d_bad = int((out != out_ref).sum())
    emit({"phase": "kernel_check", "kernel": "quantize+dequantize",
          "case": label, "shape": list(x.shape),
          "dtype": str(x.dtype).split(".")[-1], "bits": bits,
          "stochastic": stochastic,
          "variant": cops.dequantize_kernel.last_variant,
          "q_mismatches": q_bad,
          "scale_max_rel_err": s_rel, "dequantize_mismatches": d_bad,
          "tol": {"q": "bit-equal", "scale_rtol": 1e-6,
                  "dequantize": "bit-equal"}})
    check(q_bad == 0 and s_rel <= 1e-6 and d_bad == 0,
          f"quantize/dequantize disagree with the plain versions at {label} "
          f"{tuple(x.shape)} bits={bits} stochastic={stochastic}: {q_bad} q, "
          f"scale rel err {s_rel}, {d_bad} decoded values")
    return (float((q.float() - q_ref.float()).abs().max()),
            float((out - out_ref).abs().max()))


def _check_dequantize(q, s, label: str, want: str) -> None:
    """K2b against its plain version and ``torch.mul``, both bit-equal, on
    the variant the layout gives."""
    out = cops.dequantize_kernel(q, s)
    variant = cops.dequantize_kernel.last_variant
    bad = int((out != cref.dequantize_ref(q, s)).sum())
    lib_bad = int((out != torch.mul(q, s)).sum())
    emit({"phase": "kernel_check", "kernel": "dequantize", "case": label,
          "shape": list(q.shape), "q_address_mod_16": q.data_ptr() % 16,
          "variant": variant, "mismatches": bad,
          "library_mismatches": lib_bad, "tol": "bit-equal"})
    check(variant == want, f"dequantize took {variant} at {label}, not "
          f"{want}")
    check(bad == 0 and lib_bad == 0, f"dequantize disagrees at {label}: "
          f"{bad} values with dequantize_ref, {lib_bad} with torch.mul")


def _int8_rows(m: int, n: int, offset: int, seed: int):
    """q (m, n) int8 starting ``offset`` bytes into a fresh allocation, and
    positive f32 scales (m, 1)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    flat = torch.randint(-127, 128, (offset + m * n,), generator=gen,
                         device=DEVICE, dtype=torch.int8)
    s = torch.rand((m, 1), generator=gen, device=DEVICE) + 0.01
    return flat[offset:].view(m, n), s


def _check_sparsify(x, t, label: str) -> float:
    out = cops.sparsify_kernel(x, t)
    bad = int((out != cref.sparsify_ref(x, t)).sum())
    emit({"phase": "kernel_check", "kernel": "sparsify", "case": label,
          "shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
          "kept": int((out != 0).sum()), "mismatches": bad,
          "tol": "bit-equal"})
    check(bad == 0, f"sparsify disagrees with sparsify_ref at {label}: {bad}")
    return float((out - cref.sparsify_ref(x, t)).abs().max())


def _check_matmul(a, b, label: str, scaled: bool, want: str) -> float:
    """K4 against its plain version: within atol and rtol 1e-5 at the JAX
    test's shapes; at the path's (k up to 151,936) the difference of two
    f32 summation orders grows with the terms, not the sum, so there it is
    held within 1e-5 of |a| @ |b|.  ``want``: the route the layout gives."""
    out = cops.matmul_kernel(a, b)
    variant = cops.matmul_kernel.last_variant
    ref = cref.matmul_ref(a, b)
    err = (out - ref).abs()
    if scaled:
        scale = cref.matmul_ref(a.abs(), b.abs())
        bad = int((err > 1e-5 * scale).sum())
        tol = {"rtol_of_abs_product": 1e-5}
    else:
        bad = int((err > 1e-5 + 1e-5 * ref.abs()).sum())
        tol = {"atol": 1e-5, "rtol": 1e-5}
    max_err = float(err.max())
    emit({"phase": "kernel_check", "kernel": "matmul", "case": label,
          "a": list(a.shape), "a_strides": list(a.stride()),
          "b": list(b.shape), "b_strides": list(b.stride()),
          "dtype": str(a.dtype).split(".")[-1], "variant": variant,
          "max_abs_err": max_err, "ref_max_abs": float(ref.abs().max()),
          "tol": tol, "mismatches": bad})
    check(variant == want, f"matmul took {variant} at {label}, not {want}")
    check(bad == 0 and bool(torch.isfinite(out).all()),
          f"matmul disagrees with matmul_ref at {label}: {bad} elements, "
          f"max |err| {max_err}")
    return max_err


def _randn(*shape, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def _mt_p(m: int, k: int, n: int, a_layout: str, p_layout: str, dtype,
          seed: int):
    """M^T (m, k) and P (k, n) as the codec lays them out: M^T a view of a
    row-major (k, m) M ("t"), or of the first m columns of a wider one
    ("t_slice", rows 16-byte aligned for both dtypes); P row-major or
    column-major (QR's layout)."""
    width = m if a_layout == "t" else (m + 8) // 8 * 8
    a = _randn(k, width, dtype=dtype, seed=seed)[:, :m].T
    b = (_randn(k, n, dtype=dtype, seed=seed + 1) if p_layout == "rows"
         else _randn(n, k, dtype=dtype, seed=seed + 1).T)
    return a, b


# K4's streamed route on the layouts it takes, each M above the 48 MiB from
# which the wrapper streams it: (label, m, k, n, M^T layout, P layout,
# dtype); m = 898 leaves a ragged quad, k = 15003 a ragged last block,
# m = 4864 (the MLP's width) five column slices
MM_BULK_CASES = [
    ("P column-major", 896, 15000, 4, "t", "cols", torch.float32),
    ("P row-major", 896, 15000, 4, "t", "rows", torch.float32),
    ("rank 8", 896, 15000, 8, "t", "cols", torch.float32),
    ("rank 3, P row-major", 896, 15000, 3, "t", "rows", torch.float32),
    ("m = 898 of 904", 898, 15000, 4, "t_slice", "cols", torch.float32),
    ("k = 15003", 896, 15003, 4, "t", "cols", torch.float32),
    ("wide M, 4864", 4864, 2700, 4, "t", "cols", torch.float32),
    ("bf16", 896, 30000, 4, "t", "cols", torch.bfloat16),
    ("bf16 wide ragged", 4862, 5500, 3, "t_slice", "rows", torch.bfloat16),
]


def phase_compress_kernels(n_values: int) -> dict:
    """K2a, K2b, K3 and K4 on the JAX tests' shapes (tests/test_compress.py:
    186-232, as the payload-level rows), ragged rows and the paths' shapes;
    times at the paths' shapes."""
    rows = _gradient_rows(n_values)
    for bits in (8, 4):
        for stochastic in (False, True):
            for label, shape, dtype in (
                    ("test (256,)", (1, 256), torch.float32),
                    ("test (8,256)", (8, 256), torch.float32),
                    ("test (3,100)", (2, 256), torch.float32),
                    ("ragged", (7, 33), torch.float32),
                    ("ragged bf16", (7, 33), torch.bfloat16),
                    ("long ragged", (3, 10001), torch.float32),
                    ("long bf16", (2, 70003), torch.bfloat16),
                    ("ring chunk", (1, RING_CHUNK), torch.float32)):
                _check_quantize(_randn(*shape, dtype=dtype, seed=len(label)),
                                bits, stochastic, label)
    grad_rows = _randn(rows, ROW_LEN, seed=1)
    path_err = {}
    for bits in (8, 4):
        path_err[bits] = _check_quantize(grad_rows, bits, False,
                                         "gradient rows")
    chunk_err = _check_quantize(_randn(1, RING_CHUNK, seed=12), 8, False,
                                "ring chunk, timed")
    t = torch.full((rows, 1), 1.645, device=DEVICE)  # ~95th pct of |N(0,1)|
    sp_err = _check_sparsify(grad_rows, t, "gradient rows")
    for label, shape, dtype in (("test (512,)", (2, 256), torch.float32),
                                ("ragged", (7, 33), torch.float32),
                                ("ragged bf16", (7, 33), torch.bfloat16)):
        x = _randn(*shape, dtype=dtype, seed=3)
        _check_sparsify(x, torch.full((shape[0], 1), 1.0, device=DEVICE),
                        label)

    for label, (m, n), offset, want in (
            ("one row", (1, 4096), 0, "vec16"),
            ("rows of 256", (4096, 256), 0, "vec16"),
            ("rows of 48 (n / 16 = 3)", (1000, 48), 0, "vec16"),
            ("ragged n", (5, 100), 0, "vec4"),
            ("ragged n", (7, 33), 0, "scalar"),
            ("ragged n, one row", (1, 33), 0, "scalar"),
            ("view at 4 bytes", (4, 256), 4, "vec4"),
            ("unaligned view", (4, 256), 1, "scalar"),
            ("unaligned view, one row", (1, 4096), 3, "scalar")):
        _check_dequantize(*_int8_rows(m, n, offset, m + n + offset), label,
                          want)

    _check_matmul(_randn(128, 64, seed=4), _randn(64, 4, seed=5),
                  "test (128,64)x(64,4)", scaled=False, want="rows")
    _check_matmul(_randn(100, 37, seed=6), _randn(37, 3, seed=7), "ragged",
                  scaled=False, want="rows")
    _check_matmul(_randn(37, 100, seed=6).T, _randn(37, 3, seed=7),
                  "ragged, a transposed", scaled=False, want="cols")
    _check_matmul(_randn(896, 4864, seed=6).T,
                  _randn(4, 896, seed=7).T, "the MLP's M^T @ P (17 MB)",
                  scaled=True, want="cols")
    _check_matmul(_randn(70, 50, seed=8), _randn(50, 40, seed=9),
                  "general", scaled=False, want="tiled")
    _check_matmul(_randn(128, 64, dtype=torch.bfloat16, seed=4),
                  _randn(64, 4, dtype=torch.bfloat16, seed=5), "bf16",
                  scaled=False, want="rows")
    for i, (label, m, k, n, a_layout, p_layout, dtype) in enumerate(
            MM_BULK_CASES):
        a, b = _mt_p(m, k, n, a_layout, p_layout, dtype, 20 + 2 * i)
        _check_matmul(a, b, f"M^T @ P, {label}", scaled=True,
                      want="cols_bulk")
    del a, b
    cfg = get_config(ARCH)
    m_rows, m_cols = cfg.padded_vocab, cfg.d_model
    mat = _randn(m_rows, m_cols, seed=10)       # the embedding gradient
    q0 = _randn(m_cols, LOWRANK_RANK, seed=11)
    p, _ = torch.linalg.qr(cref.matmul_ref(mat, q0))
    q = cref.matmul_ref(mat.T, p)
    products = {"project": (mat, q0, "rows"),
                "project_t": (mat.T, p, "cols_bulk"),  # P column-major
                "decode": (p, q.T, "smallk")}
    errs = {name: _check_matmul(a, b, f"path {name}", scaled=True, want=want)
            for name, (a, b, want) in products.items()}

    timings = {"quantize": {}, "dequantize": {}, "sparsify": {},
               "matmul": {}}
    # K2a and K2b: "path" is the shape of their main path, the collectives
    # (one ring chunk a hop, two K2a launches); the payload-level rows of
    # the codec path are the second case.  The checked inputs, drawn again.
    # ``graph_ms`` replays the calls from a CUDA graph (the device alone);
    # where ``ms`` is larger, the host sets the pace of back-to-back calls.
    for key, x, iters, err in (
            ("path", _randn(1, RING_CHUNK, seed=12), 200, chunk_err),
            ("gradient_rows", grad_rows, 20, path_err[8])):
        m, n = x.shape
        q8, s8 = cops.quantize_kernel(x)
        bound_ms, bound_by = quantize_bound(m, n)
        graph_iters = max(4, iters // 4)
        timings["quantize"][key] = {
            "shape": [m, n], "dtype": "float32", "bits": 8,
            "ms": cuda_ms(lambda: cops.quantize_kernel(x), iters),
            "graph_ms": graph_ms(lambda: cops.quantize_kernel(x),
                                 graph_iters),
            "plain_ms": cuda_ms(lambda: cref.quantize_ref(x, per_row=True),
                                max(2, iters // 10)),
            # no single PyTorch call: quantize_per_tensor_dynamic scales by
            # min/max with a zero point, the other quantize calls take the
            # scale as an input
            "library_ms": None, "library_graph_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err[0]}
        # yardstick only, the port never calls it: int8 times the f32 (m, 1)
        # scale promotes to f32 in one elementwise kernel, as dequantize_ref
        # does in two
        out = cops.dequantize_kernel(q8, s8)
        variant = cops.dequantize_kernel.last_variant
        lib_bad = int((torch.mul(q8, s8) != out).sum())
        check(lib_bad == 0, f"torch.mul(q, scale) differs from dequantize "
              f"at {key} in {lib_bad} values")
        bound_ms, bound_by = dequantize_bound(m, n)
        del out
        timings["dequantize"][key] = {
            "shape": [m, n], "dtype": "int8", "variant": variant,
            "ms": cuda_ms(lambda: cops.dequantize_kernel(q8, s8), iters),
            "graph_ms": graph_ms(lambda: cops.dequantize_kernel(q8, s8),
                                 graph_iters),
            "plain_ms": cuda_ms(lambda: cref.dequantize_ref(q8, s8),
                                max(2, iters // 4)),
            "library_ms": cuda_ms(lambda: torch.mul(q8, s8), iters),
            "library_graph_ms": graph_ms(lambda: torch.mul(q8, s8),
                                         graph_iters),
            "library_mismatches": lib_bad,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err[1]}
        del q8, s8
    # yardstick only: with one threshold for every row, as the payload-level
    # sparsify passes it, hardshrink at the next f32 below t keeps |x| >= t
    lambd = float(torch.nextafter(t[0, 0], t.new_zeros(())))
    lib_bad = int((F.hardshrink(grad_rows, lambd)
                   != cops.sparsify_kernel(grad_rows, t)).sum())
    check(lib_bad == 0, f"hardshrink differs from sparsify in {lib_bad} "
          f"values")
    m, n = grad_rows.shape
    bound_ms, bound_by = sparsify_bound(m, n)
    timings["sparsify"]["path"] = {
        "shape": [m, n], "dtype": "float32", "ms": cuda_ms(
            lambda: cops.sparsify_kernel(grad_rows, t), 20),
        "graph_ms": graph_ms(lambda: cops.sparsify_kernel(grad_rows, t), 5),
        "plain_ms": cuda_ms(lambda: cref.sparsify_ref(grad_rows, t), 5),
        "library_ms": cuda_ms(lambda: F.hardshrink(grad_rows, lambd), 20),
        "library_graph_ms": graph_ms(
            lambda: F.hardshrink(grad_rows, lambd), 5),
        "library_mismatches": lib_bad,
        "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": sp_err}
    # the same values as one row with one threshold, as the payload-level
    # sparsify passes them (the codec path's launch)
    one_row = grad_rows.view(1, -1)
    t1 = t[:1]
    bad = int((cops.sparsify_kernel(one_row, t1)
               != cref.sparsify_ref(one_row, t1)).sum())
    check(bad == 0, f"sparsify disagrees with sparsify_ref on one row: "
          f"{bad}")
    timings["sparsify"]["one_row"] = {
        "shape": list(one_row.shape), "dtype": "float32", "ms": cuda_ms(
            lambda: cops.sparsify_kernel(one_row, t1), 20),
        "graph_ms": graph_ms(lambda: cops.sparsify_kernel(one_row, t1), 5),
        "library_graph_ms": graph_ms(
            lambda: F.hardshrink(one_row, lambd), 5),
        "bound_ms": bound_ms, "bound_by": bound_by, "mismatches": bad}
    for name, (a, b, _) in products.items():
        key = "path" if name == "project" else name
        bound_ms, bound_by = matmul_bound(a.shape[0], a.shape[1], b.shape[1])
        cops.matmul_kernel(a, b)
        timings["matmul"][key] = {
            "shape": [list(a.shape), list(b.shape)],
            "strides": [list(a.stride()), list(b.stride())],
            "dtype": "float32", "variant": cops.matmul_kernel.last_variant,
            "ms": cuda_ms(lambda: cops.matmul_kernel(a, b), 20),
            "graph_ms": graph_ms(lambda: cops.matmul_kernel(a, b), 10),
            "plain_ms": cuda_ms(lambda: cref.matmul_ref(a, b), 20),
            # yardstick only: the port never calls it
            "library_ms": cuda_ms(lambda: torch.matmul(a, b), 20),
            "library_graph_ms": graph_ms(lambda: torch.matmul(a, b), 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": errs[name]}
    for name, t_by_key in timings.items():
        for key, t in t_by_key.items():
            emit({"phase": "kernel_time", "kernel": name, "case": key, **t})
    del grad_rows, one_row, t1, mat, q0, p, q, products, t
    _release()
    return timings


# --------------------------------------------------------------------------
# codecs over qwen2-0.5b's full gradient (the codec path)
# --------------------------------------------------------------------------

def _plain_decode(name: str, codec, g):
    """The codec's decode computed by the plain versions on the card."""
    if name in ("q8", "q4"):
        bits = codec.bits
        q, s = cref.quantize_ref(g.reshape(-1), bits)
        if bits == 4:
            q = cref.unpack_int4(cref.pack_int4(q), q.numel())
        return cref.dequantize_ref(q, s).reshape(g.shape)
    m, n = _matrix_shape(tuple(g.shape))
    mat = g.reshape(m, n)
    r = min(codec.rank, m, n)
    p, _ = torch.linalg.qr(cref.matmul_ref(mat, codec._test_matrix(n, r,
                                                                   g.device)))
    q = cref.matmul_ref(mat.T, p)
    return cref.matmul_ref(p, q.T).reshape(g.shape)


def _run_codec(name: str, grads, gradient: str = "stand-in") -> dict:
    """encode -> decode over every tensor, the error-feedback state carried
    over two steps; checks against the spec and the plain versions, and on
    the stand-in (where the JAX tests define it) against the regime; on
    the real gradient the error is reported beside the regime."""
    codec = get_codec(name)
    n0 = launch_counts()
    states = [codec.init_state(g) for g in grads]
    acc = [torch.zeros_like(g) for g in grads] if codec.spec.error_feedback \
        else None
    norm2 = sum(float(g.double().square().sum()) for g in grads)
    n_bytes = 4 * sum(g.numel() for g in grads)
    steps = []
    for step in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wire, decs = 0, []
        for i, g in enumerate(grads):
            enc, states[i] = codec.encode(g, states[i])
            wire += enc.wire_bytes
            decs.append(codec.decode(enc))
            del enc
        end.record()
        torch.cuda.synchronize()
        err2 = sum(float((d - g).double().square().sum())
                   for d, g in zip(decs, grads))
        steps.append({"ms": start.elapsed_time(end), "wire_bytes": wire,
                      "rel_l2_err": (err2 / norm2) ** 0.5})
        if step == 0:
            plain = [_plain_decode(name, codec, g) for g in grads] \
                if name != "topk" else None
            if name in ("q8", "q4"):
                bad = sum(int((d != pd).sum()) for d, pd in zip(decs, plain))
                steps[0]["plain_mismatches"] = bad
                check(bad == 0, f"{name}: decode differs from the plain "
                      f"versions in {bad} values")
            elif name == "lowrank":
                d2 = sum(float((d - pd).double().square().sum())
                         for d, pd in zip(decs, plain))
                p2 = sum(float(pd.double().square().sum()) for pd in plain)
                rel = (d2 / p2) ** 0.5
                steps[0]["plain_rel_l2_diff"] = rel
                check(rel <= 1e-4, f"lowrank decode differs from the plain "
                      f"versions by {rel} relative (tolerance 1e-4)")
            del plain
        if acc is not None:
            for a, d in zip(acc, decs):
                a.add_(d)
        del decs
    result = {"codec": name, "steps": steps,
              "wire_ratio": steps[0]["wire_bytes"] / n_bytes,
              "spec_wire_ratio": codec.spec.wire_ratio,
              "launches": _delta(n0)}
    if acc is not None:  # the residual is the mass not yet transmitted
        gap2 = sum(float((2 * g - a - st).double().square().sum())
                   for g, a, st in zip(grads, acc, states))
        result["ef_invariant_rel_err"] = (gap2 / norm2) ** 0.5
        check(result["ef_invariant_rel_err"] <= 1e-5,
              f"{name}: residual != accumulated bias "
              f"({result['ef_invariant_rel_err']})")
    result["regime"] = CODEC_REGIME[name]
    result["within_regime"] = steps[0]["rel_l2_err"] <= CODEC_REGIME[name]
    emit({"phase": "codec", "arch": ARCH, "gradient": gradient, **result})
    check(result["within_regime"] or gradient != "stand-in",
          f"{name}: relative L2 error {steps[0]['rel_l2_err']} beyond "
          f"{CODEC_REGIME[name]}")
    check(result["wire_ratio"] <= 2 * codec.spec.wire_ratio,
          f"{name}: wire ratio {result['wire_ratio']} beyond 2x the spec's "
          f"{codec.spec.wire_ratio}")
    return result


def _padded_rows_sparsify(flat, thresh):
    """The payload-level sparsify through the JAX package's layout: the
    payload zero-padded to rows of 256 (a copy), one threshold a row, then
    cut back."""
    rows, n = cops._as_rows(flat, ROW_LEN)
    t = torch.full((rows.shape[0], 1), float(thresh), dtype=torch.float32,
                   device=rows.device)
    return cops.sparsify_kernel(rows, t).reshape(-1)[:n].reshape(flat.shape)


def _payload_sparsify_routes(flat, thresh) -> None:
    """The payload-level sparsify over the flattened gradient: padded rows
    against the one row ``cops.sparsify`` passes, in turns; device ms back
    to back and the peak memory a call allocates beyond what was held."""
    def new():
        return cops.sparsify(flat, thresh, row_len=ROW_LEN)

    def old():
        return _padded_rows_sparsify(flat, thresh)

    bad = int((new() != old()).sum())
    check(bad == 0, f"one-row sparsify differs from padded rows in {bad}")
    runs = []
    for name, fn in (("padded_rows", old), ("one_row", new),
                     ("one_row", new), ("padded_rows", old)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        del out
        runs.append({"route": name, "ms": cuda_ms(fn, 5),
                     "peak_bytes": peak})
    emit({"phase": "payload_sparsify", "values": flat.numel(),
          "mismatches": bad, "runs": runs})
    _release()


def phase_codecs(seed: int) -> dict:
    """The codec path at full width and depth: one stand-in gradient tensor
    per parameter of qwen2-0.5b (seeded normal values, where the JAX
    tests' error regime is defined; ``phase_codecs_real`` takes a real
    gradient) through q8, q4, topk and
    lowrank, then the payload-level ops over the flattened gradient and
    the projection per matrix.  Launch counts set to 0 just before, read
    just after."""
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    grads = list(param_leaves(params))
    for g in grads:
        g.normal_(generator=gen)  # the stand-in gradient, in place
    n_values = sum(g.numel() for g in grads)
    torch.cuda.synchronize()

    reset_launch_counts()
    codecs = {name: _run_codec(name, grads) for name in CODEC_REGIME}

    flat = torch.cat([g.reshape(-1) for g in grads])
    n0 = launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    q, scales, shape = cops.quantize(flat, row_len=ROW_LEN)
    dec = cops.dequantize(q, scales, shape)
    sample = flat[::101].abs()
    thresh = float(sample.kthvalue(int(0.95 * sample.numel())).values)
    kept = cops.sparsify(flat, thresh, row_len=ROW_LEN)
    projections = 0
    for g in grads:
        if g.dim() == 2:
            q0 = get_codec("lowrank")._test_matrix(g.shape[1], LOWRANK_RANK,
                                                   g.device)
            proj = cops.lowrank_project(g, q0)
            check(bool(torch.isfinite(proj).all()), "non-finite projection")
            projections += 1
    end.record()
    torch.cuda.synchronize()
    payload_launches = _delta(n0)
    counts = launch_counts()
    dq_err = float((dec - flat).abs().max())
    dq_bound = float(flat.abs().max()) / 127
    sp_bad = int((kept != cref.sparsify_ref(flat, thresh)).sum())
    emit({"phase": "codec_payload", "arch": ARCH, "values": n_values,
          "rows": list(q.shape), "ms": start.elapsed_time(end),
          "dequantize_max_abs_err": dq_err, "bound": dq_bound,
          "sparsify_threshold": thresh,
          "sparsify_kept": int((kept != 0).sum()),
          "sparsify_plain_mismatches": sp_bad,
          "projections": projections, "launches": payload_launches,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    check(tuple(dec.shape) == tuple(flat.shape) and dq_err <= dq_bound,
          f"payload quantize: max |err| {dq_err} beyond {dq_bound}")
    check(sp_bad == 0, f"payload sparsify differs from plain in {sp_bad}")
    for name in ("quantize", "dequantize", "sparsify", "matmul"):
        check(counts[name] > 0, f"kernel {name} not launched on the codec "
              f"path")
    del q, scales, dec, kept, sample
    _payload_sparsify_routes(flat, thresh)
    del params, grads, flat
    _release()
    return {"counts": counts, "values": n_values,
            "ms": {k: [s["ms"] for s in v["steps"]]
                   for k, v in codecs.items()}}


def phase_codecs_real(seed: int) -> dict:
    """The codecs over the real gradient of one qwen2-0.5b step (f32, B 8 x
    S 512 in 2 microbatches, remat), taken by the step's hook before
    AdamW, beside the stand-in: error, wire ratio, and the kernels against
    their plain versions.  Returns the launch counts."""
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    batch = next(make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed))
    taken = []

    def hook(stage, grads):
        if stage == "synced":  # one card: the same list as "local"
            taken.extend(g.detach().clone() for g in grads)

    step = make_train_step(cfg, TrainConfig(**dict(TRAIN_TCFG,
                                                   grad_dtype="f32")))
    params, opt, m = step(params, init_opt_state(params), batch,
                          grad_hook=hook)
    loss = float(m["loss"])
    del params, opt, step
    _release()
    reset_launch_counts()
    codecs = {name: _run_codec(name, taken, gradient="real")
              for name in CODEC_REGIME}
    counts = launch_counts()
    emit({"phase": "codec_real_gradient", "arch": ARCH, "loss": loss,
          "values": sum(g.numel() for g in taken),
          "rel_l2_err": {k: v["steps"][0]["rel_l2_err"]
                         for k, v in codecs.items()},
          "wire_ratio": {k: v["wire_ratio"] for k, v in codecs.items()},
          "outside_regime": [k for k, v in codecs.items()
                             if not v["within_regime"]],
          "launches": counts})
    del taken
    _release()
    return counts


# --------------------------------------------------------------------------
# collectives: 4 gloo ranks on the one card (the collective path)
# --------------------------------------------------------------------------

def _bucket_grad(seed: int, rank: int, b: int, n: int):
    """Bucket ``b`` of rank ``rank``'s stand-in gradient: regenerable by
    every rank from the seeds alone."""
    gen = torch.Generator(device=DEVICE).manual_seed(
        seed * 1_000_003 + rank * 1009 + b)
    return torch.randn(n, generator=gen, device=DEVICE)


def collective_rank(rank: int, world: int, n_values: int, seed: int
                    ) -> dict:
    """One gloo rank: its stand-in gradient of qwen2-0.5b synced in 64 MiB
    buckets by each implementation, checked bucket by bucket against the
    sum of all ranks' buckets, regenerated from their seeds."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    buckets = [(lo, min(lo + BUCKET, n_values))
               for lo in range(0, n_values, BUCKET)]
    grad = torch.cat([_bucket_grad(seed, rank, b, hi - lo)
                      for b, (lo, hi) in enumerate(buckets)])
    truth = torch.empty_like(grad)
    sabs = torch.empty_like(grad)
    amax = []
    for b, (lo, hi) in enumerate(buckets):
        parts = [_bucket_grad(seed, r, b, hi - lo) for r in range(world)]
        truth[lo:hi] = sum(parts)
        sabs[lo:hi] = sum(p.abs() for p in parts)
        amax.append(max(float(p.abs().max()) for p in parts))
        del parts
    out = torch.empty_like(grad)
    reset_launch_counts()

    def run(name, fn, sel):
        dist.barrier()
        torch.cuda.synchronize()
        ex = ccl_prim._permute
        sent0, staged0, wait0 = ex.sent_bytes, ex.staged_bytes, ex.seconds
        t0 = time.perf_counter()
        for lo, hi in sel:
            out[lo:hi] = fn(grad[lo:hi])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        worst, checksums = 0.0, []
        for b, (lo, hi) in enumerate(sel):
            err = (out[lo:hi] - truth[lo:hi]).abs()
            if name in ("ring", "bidir_ring", "atp"):
                # the order-free form of rtol 1e-6: rounding of a sum in
                # any order stays below eps times the sum of magnitudes
                ratio = float((err / (1e-6 * sabs[lo:hi])).max())
            elif name == "atp_q8":  # tests/test_synth.py:_LOWERING
                bound = 2 * world * float(truth[lo:hi].abs().max()) / 127
                ratio = float(err.max()) / bound
            else:  # p * absmax / qmax, tests/test_ccl_primitives.py:100-103
                qmax = 127 if name == "ring_q8" else 7
                ratio = float(err.max()) / (world * amax[b] / qmax)
            worst = max(worst, ratio)
            checksums.append(int(out[lo:hi].view(torch.int32).sum(
                dtype=torch.int64)))
        return {"seconds": seconds, "buckets": len(sel),
                "values": sum(hi - lo for lo, hi in sel),
                "wire_bytes": ex.sent_bytes - sent0,
                "staged_bytes": ex.staged_bytes - staged0,
                "exchange_seconds": ex.seconds - wait0,
                "worst_err_over_tol": worst, "checksums": checksums}

    results = {}
    for name in ("ring_q8", "ring_q4", "ring", "bidir_ring"):
        results[name] = run(name, ccl_prim.IMPLEMENTATIONS[name], buckets)
    sched = atp_schedule(types.SimpleNamespace(
        task_id="bucket", group=tuple(range(world)),
        size_bytes=BUCKET_BYTES))
    for name, bits in (("atp", None), ("atp_q8", 8)):
        results[name] = run(name, ccl_prim.make_synthesized(sched, bits=bits),
                            buckets[:SYNTH_BUCKETS])
    return {"results": results, "launches": launch_counts(),
            "backend": dist.get_backend(), "device": str(grad.device)}


def phase_collectives(n_values: int, seed: int) -> dict:
    """The collective path: RING_RANKS processes share the one card over
    gloo (NCCL refuses two ranks on one device); each syncs its own
    stand-in gradient in 64 MiB buckets through ring_q8 and ring_q4 (K2a
    and K2b in every hop), ring and bidir_ring, and the ATP schedule with
    and without q8.  The times are gloo over loopback, staged through the
    host, and say nothing of NCCL or NVLink."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(collective_rank, RING_RANKS, n_values, seed,
                        backend="gloo", timeout_s=900)
    wall = time.perf_counter() - t0
    counts = {k: sum(r["launches"][k] for r in ranks) for k in WRAPPERS}
    for name in ranks[0]["results"]:
        per = [r["results"][name] for r in ranks]
        same = all(p["checksums"] == per[0]["checksums"] for p in per)
        worst = max(p["worst_err_over_tol"] for p in per)
        n_b = per[0]["buckets"]
        emit({"phase": "collective", "impl": name, "ranks": RING_RANKS,
              "backend": ranks[0]["backend"], "tensors": ranks[0]["device"],
              "buckets": n_b, "bucket_bytes": BUCKET_BYTES,
              "values": per[0]["values"],
              "seconds": max(p["seconds"] for p in per),
              "exchange_seconds": max(p["exchange_seconds"] for p in per),
              "full_gradient": per[0]["values"] == n_values,
              "wire_bytes_per_rank": per[0]["wire_bytes"],
              "staged_bytes_per_rank": per[0]["staged_bytes"],
              "worst_err_over_tol": worst, "identical_on_all_ranks": same})
        # the ATP root keeps its exact sum and sends the quantized one, in
        # the JAX package as here: with q8, only the other ranks agree
        check(same or name == "atp_q8",
              f"{name}: ranks hold different results")
        check(worst <= 1.0, f"{name}: error {worst}x its tolerance")
    emit({"phase": "collectives", "wall_s": wall, "launches": counts,
          "launches_by_rank": [r["launches"] for r in ranks]})
    for name in ("quantize", "dequantize"):
        check(all(r["launches"][name] > 0 for r in ranks),
              f"kernel {name} not launched in every rank")
    return counts


# --------------------------------------------------------------------------
# 5b. planner: the planning layers, plan to execution
# --------------------------------------------------------------------------

PLAN_SHAPE = ShapeConfig("plan_dp4", 512, 32, "train")
PLAN_MESH = MeshConfig(shape=(RING_RANKS, 1))


def plan_dp4(dp_params):
    """qwen2-0.5b's DP-4 iteration on ``dgx_cluster(1, 4)``, through the
    co-design engine's ``plan_iteration``: the mesh placed (packed), each
    comm task priced by ``select_for_task`` under FlowSim on the
    topology, the iteration scheduled by ``simulate_iteration``; returns
    the ``CodesignReport``."""
    return codesign.plan_iteration(
        get_config(ARCH), PLAN_SHAPE, PLAN_MESH, dgx_cluster(1, RING_RANKS),
        dp_params=dp_params, bucket_bytes=BUCKET_BYTES)


def _buckets(report) -> list:
    """The gradient buckets' choices of a plan."""
    return [c for c in report.choices if c.task_id.startswith("gbucket")]


def planner_rank(rank: int, world: int, seed: int) -> dict:
    """One gloo rank: one 64 MiB bucket of its stand-in gradient through
    every executable, each result held to the f64 sum of the ranks'
    buckets; the bytes it sent, the seconds and the launches of each."""
    torch.cuda.set_device(0)
    n = BUCKET
    x = _bucket_grad(seed, rank, 0, n)
    parts = [_bucket_grad(seed, r, 0, n).double() for r in range(world)]
    truth = sum(parts)
    sabs = sum(p.abs() for p in parts)
    amax = max(float(p.abs().max()) for p in parts)
    del parts
    task = CommTask("bucket", "all_reduce", BUCKET_BYTES,
                    tuple(range(world)))
    synth = synthesize_schedule(full_mesh(world), task)
    runs = {name: ccl_prim.IMPLEMENTATIONS[name]
            for name in ccl_prim.IMPLEMENTATIONS}
    runs["synthesized"] = ccl_prim.make_synthesized(synth)
    runs["synthesized_q8"] = ccl_prim.make_synthesized(synth, bits=8)
    runs["atp"] = ccl_prim.make_synthesized(atp_schedule(task))
    out = {}
    for name, fn in runs.items():
        dist.barrier()
        torch.cuda.synchronize()
        ex = ccl_prim._permute
        sent0 = ex.sent_bytes
        before = launch_counts()
        t0 = time.perf_counter()
        got = fn(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _delta(before)
        err = (got.double() - truth).abs()
        if name in ("ring_q8", "ring_q4"):
            # p * absmax / qmax, tests/test_ccl_primitives.py:100-103
            qmax = 127 if name == "ring_q8" else 7
            ratio = float(err.max()) / (world * amax / qmax)
        elif name == "synthesized_q8":  # tests/test_synth.py:_LOWERING
            ratio = float(err.max()) / (
                2 * world * float(truth.abs().max()) / 127)
        else:  # rounding of a sum in any order: eps(f32) x sum of |x|
            ratio = float((err / (1e-6 * sabs)).max())
        out[name] = {"seconds": seconds, "sent_bytes": ex.sent_bytes - sent0,
                     "err_over_tol": ratio, "launches": launches,
                     "device": str(got.device)}
        del got, err
    return {"results": out, "synth": synth}


def phase_planner(seed: int) -> dict:
    """Plan on the host with the port's planning layers, then run the
    executables the plan chooses among on the card (see the module doc,
    5b).  Returns the launches of the card run, summed over the ranks."""
    t0 = time.perf_counter()
    plans = {"zero1": plan_dp4(None),
             "plain_dp": plan_dp4(DemandParams(zero1=False))}
    topo = dgx_cluster(1, RING_RANKS)
    for label, plan in plans.items():
        buckets = _buckets(plan)
        trace = plan.to_trace(topo=topo)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as tmp:
            path = trace.write(os.path.join(tmp, f"{label}.trace.json"))
            with open(path) as f:
                doc = json.load(f)
        problems = validate_chrome(doc)
        check(not problems, f"planner {label}: trace invalid: {problems}")
        counters = sum(1 for e in doc["traceEvents"] if e["ph"] == "C")
        emit({"phase": "planner_plan", "plan": label, "arch": ARCH,
              "shape": dataclasses.asdict(PLAN_SHAPE),
              "mesh": list(PLAN_MESH.shape), "topology": "dgx_cluster(1, 4)",
              "networkx": networkx.__version__,
              "engine": "codesign.plan_iteration",
              "placement": list(plan.placement.devices),
              "predicted_iteration_s": plan.jct,
              "compute_s": plan.compute_time, "comm_s": plan.comm_time,
              "exposed_comm_s": plan.exposed_comm,
              "buckets": [(c.task_id, c.primitive, c.size_bytes,
                           c.algorithm, c.cost_s) for c in buckets],
              "trace_events": len(doc["traceEvents"]),
              "link_counter_events": counters, "trace_problems": problems})
        check(buckets and counters > 0,
              f"planner {label}: no gradient bucket or no link counters")
    plan_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    ranks = spawn_ranks(planner_rank, RING_RANKS, seed, backend="gloo",
                        timeout_s=600)
    run_s = time.perf_counter() - t1
    task = CommTask("bucket", "all_reduce", BUCKET_BYTES,
                    tuple(range(RING_RANKS)))
    model = AlphaBeta(CostParams())
    synth = ranks[0]["synth"]
    counts = {k: 0 for k in WRAPPERS}
    for name in ranks[0]["results"]:
        per = [r["results"][name] for r in ranks]
        # the model's algorithm for the executable; a schedule is priced
        # by its own flows (``cost_flowset``)
        if name in ccl_prim.MODEL_EQUIVALENTS:
            algo = ccl_prim.MODEL_EQUIVALENTS[name]
            flows = generate_flows(task, algo).flows
            predicted = model.cost(task, algo)
        else:
            sched = synth if name.startswith("synthesized") else \
                atp_schedule(task)
            algo = "synthesized+q8" if name == "synthesized_q8" else \
                sched.algorithm
            fs = sched.to_flowset(
                wire_ratio=codec_spec("q8").wire_ratio
                if name == "synthesized_q8" else 1.0, algorithm=algo)
            flows = fs.flows
            predicted = model.cost_flowset(task, fs, algorithm=algo)
        out_of = [[f for f in flows if f.src == r] for r in range(RING_RANKS)]
        model_bytes = [sum(f.size_bytes for f in fl) for fl in out_of]
        hops = [len(fl) for fl in out_of]
        sent = [p["sent_bytes"] for p in per]
        want, gap = planner_wire_bytes(name, model_bytes, hops)
        worst = max(p["err_over_tol"] for p in per)
        for p in per:
            for k, v in p["launches"].items():
                counts[k] = counts.get(k, 0) + v
        emit({"phase": "planner_run", "impl": name, "model_as": algo,
              "ranks": RING_RANKS, "tensors": per[0]["device"],
              "bucket_bytes": BUCKET_BYTES,
              "measured_s": max(p["seconds"] for p in per),
              "predicted_s": predicted,
              "sent_bytes_by_rank": sent, "model_bytes_by_rank": model_bytes,
              "bytes_equal_model": sent == model_bytes, "gap": gap,
              "worst_err_over_tol": worst,
              "launches": {k: sum(p["launches"].get(k, 0) for p in per)
                           for k in ("quantize", "dequantize")}})
        check(per[0]["device"].startswith("cuda"),
              f"planner {name}: result on {per[0]['device']}")
        check(worst <= 1.0, f"planner {name}: error {worst}x its tolerance")
        check(sent == want, f"planner {name}: sent {sent} bytes a rank, "
                            f"expected {want} ({gap or 'the model'})")
        if name in ("ring_q8", "ring_q4", "synthesized_q8"):
            check(all(p["launches"].get("quantize", 0) > 0
                      and p["launches"].get("dequantize", 0) > 0
                      for p in per),
                  f"planner {name}: K2a/K2b not launched on every rank")
    wall = time.perf_counter() - t0
    emit({"phase": "planner", "plan_s": plan_s, "run_s": run_s,
          "wall_s": wall, "launches": counts})
    return counts


def planner_wire_bytes(name: str, model_bytes, hops, n=None):
    """The bytes each rank must send for executable ``name`` on a payload
    of ``n`` bytes a rank, and where they differ from the model's flows,
    the source of the gap.  Ring, bidir
    ring and the schedules send exactly the model's bytes.  A quantized
    hop also sends its f32 scale, which the codec's wire ratio leaves out:
    4 bytes a hop.  ``recursive_doubling`` exchanges the whole payload at
    each of its log2(p) steps, where the ``halving_doubling`` it is priced
    as halves it: log2(p) x n against 2n(p-1)/p.  ``n`` defaults to the
    planner's bucket."""
    n = BUCKET_BYTES if n is None else n
    if name in ("ring_q8", "ring_q4", "synthesized_q8"):
        return ([m + 4 * h for m, h in zip(model_bytes, hops)],
                "one f32 scale a hop beside the codes (codec_spec's wire "
                "ratio counts the codes only)")
    if name == "recursive_doubling":
        steps = int(math.log2(RING_RANKS))
        return ([steps * n] * RING_RANKS,
                "recursive doubling sends n at each of log2(p) steps; "
                "halving_doubling's flows halve the payload each step")
    return list(model_bytes), None


# --------------------------------------------------------------------------
# 5c. codesign: the co-design engine on the host, the probe on the card
# --------------------------------------------------------------------------

CODESIGN_SIZES = (BUCKET_BYTES, 2 ** 20)   # the plan's bucket, and 1 MiB
CODESIGN_BUDGET = 8                        # search's plan evaluations
CODESIGN_HOST_S = 30.0                     # the host part's budget


def _link(link) -> str:
    return "->".join(map(str, link))


def _trace_check(label: str, trace) -> int:
    """``validate_chrome`` must pass ``trace``; returns its events."""
    doc = trace.to_chrome()
    problems = validate_chrome(doc)
    check(not problems, f"codesign {label}: trace invalid: {problems}")
    return len(doc["traceEvents"])


def codesign_search():
    """``search`` over qwen2-0.5b's DP-4 plain-DP iteration (64 MiB
    buckets) on ``dgx_cluster(1, 4)``: placement and the all-reduces'
    error budget (0, or 0.01, which admits ``ring+q8``) free."""
    topo = dgx_cluster(1, RING_RANKS)
    problem = codesign.CodesignProblem(
        get_config(ARCH), PLAN_SHAPE, PLAN_MESH, topo,
        dp_params=DemandParams(zero1=False),
        space=codesign.PlanSpace(
            placement=codesign.Search(),
            error_budget=codesign.Choice(0.0, {"all_reduce": 0.01}),
            bucket_bytes=codesign.Fixed(BUCKET_BYTES)))
    return codesign.search(problem, budget=CODESIGN_BUDGET), topo


def codesign_cluster():
    """Two DP-4 tenants of qwen2-0.5b on ``dgx_cluster(2, 4)``, each on two
    cards of each host, so that their gradient bursts share the hosts'
    uplinks: ``plan_cluster``'s naive and staggered plans."""
    topo = dgx_cluster(2, RING_RANKS)
    mesh = MeshConfig(shape=(RING_RANKS,), axis_names=("data",),
                      data_axes=("data",), model_axes=())
    half = RING_RANKS // 2
    jobs = [codesign.JobSpec(
        name, get_config(ARCH), PLAN_SHAPE, mesh, policy="serial",
        devices=topo.hosts[0][k:k + half] + topo.hosts[1][k:k + half],
        dp_params=DemandParams(zero1=False))
        for name, k in (("tenantA", 0), ("tenantB", half))]
    return codesign.plan_cluster(jobs, topo, grid=6), topo


def codesign_serving():
    """qwen2-0.5b served disaggregated (2 prefill, 2 decode cards) on a
    16-card fat-tree, under the spec of the JAX package's serving tests
    (``tests/test_serving.py::_spec``: Poisson 25 requests/s of 128 prompt
    and 8 decode tokens, seed 3, SLO 0.5 s TTFT / 0.05 s TPOT, 1 s)."""
    topo = fat_tree(16)
    spec = codesign.ServingSpec(
        name="svc", cfg=get_config(ARCH), prefill_devices=2,
        decode_devices=2,
        arrivals=PoissonArrivals(rate_rps=25.0, prompt_tokens=128,
                                 decode_tokens=8, seed=3),
        slo=codesign.ServingSLO(ttft_s=0.5, tpot_s=0.05), horizon_s=1.0)
    return codesign.plan(codesign.serving_problem(spec, topo)), topo


def codesign_dynamics():
    """``ClusterDynamics`` over two DP-2 tenants of qwen2-0.5b on a
    4-host fat-tree with two uplinks a rack, through a three-event trace:
    a third tenant arrives, an uplink of rack 0 fails, the tenant
    departs; each incremental answer priced against a full re-search."""
    topo = fat_tree(num_hosts=4, gpus_per_host=2, hosts_per_rack=1,
                    racks_per_pod=1, agg_redundancy=2, nic_bw=2e9,
                    agg_bw=8e9, oversub=4.0, pcie_bw=4e9)
    mesh = MeshConfig(shape=(2,), axis_names=("data",), data_axes=("data",),
                      model_axes=())

    def job(name, devices):
        return codesign.JobSpec(name, get_config(ARCH), PLAN_SHAPE, mesh,
                                policy="serial", devices=devices,
                                dp_params=DemandParams(zero1=False))

    dyn = codesign.ClusterDynamics([job("a", (0, 4)), job("b", (2, 6))],
                                   topo, grid=4, compare_full=True)
    events = [codesign.Event("job_arrive", time=1.0, job=job("c", (1, 5))),
              codesign.Event("link_fail", time=2.0, link=("tor0", "agg0.0")),
              codesign.Event("job_depart", time=3.0, name="c")]
    return dyn.run(events), topo


def codesign_host() -> dict:
    """The engine on the host (``CODESIGN_HOST_S`` of budget): search,
    cluster, serving and dynamics, one line each, every trace validated.
    Returns what the card part compares with: the executable the search
    chose for the buckets and the plan's price of one bucket."""
    t0 = time.perf_counter()
    res, topo = codesign_search()
    best = res.best
    buckets = _buckets(best)
    algos = sorted({c.algorithm for c in buckets})
    executable = {v: k for k, v in ccl_prim.MODEL_EQUIVALENTS.items()}
    emit({"phase": "codesign_search", "arch": ARCH,
          "shape": dataclasses.asdict(PLAN_SHAPE),
          "mesh": list(PLAN_MESH.shape), "topology": "dgx_cluster(1, 4)",
          "budget": CODESIGN_BUDGET, "evaluated": res.evaluated,
          "truncated": res.truncated, "best_jct_s": best.jct,
          "best_placement": {"strategy": best.placement.strategy,
                             "devices": list(best.placement.devices)},
          "best_error_budget": best.error_budget,
          "attribution_s": res.attribution,
          "codecs": best.codecs_by_primitive(),
          "algorithms": best.algorithms_by_primitive(),
          "bucket_algorithms": algos, "telemetry": res.telemetry,
          "trace_events": _trace_check("search", trace_from_search(
              res, topo=topo))})
    plain = plan_dp4(DemandParams(zero1=False))
    check(best.jct <= plain.jct + 1e-12,
          f"codesign search: best {best.jct} s worse than the planner's "
          f"plain DP {plain.jct} s, a point of its space")
    check(len(algos) == 1 and algos[0] in executable,
          f"codesign search: buckets priced as {algos}, not one executable")

    crep, ctopo = codesign_cluster()
    emit({"phase": "codesign_cluster", "topology": "dgx_cluster(2, 4)",
          "tenants": {jp.spec.name: list(jp.devices) for jp in crep.jobs},
          "solo_jct_s": crep.solo_jct, "naive_jct_s": crep.naive_jct,
          "staggered_jct_s": crep.staggered_jct, "phases_s": crep.phases,
          "naive_worst_stretch": crep.naive_worst_stretch,
          "staggered_worst_stretch": crep.staggered_worst_stretch,
          "stagger_speedup": crep.stagger_speedup,
          "contended_links": {_link(k): v for k, v in crep.contended.items()},
          "trace_events": _trace_check("cluster", trace_from_cluster(
              crep, topo=ctopo))})
    check(crep.contended and crep.staggered_worst_stretch
          <= crep.naive_worst_stretch + 1e-12,
          "codesign cluster: no shared link, or staggering made it worse")

    srep, stopo = codesign_serving()
    emit({"phase": "codesign_serving", "arch": ARCH,
          "topology": "fat_tree(16)", "requests": len(srep.requests),
          "offered_rps": srep.offered_rps,
          "ttft_s": {"p50": srep.ttft_p50, "p95": srep.ttft_p95,
                     "p99": srep.ttft_p99},
          "tpot_s": {"p50": srep.tpot_p50, "p99": srep.tpot_p99},
          "goodput_rps": srep.goodput, "slo_attainment": srep.slo_attainment,
          "kv_bytes_per_request": srep.kv_bytes_per_request,
          "trace_events": _trace_check("serving", trace_from_serving(
              srep, topo=stopo))})
    check(srep.requests and 0 < srep.goodput <= srep.offered_rps + 1e-9,
          "codesign serving: no request served or goodput out of range")

    drep, dtopo = codesign_dynamics()
    emit({"phase": "codesign_dynamics",
          "events": [{"kind": r.kind, "target": r.target, "mode": r.mode,
                      "dirty_jobs": r.dirty_jobs,
                      "dirty_links": [_link(k) for k in r.dirty_links],
                      "regret": r.regret, "replan_s": r.replan_s,
                      "full_replan_s": r.full_replan_s,
                      "worst_stretch": r.worst_stretch}
                     for r in drep.records],
          "final_jct_s": drep.final.staggered_jct,
          "worst_regret": drep.worst_regret,
          "incremental_speedup": drep.incremental_speedup,
          "trace_events": _trace_check("dynamics", trace_from_dynamics(
              drep, topo=dtopo))})
    check([r.kind for r in drep.records]
          == ["job_arrive", "link_fail", "job_depart"]
          and all(r.regret is not None and math.isfinite(r.regret)
                  for r in drep.records),
          "codesign dynamics: an event was not applied or has no regret")
    host_s = time.perf_counter() - t0
    check(host_s < CODESIGN_HOST_S,
          f"codesign: the host part took {host_s:.1f} s")
    return {"executable": executable[algos[0]], "algorithm": algos[0],
            "bucket_model_s": buckets[0].cost_s, "host_s": host_s}


def codesign_rank(rank: int, world: int, sizes, device: str) -> dict:
    """One gloo rank: ``obs.probe.probe_suite`` over every executable of
    ``MODEL_EQUIVALENTS`` at ``sizes`` (warmup 1, repeats 3) on this
    rank's slice of the probe buffer on ``device``; the probes, each
    probe's check and the launches."""
    dev = rank_device(device)
    reset_launch_counts()
    probes = obs_probe.probe_suite(tuple(ccl_prim.MODEL_EQUIVALENTS), sizes,
                                   device=dev, warmup=1, repeats=3)
    return {"probes": [p.to_dict() for p in probes],
            "checks": list(obs_probe.probe_suite.checks),
            "launches": launch_counts()}


def phase_codesign(seed: int) -> dict:
    """The co-design engine on the host (``codesign_host``), then
    ``obs.probe`` timing every executable all-reduce on the card: 4 gloo
    ranks, each reducing its quarter of the probe buffer (the JAX
    package's operand, ROADMAP R6) of 64 MiB and 1 MiB.  Each probe's
    result against the f64 sum, its wire bytes a rank against the model's
    flows of the operand, its seconds beside ``algo_cost``'s for the whole
    size; ``model_vs_measured``'s summary and the probes' trace.  Returns
    the launches, summed over the ranks."""
    del seed  # the probe's buffer is deterministic
    t0 = time.perf_counter()
    host = codesign_host()
    t1 = time.perf_counter()
    ranks = spawn_ranks(codesign_rank, RING_RANKS, CODESIGN_SIZES, DEVICE,
                        backend="gloo", timeout_s=600)
    probe_s = time.perf_counter() - t1
    head = ranks[0]["probes"]
    check(all(r["probes"] == head for r in ranks),
          "codesign probe: the ranks returned different probes")
    probes = [obs_probe.CollectiveProbe.from_dict(d) for d in head]
    group = tuple(range(RING_RANKS))
    measured = {}
    for i, pr in enumerate(probes):
        checks = [r["checks"][i] for r in ranks]
        operand = checks[0]["operand_bytes"]
        flows = generate_flows(CommTask("probe", "all_reduce", operand,
                                        group), pr.algorithm).flows
        out_of = [[f for f in flows if f.src == r] for r in group]
        model_bytes = [sum(f.size_bytes for f in fl) for fl in out_of]
        want, gap = planner_wire_bytes(pr.impl, model_bytes,
                                       [len(fl) for fl in out_of], operand)
        sent = [c["sent_bytes"] for c in checks]
        worst = max(c["err_over_tol"] for c in checks)
        emit({"phase": "codesign_probe", "impl": pr.impl,
              "model_as": pr.algorithm, "ranks": RING_RANKS,
              "size_bytes": pr.size_bytes, "operand_bytes_per_rank": operand,
              "measured_s": pr.measured_s, "runs_s": pr.runs_s,
              "modeled_s": pr.modeled_s, "ratio": pr.ratio,
              "model_terms": pr.model_terms,
              "sent_bytes_by_rank": sent, "model_bytes_by_rank": model_bytes,
              "gap": gap, "max_abs_err": max(c["max_abs_err"]
                                             for c in checks),
              "worst_err_over_tol": worst, "device_kind": pr.device_kind,
              "tensors": checks[0]["device"]})
        check(all(c["device"].startswith("cuda") for c in checks),
              f"codesign probe {pr.impl}: result on {checks[0]['device']}")
        check(worst <= 1.0, f"codesign probe {pr.impl} {pr.size_bytes}: "
                            f"error {worst}x its tolerance")
        check(operand * RING_RANKS == pr.size_bytes,
              f"codesign probe {pr.impl}: operand {operand} B a rank")
        check(sent == want, f"codesign probe {pr.impl} {pr.size_bytes}: sent "
                            f"{sent} bytes a rank, expected {want} "
                            f"({gap or 'the model'})")
        measured[(pr.impl, pr.size_bytes)] = pr
    counts: dict = {}
    for r in ranks:
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    check(all(r["launches"].get("quantize", 0) > 0
              and r["launches"].get("dequantize", 0) > 0 for r in ranks),
          "codesign probe: K2a/K2b not launched on every rank")
    mm = obs_probe.model_vs_measured(probes)
    chosen = measured[(host["executable"], BUCKET_BYTES)]
    emit({"phase": "codesign_probe_summary", "count": mm["count"],
          **{k: mm[k] for k in ("geomean_ratio", "mean_abs_log2_err",
                                "min_ratio", "max_ratio")},
          "model": "ccl.cost.algo_cost, CostParams() (50 GB/s links), "
                   "priced at size_bytes",
          "search_bucket_algorithm": host["algorithm"],
          "search_executable": host["executable"],
          "search_bucket_model_s": host["bucket_model_s"],
          "executable_measured_s": chosen.measured_s,
          "executable_modeled_s": chosen.modeled_s,
          "trace_events": _trace_check("probe", obs_probe.probes_to_trace(
              probes)),
          "launches": {k: counts.get(k, 0)
                       for k in ("quantize", "dequantize")}})
    emit({"phase": "codesign", "host_s": host["host_s"], "probe_s": probe_s,
          "wall_s": time.perf_counter() - t0, "launches": counts})
    return counts


# --------------------------------------------------------------------------
# 3. full-width parity in f32: prefill (kernels) vs decode replay
# --------------------------------------------------------------------------

def open_gates(params) -> None:
    """Every cross-attention gate of ``params`` set to GATE, in place: at
    init tanh(0) = 0 leaves the context (and the encoder) off the path."""
    if isinstance(params, dict):
        if "gate_attn" in params:
            params["gate_attn"].fill_(GATE)
        for v in params.values():
            open_gates(v)
    elif isinstance(params, list):
        for v in params:
            open_gates(v)


def stub_frames(cfg, params, batch: int, seed: int):
    """The stub frontend's frame or patch embeddings of a config that
    takes a context, on the card in the parameters' dtype (made on the
    host: not the port's work, and not timed); None for the others."""
    if cfg.is_encoder_decoder:
        frames = audio_frames(cfg, batch, seed)
    elif cfg.cross_attn_period:
        frames = vision_patches(cfg, batch, seed)
    else:
        return None
    return torch.from_numpy(frames).to(DEVICE, params["embed"].dtype)


def context_of(cfg, params, frames):
    """What the caller passes as the context: the frames encoded (the
    encoder's kernels) for the encoder-decoder, the patches as they are
    for cross-attention."""
    return encode(cfg, params, frames) if cfg.is_encoder_decoder \
        else frames


def context_launches(cfg, seq: int) -> dict:
    """The launches of ``context_of`` and one prefill of ``seq``
    tokens."""
    want = dict(prefill_launches(cfg, seq))
    want["flash_attention"] += encode_launches(cfg)["flash_attention"]
    return {k: n for k, n in want.items() if n}


def phase_parity(rng, cfg, b: int, s: int, seed: int):
    """Prefill logits through the kernels vs the prompt replayed through
    decode_step (which launches no K1 and no K6; K5 runs in decode too), at
    every position, and the greedy next token.  A config with a context
    takes the stub's (encoded on the card for the encoder-decoder), its
    gates opened, and prefill with the context zeroed must move the
    logits beyond PARITY_TOL."""
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    open_gates(params)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).to(DEVICE)

    frames = stub_frames(cfg, params, b, seed)
    n0 = launch_counts()
    context = context_of(cfg, params, frames)
    logits = make_prefill(cfg)(params, tokens, context)
    torch.cuda.synchronize()
    launched = _delta(n0)
    want = context_launches(cfg, s)
    check(launched == want, f"prefill launched {launched}, want {want}")
    context_moves = None
    if context is not None:
        zeroed = make_prefill(cfg)(params, tokens, torch.zeros_like(context))
        v = cfg.vocab_size
        moved = (zeroed[..., :v] - logits[..., :v]).abs()
        context_moves = float(moved.max())
        check(bool((moved > PARITY_TOL["atol"] + PARITY_TOL["rtol"]
                    * logits[..., :v].abs()).any()),
              f"{cfg.name}: a zeroed context moves no logit beyond "
              f"{PARITY_TOL} (max {context_moves}): it is off the path")
        del zeroed, moved

    cache = init_cache(cfg, params, b, s, context=context)
    serve = make_serve_step(cfg)
    n0 = launch_counts()
    max_err = torch.zeros((), device=DEVICE)
    excess = torch.zeros((), device=DEVICE)
    tok = None
    for t in range(s):
        tok, step_logits, cache = serve(params, cache, tokens[:, t:t + 1], t)
        v = cfg.vocab_size  # the padded ids hold NEG_INF in both
        d, ref = step_logits[:, 0, :v], logits[:, t, :v]
        err = (d - ref).abs()
        max_err = torch.maximum(max_err, err.max())
        excess = torch.maximum(excess, (err - PARITY_TOL["atol"]
                                        - PARITY_TOL["rtol"] * d.abs()).max())
    torch.cuda.synchronize()
    decode_launched = _delta(n0)
    want = {"moe_gmm": prefill_launches(cfg)["moe_gmm"] * s} \
        if prefill_launches(cfg)["moe_gmm"] else {}
    check(decode_launched == want,
          f"decode replay launched {decode_launched}, want {want}")
    greedy_prefill = logits[:, -1].argmax(-1)
    top2 = logits[:, -1].topk(2, dim=-1).values
    result = {"phase": "parity", "arch": cfg.name, "dtype": "float32",
              "layers": cfg.num_layers, "batch": b, "seq": s,
              "context": None if context is None else list(context.shape),
              "kernel_launches": launched,
              "decode_kernel_launches": decode_launched,
              "max_abs_err": float(max_err), "tol": PARITY_TOL,
              "logit_max_abs": float(logits[:, :, :cfg.vocab_size].abs()
                                     .max()),
              "zeroed_context_max_move": context_moves,
              "greedy_prefill": greedy_prefill.tolist(),
              "greedy_decode": tok[:, 0].tolist(),
              "top2_gap": (top2[:, 0] - top2[:, 1]).tolist(),
              "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(result)
    check(float(excess) <= 0,
          f"{cfg.name}: prefill and decode replay disagree beyond "
          f"{PARITY_TOL}: max |err| {float(max_err)}")
    check(torch.equal(greedy_prefill, tok[:, 0]),
          f"{cfg.name}: greedy token after the prompt differs between "
          f"prefill and decode replay")


# --------------------------------------------------------------------------
# 4. serving through the entry points (each model's main path)
# --------------------------------------------------------------------------

def phase_serving(rng, cfg, *, prefill_batch: int, prefill_lens,
                  prompt_lens, new_tokens: int, max_len: int,
                  seed: int) -> dict:
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=DEVICE)
    open_gates(params)
    n_params = sum(t.numel() for t in param_leaves(params))
    prefill = make_prefill(cfg)
    prompts = {s: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (prefill_batch, s))).to(DEVICE)
        for s in prefill_lens}
    requests = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
                for n in rng.integers(prompt_lens[0], prompt_lens[1] + 1, 6)]
    torch.cuda.synchronize()

    # the caller encodes (or passes the patches), then prefills; the
    # batcher's context has its max_slots rows
    reset_launch_counts()
    prefill_ms, prefill_launched = {}, {}
    for s, tokens in prompts.items():
        frames = stub_frames(cfg, params, prefill_batch, seed)
        torch.cuda.synchronize()
        n0 = launch_counts()
        t0 = time.perf_counter()
        context = context_of(cfg, params, frames)
        logits = prefill(params, tokens, context)
        torch.cuda.synchronize()
        prefill_ms[s] = 1e3 * (time.perf_counter() - t0)
        prefill_launched[s] = _delta(n0)
        want = context_launches(cfg, s)
        check(prefill_launched[s] == want,
              f"{cfg.name} prefill of S={s} launched {prefill_launched[s]}, "
              f"want {want}")
        check(tuple(logits.shape) == (prefill_batch, s, cfg.padded_vocab),
              f"prefill logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits[..., :cfg.vocab_size].float())
                   .all()), f"non-finite prefill logits at S={s}")
        check(int(logits.argmax(-1).max()) < cfg.vocab_size,
              "prefill argmax picked a padded vocabulary id")
        del logits, context, frames
    batcher = ContinuousBatcher(
        cfg, params, max_slots=4, max_len=max_len,
        context=context_of(cfg, params, stub_frames(cfg, params, 4, seed)),
        cache_dtype=torch.bfloat16)
    for rid, prompt in enumerate(requests):
        batcher.submit(prompt, new_tokens, rid)
    step_ms = []
    t_run = time.perf_counter()
    while batcher.active:
        t0 = time.perf_counter()
        batcher.step()  # ends in a host copy of the next tokens: synced
        step_ms.append(1e3 * (time.perf_counter() - t0))
    run_s = time.perf_counter() - t_run
    counts = launch_counts()

    done = {r.rid: r for r in batcher.completed}
    check(sorted(done) == list(range(len(requests))),
          f"requests completed: {sorted(done)}")
    for r in done.values():
        check(len(r.out) == new_tokens,
              f"request {r.rid} emitted {len(r.out)}")
        check(max(r.out) < cfg.vocab_size,
              f"request {r.rid} emitted a padded id")
    check(any(r.t_admit > 0 for r in done.values()),
          "no request was admitted mid-flight")
    for name, n in prefill_launches(cfg).items():
        check(n == 0 or counts[name] > 0,
              f"kernel {name} was not launched on the {cfg.name} path")
    generated = sum(len(r.out) for r in done.values())
    ingested = sum(len(p) for p in requests)
    emit({"phase": "serving", "arch": cfg.name, "dtype": "bfloat16",
          "params": n_params, "layers": cfg.num_layers,
          "prefill_batch": prefill_batch, "prefill_ms": prefill_ms,
          "prefill_launches": prefill_launched,
          "slots": 4, "requests": len(requests),
          "new_tokens_each": new_tokens, "prompt_tokens": ingested,
          "steps": len(step_ms), "run_s": run_s,
          "generated_tokens_per_s": generated / run_s,
          "step_ms_p50": float(np.percentile(step_ms, 50)),
          "step_ms_p99": float(np.percentile(step_ms, 99)),
          "admitted_at": {r.rid: r.t_admit for r in done.values()},
          "launches": counts,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts


# --------------------------------------------------------------------------
# 4b. training (qwen2-0.5b, full width and depth)
# --------------------------------------------------------------------------

TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 256
TRAIN_STEPS = 10  # the loss falls below 0.9 of its start within 4
# overfitting one fixed batch in 20 steps: warmup over the first 5
TRAIN_TCFG = dict(learning_rate=1e-3, warmup_steps=5, total_steps=20,
                  microbatches=TRAIN_MICROBATCHES, remat=True,
                  grad_dtype="bf16")


def phase_train_parity(cfg, seed: int, name: str = "train_parity",
                       strict: bool = False) -> None:
    """One f32 step (microbatches 1, no remat) through the kernels on the
    card against the same step through the port's plain path on the host
    CPU (which the CPU tests hold to the JAX package), from the same
    params, batch and optimizer state: loss and grad_norm within rtol
    1e-4, each leaf's first moment m (0.1 x the clipped gradient after
    step 1) within 1e-3 of the leaf's max |m|.  ``strict`` (mamba2-130m,
    whose step runs K6 and K6-bwd): loss and grad_norm within rtol 1e-5,
    the parameters and m within the f32 kernel tolerance, elementwise."""
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    host = tree_map(lambda t: t.to("cpu", copy=True), params)
    batch = next(make_batches(cfg, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ,
                              seed=seed))
    step = make_train_step(cfg, TrainConfig(microbatches=1, remat=False))
    n0 = launch_counts()
    t0 = time.perf_counter()
    params, opt, m = step(params, init_opt_state(params), batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched = _delta(n0)
    want = train_launches(cfg, 1, False)
    check(launched == want, f"f32 training step launched {launched}, want "
                            f"{want}")
    t0 = time.perf_counter()
    host, host_opt, host_m = step(host, init_opt_state(host), batch)
    host_s = time.perf_counter() - t0
    rel = {k: abs(float(m[k]) - float(host_m[k])) / abs(float(host_m[k]))
           for k in ("loss", "grad_norm")}
    moments = list(param_leaves(host_opt["m"]))
    m_err = max(float((a.cpu() - b).abs().max()) /
                max(float(b.abs().max()), 1e-30)
                for a, b in zip(param_leaves(opt["m"]), moments))
    # why optim.global_norm sums in f64: PyTorch's f32 norm on this host's
    # CPU against the f64 one, over the host step's first moments
    f32 = [float(torch.linalg.vector_norm(t)) for t in moments]
    f64 = [float(torch.linalg.vector_norm(t, dtype=torch.float64))
           for t in moments]
    norm_drift = {
        "leaf_max_rel": max(abs(a - b) / b for a, b in zip(f32, f64) if b),
        "global_rel": abs(math.hypot(*f32) - math.hypot(*f64))
        / math.hypot(*f64)}
    leaf_tol = None
    if strict:  # the worst leaf's share of its KERNEL_TOL allowance
        tol = KERNEL_TOL[torch.float32]
        leaf_tol = max(
            float(((a.cpu() - b).abs() / (tol["atol"] + tol["rtol"]
                                          * b.abs())).max())
            for tree, host_tree in ((params, host), (opt["m"], host_opt["m"]))
            for a, b in zip(param_leaves(tree), param_leaves(host_tree)))
    emit({"phase": name, "arch": cfg.name, "dtype": "float32",
          "layers": cfg.num_layers, "batch": TRAIN_PARITY_BATCH,
          "seq": TRAIN_PARITY_SEQ, "microbatches": 1, "remat": False,
          "loss": float(m["loss"]), "host_loss": float(host_m["loss"]),
          "grad_norm": float(m["grad_norm"]),
          "host_grad_norm": float(host_m["grad_norm"]), "rel_err": rel,
          "m_max_err_over_leaf_max": m_err,
          "host_cpu_f32_norm_drift": norm_drift, "kernel_launches": launched,
          "card_step_s": card_s, "host_step_s": host_s,
          "params_and_m_err_over_tol": leaf_tol,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    rtol = 1e-5 if strict else 1e-4
    check(rel["loss"] <= rtol and rel["grad_norm"] <= rtol,
          f"f32 step: card and host disagree beyond rtol {rtol}: {rel}")
    check(m_err <= 1e-3, f"f32 step: first moments disagree: {m_err} of "
                         f"a leaf's max")
    check(leaf_tol is None or leaf_tol <= 1.0,
          f"f32 step: parameters or first moments beyond "
          f"{KERNEL_TOL[torch.float32]}: {leaf_tol} of the allowance")


def _profile_step(step, params, opt, batch) -> dict:
    """One step under torch.profiler: device busy ms (the kernels' summed
    device time), the profiled wall ms and the idle share, and the top
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    check(busy_ms > 0, "the profiler recorded no device time")
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:10]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(a.count for a in kernels),
            "top_kernels": [{"name": a.key[:90], "calls": a.count,
                             "ms": a.self_device_time_total / 1e3}
                            for a in top]}


def phase_training(cfg, seed: int, name: str = "training",
                   batch_size: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                   tcfg: dict = TRAIN_TCFG) -> dict:
    """bf16 training through the entry points: make_batches, init_params,
    init_opt_state, make_train_step (by default microbatches 2, remat,
    bf16 gradient cast), 20 steps on one fixed batch (B 8 x S 512 by
    default; overfitting it): every loss finite and the last <= 0.9 x the
    first; step wall time (CUDA events), tokens/s, peak memory; the
    launches of the first step against ``train_launches``; then one more
    step under torch.profiler.  Returns the launch counts of the 20 steps
    (set to 0 just before)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=DEVICE)
    opt = init_opt_state(params)
    batch = next(make_batches(cfg, batch_size, seq, seed=seed))
    tcfg = TrainConfig(**tcfg)
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()

    reset_launch_counts()
    losses, lrs, events = [], [], []
    first_step = None
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        events.append((start, end))
        losses.append(m["loss"])
        lrs.append(m["lr"])
        if i == 0:
            first_step = {k: n for k, n in launch_counts().items() if n}
    torch.cuda.synchronize()
    counts = launch_counts()
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(x) for x in losses]
    want = train_launches(cfg, tcfg.microbatches, tcfg.remat)
    profiled = _profile_step(step, params, opt, batch)
    p50 = float(np.percentile(step_ms, 50))
    emit({"phase": name, "arch": cfg.name, "dtype": "bfloat16",
          "params": sum(t.numel() for t in param_leaves(params)),
          "layers": cfg.num_layers, "batch": batch_size, "seq": seq,
          "microbatches": tcfg.microbatches, "remat": tcfg.remat,
          "grad_dtype": tcfg.grad_dtype, "learning_rate": tcfg.learning_rate,
          "warmup_steps": tcfg.warmup_steps,
          "total_steps": tcfg.total_steps, "lr": [float(x) for x in lrs],
          "steps": TRAIN_STEPS, "losses": losses,
          "step_ms": step_ms, "step_ms_p50": p50,
          "step_ms_p99": float(np.percentile(step_ms, 99)),
          "tokens_per_s": batch_size * seq / (p50 / 1e3),
          "first_step_launches": first_step, "want_launches": want,
          "launches": counts,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          **profiled, "seconds": time.perf_counter() - t_phase})
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] <= 0.9 * losses[0],
          f"training did not fit its batch: loss {losses[0]} -> "
          f"{losses[-1]}")
    check(first_step == want, f"a training step launched {first_step}, "
                              f"want {want}")
    return counts


def run_training(seed: int) -> dict:
    """The training path of qwen2-0.5b at full width and depth: f32 parity
    with the host, then bf16 training; returns the launch counts of the
    bf16 steps."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    phase_train_parity(cfg, seed)
    _release()
    counts = phase_training(cfg, seed + 1)
    _release()
    emit({"phase": "training_total", "seconds": time.perf_counter() - t0})
    return counts


# the dbrx-132b training path: full width, 1 layer (AdamW's 12 B a parameter
# of 4.49 B parameters is 54 GB; two layers, 93 GB, fit no card), one
# microbatch of B 2 x S 256, no remat
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 256
MOE_TRAIN_TCFG = dict(TRAIN_TCFG, microbatches=1, remat=False)
MOE_GRAD_SEQ = 128  # moe_grad_parity: one MoE layer, B 1 x S 128, f32


def phase_moe_grad_parity(seed: int) -> None:
    """One dbrx-132b MoE layer at full width in f32 (16 experts of 6144 x
    10752), B 1 x S 128: ``moe_dense``'s gradients of x and of the three
    expert stacks through K5 and K5-bwd against the same through
    ``moe_gmm_ref`` (autograd) on the card, scaled by max(|ref|, 1) within
    the f32 kernel tolerance; the kernels' launches (K5 three times, K5-bwd
    three calls)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p = moe_mod.init_moe(cfg, torch.float32, DEVICE, gen)
    x = torch.randn((1, MOE_GRAD_SEQ, cfg.d_model), device=DEVICE,
                    generator=gen)
    dy = torch.randn(x.shape, device=DEVICE, generator=gen)
    names = ("w_gate", "w_up", "w_down")

    def grads(gmm):
        leaves = [x.clone().requires_grad_(True)] + \
            [p[k].detach().requires_grad_(True) for k in names]
        q = {**p, **dict(zip(names, leaves[1:]))}
        y, aux = moe_mod.moe_dense(q, cfg, leaves[0], gmm=gmm)
        return torch.autograd.grad((y * dy).sum() + aux, leaves)

    n0 = launch_counts()
    got = grads(moe_gmm)
    torch.cuda.synchronize()
    launched = _delta(n0)
    want = grads(moe_gmm_ref)
    tol = KERNEL_TOL[torch.float32]
    errs = {}
    for k, g, w in zip(("x",) + names, got, want):
        scale = max(float(w.abs().max()), 1.0)
        err = (g - w).abs() / scale
        errs[k] = {"max_scaled_err": float(err.max()),
                   "mismatches": int((err > tol["atol"] + tol["rtol"]
                                      * w.abs() / scale).sum())}
        del err
    emit({"phase": "moe_grad_parity", "arch": cfg.name, "dtype": "float32",
          "shape": [1, MOE_GRAD_SEQ, cfg.d_model],
          "experts": cfg.num_experts, "ffn": cfg.moe_d_ff or cfg.d_ff,
          "errors": errs, "tol": {**tol, "scaled_by": "max(|ref|, 1)"},
          "kernel_launches": launched,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t0})
    check(all(e["mismatches"] == 0 for e in errs.values()),
          f"moe_dense's gradients through K5-bwd disagree with the plain "
          f"version's: {errs}")
    want_launches = {"moe_gmm": 3, "moe_gmm_bwd": 3 * GMM_BWD_LAUNCHES}
    check(launched == want_launches,
          f"moe_grad_parity launched {launched}, want {want_launches}")
    del p, x, dy, got, want


def run_family_training(seed: int) -> dict:
    """The training paths of the Mamba and MoE families, whose steps run
    K6-bwd and K5-bwd: mamba2-130m whole (f32 parity with the host, then
    bf16 training as qwen2's), dbrx-132b's MoE layer at full width (the
    gradients against the plain version's), then dbrx-132b at full width,
    1 layer, in bf16; returns each training path's launch counts."""
    t0 = time.perf_counter()
    counts = {}
    cfg = get_config(SSM_ARCH)
    phase_train_parity(cfg, seed, name="train_parity_mamba2", strict=True)
    _release()
    counts["training_mamba2"] = phase_training(cfg, seed + 1,
                                               name="training_mamba2")
    _release()
    phase_moe_grad_parity(seed + 2)
    _release()
    moe = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_TRAIN_LAYERS)
    counts["training_dbrx"] = phase_training(
        moe, seed + 3, name="training_dbrx", batch_size=MOE_TRAIN_BATCH,
        seq=MOE_TRAIN_SEQ, tcfg=MOE_TRAIN_TCFG)
    _release()
    emit({"phase": "family_training_total",
          "seconds": time.perf_counter() - t0})
    return counts


# --------------------------------------------------------------------------
# 4c. data-parallel training (qwen2-0.5b, full width and depth), 4 gloo
# ranks sharing the card
# --------------------------------------------------------------------------

DP_PARITY_BATCH, DP_PARITY_SEQ = 8, 256
DP_STEPS = 4      # the loss falls below 0.9 of its start at the 4th
DP_Q8_STEPS = 2
# the f32 parity step at lr 1e-3 from the first step: AdamW's first update
# is about lr x sign(g), a hundred times the 1e-5 bounds, so an update that
# is skipped or wrong shows (``_update_err``)
DP_PARITY_TCFG = dict(microbatches=1, remat=False, learning_rate=1e-3,
                      warmup_steps=1)
DP_Q8_TCFG = dict(TRAIN_TCFG, grad_dtype="f32", zero1=False)


def _paths(tree, prefix=""):
    """The leaves' paths, in ``param_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix


def _leaf_err(a, b, path) -> tuple:
    """(max |a - b|, max |b|, path) of one leaf."""
    return float((a - b).abs().max()), float(b.abs().max()), path


def _tree_err_of(errs) -> dict:
    """``_tree_err`` from each leaf's ``_leaf_err``."""
    err, top, path = max(errs, key=lambda e: e[0] / max(e[1], 1e-30))
    return {"err_over_max": max(e[0] for e in errs)
            / max(e[1] for e in errs),
            "worst_leaf": path, "worst_leaf_err": err, "worst_leaf_max": top}


def _tree_err(got, want) -> dict:
    """The largest |got - want| over the tree's largest |want|, and the
    leaf with the largest error over its own max (for the record: the
    smallest leaves, the projections' biases, sum their gradient over every
    token of the batch, so their rounding is largest against their own
    max)."""
    return _tree_err_of([_leaf_err(a, b, path) for a, b, path in zip(
        param_leaves(got), param_leaves(want), _paths(want))])


def _leaf_update(a0, a, b, mm, vv, path, tcfg: TrainConfig,
                 lr: float) -> tuple:
    """(|a - AdamW(a0, mm, vv)| max over lr, ||a - b|| / ||b - a0||, path)
    of one leaf (``_update_err``), in f64 on pieces of ``UPDATE_CHUNK``
    values (on ``a``'s device; a whole embedding's f64 temporaries would
    hold several GB beside the ranks sharing the card)."""
    adamw = du = err = 0.0
    pieces = zip(*(t.reshape(-1).split(UPDATE_CHUNK)
                   for t in (a0, a, b, mm, vv)))
    for a0_, a_, b_, mm_, vv_ in pieces:
        p, a_, b_ = (t.to(a.device, torch.float64) for t in (a0_, a_, b_))
        ref = p - lr * ((mm_.to(a.device, torch.float64) / (1 - tcfg.beta1))
                        / ((vv_.to(a.device, torch.float64)
                            / (1 - tcfg.beta2)).sqrt() + tcfg.eps)
                        + tcfg.weight_decay * p)
        adamw = max(adamw, float((a_ - ref).abs().max()) / lr)
        del ref
        du += float((b_ - p).square().sum())
        err += float((a_ - b_).square().sum())
    du, err = math.sqrt(du), math.sqrt(err)
    return adamw, err / du if du else 0.0 if err == 0 else math.inf, path


def _update_err_of(stats) -> dict:
    """``_update_err`` from each leaf's ``_leaf_update``."""
    worst = max(stats, key=lambda t: t[1])
    return {"adamw_over_lr": max(t[0] for t in stats),
            "update_rel_err": worst[1], "worst_leaf": worst[2]}


def _update_err(p0, got, want, m, v, tcfg: TrainConfig, lr: float) -> dict:
    """The first AdamW step's parameters ``got`` held two ways, leaf by
    leaf: "adamw", the largest |got - AdamW(p0, m, v)| over the rate, with
    AdamW written out in f64 from the run's own moments ``m``, ``v`` (step
    1's bias corrections, decoupled weight decay), every element: a shard's
    update that is skipped, mis-signed or mis-corrected shows here;
    "update", the largest ||(got - p0) - (want - p0)|| / ||want - p0|| over
    the leaves, against the reference's parameters ``want``.  Element by
    element the update cannot be held to a reference at a visible rate: it
    is lr * g / (|g| + eps), which turns the rounding of a gradient near
    eps, or a sign that rounding flips, into a change of up to 2 lr."""
    return _update_err_of([_leaf_update(*leaves, tcfg, lr) for leaves in zip(
        param_leaves(p0), param_leaves(got), param_leaves(want),
        param_leaves(m), param_leaves(v), _paths(p0))])


def _exchange() -> tuple:
    ex = ccl_prim._permute
    return ex.seconds, ex.sent_bytes, ex.staged_bytes


def _exchange_delta(before: tuple) -> dict:
    now = _exchange()
    return {"exchange_s": now[0] - before[0],
            "wire_bytes": now[1] - before[1],
            "staged_bytes": now[2] - before[2]}


def _rank_ctx(world: int, **kw):
    mesh_cfg = MeshConfig((world, 1))
    return make_ctx(mesh_groups(mesh_cfg)[0], mesh_cfg, **kw)


def dp_parity_rank(rank: int, world: int, seed: int) -> dict:
    """One f32 step (TF32 off) of plain DP on ``ring``, one of ZeRO-1 and
    one of FSDP (``parallel.fsdp``), each from the same parameters on the
    global batch; rank 0 first runs the single-card step on the whole
    batch and holds each DP step to it: loss and grad_norm within rtol
    1e-4, m and v within 1e-5 of their max (``_tree_err``), the parameters
    through their update (``_update_err``); FSDP also to ZeRO-1's step
    the same ways."""
    device = rank_device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)
    batch = next(make_batches(cfg, DP_PARITY_BATCH, DP_PARITY_SEQ,
                              seed=seed))

    def fresh():
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(cfg, gen, dtype=torch.float32, device=device)

    single = p0 = None
    if rank == 0:
        p0 = fresh()
        params = fresh()
        params, opt, m = make_train_step(cfg, TrainConfig(
            **DP_PARITY_TCFG))(params, init_opt_state(params), batch)
        single = (params, opt, {k: float(v) for k, v in m.items()})
        del params, opt
    torch.cuda.synchronize()
    dist.barrier()
    out = {}
    kept = None  # rank 0: ZeRO-1's parameters, m, v and metrics, for FSDP
    for mode in ("zero1", "ring", "fsdp"):
        zero1 = mode == "zero1"
        fsdp = mode == "fsdp"
        ctx = _rank_ctx(world, remat=False, **(
            dict(cfg=cfg, fsdp=True) if fsdp else {}))
        params = fsdp_mod.fsdp_shard(fresh(), ctx) if fsdp else fresh()
        opt = init_opt_state(params, ctx if zero1 else None)
        step = make_train_step(cfg, TrainConfig(zero1=zero1,
                                                **DP_PARITY_TCFG), ctx)
        torch.cuda.synchronize()
        dist.barrier()
        n0, ex0, t0 = launch_counts(), _exchange(), time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        res = {"seconds": time.perf_counter() - t0, **_exchange_delta(ex0),
               "launches": _delta(n0),
               "metrics": {k: float(v) for k, v in m.items()},
               "opt_state_bytes": sum(
                   t.numel() * 4 for t in param_leaves(opt["m"])) * 2}
        if fsdp:  # the whole tree, gathered from the shards
            params = fsdp_mod.fsdp_gather(params, ctx)
            full = {k: fsdp_mod.fsdp_gather(opt[k], ctx) for k in ("m", "v")}
        else:
            full = gather_opt_state(opt, ctx, params) if zero1 else opt
        res["checksums"] = {"params": launch_train.checksum(params),
                            "m": launch_train.checksum(full["m"]),
                            "v": launch_train.checksum(full["v"])}
        if single is not None:
            sp, so, sm = single
            res["rel_err"] = {k: abs(res["metrics"][k] - sm[k])
                              / abs(sm[k]) for k in ("loss", "grad_norm")}
            res["single"] = {k: sm[k] for k in ("loss", "grad_norm")}
            res["trees"] = {"m": _tree_err(full["m"], so["m"]),
                            "v": _tree_err(full["v"], so["v"])}
            res["params"] = _update_err(
                p0, params, sp, full["m"], full["v"],
                TrainConfig(**DP_PARITY_TCFG), res["metrics"]["lr"])
            if zero1:
                kept = (params, full["m"], full["v"], res["metrics"])
            if fsdp:
                zp, zm, zv, zmet = kept
                res["vs_zero1"] = {
                    "rel_err": {k: abs(res["metrics"][k] - zmet[k])
                                / abs(zmet[k]) for k in ("loss", "grad_norm")},
                    "trees": {"m": _tree_err(full["m"], zm),
                              "v": _tree_err(full["v"], zv)},
                    "params": _update_err(
                        p0, params, zp, full["m"], full["v"],
                        TrainConfig(**DP_PARITY_TCFG), res["metrics"]["lr"])}
                del kept, zp, zm, zv
        del params, opt, full, step
        torch.cuda.empty_cache()
        out[mode] = res
    return out


def phase_dp_parity(seed: int) -> None:
    """DP-4 in f32 (ZeRO-1, plain DP, FSDP) against the single-card step,
    all on the card; FSDP against ZeRO-1 too."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_parity_rank, RING_RANKS, seed, backend="gloo",
                        timeout_s=900)
    for mode in ("zero1", "ring", "fsdp"):
        per = [r[mode] for r in ranks]
        head = per[0]
        same = all(p["checksums"] == head["checksums"] for p in per)
        emit({"phase": "dp_parity", "arch": ARCH, "sync": mode,
              "ranks": RING_RANKS, "backend": "gloo", "dtype": "float32",
              "batch": DP_PARITY_BATCH, "seq": DP_PARITY_SEQ,
              "metrics": head["metrics"], "single": head["single"],
              "rel_err": head["rel_err"],
              "trees": head["trees"], "params": head["params"],
              "identical_on_all_ranks": same,
              "seconds": [p["seconds"] for p in per],
              "exchange_s": [p["exchange_s"] for p in per],
              "wire_bytes_per_rank": head["wire_bytes"],
              "staged_bytes_per_rank": head["staged_bytes"],
              "opt_state_bytes_per_rank": head["opt_state_bytes"],
              "launches_per_rank": [p["launches"] for p in per],
              **({"vs_zero1": head["vs_zero1"]} if mode == "fsdp" else {})})
        check(same, f"dp_parity {mode}: ranks hold different parameters")
        if mode == "fsdp":  # FSDP against the ZeRO-1 step, the same bounds
            vs = head["vs_zero1"]
            errs = {k: v["err_over_max"] for k, v in vs["trees"].items()}
            check(max(vs["rel_err"].values()) <= 1e-4 and
                  max(errs.values()) <= 1e-5 and
                  vs["params"]["adamw_over_lr"] <= 1e-3 and
                  vs["params"]["update_rel_err"] <= 1e-2,
                  f"dp_parity fsdp: off the ZeRO-1 step: {vs}")
        check(max(head["rel_err"].values()) <= 1e-4,
              f"dp_parity {mode}: loss or grad_norm beyond rtol 1e-4 of "
              f"the single-card step: {head['rel_err']}")
        errs = {k: v["err_over_max"] for k, v in head["trees"].items()}
        check(max(errs.values()) <= 1e-5,
              f"dp_parity {mode}: moments beyond 1e-5 of their max: {errs}")
        up = head["params"]
        check(up["adamw_over_lr"] <= 1e-3,
              f"dp_parity {mode}: params beyond 1e-3 x lr of AdamW on the "
              f"run's own moments: {up}")
        check(up["update_rel_err"] <= 1e-2,
              f"dp_parity {mode}: a leaf's update beyond 1e-2 of the "
              f"single-card step's: {up}")
    emit({"phase": "dp_parity_total", "seconds": time.perf_counter() - t0})


def phase_dp_training(seed: int) -> dict:
    """ZeRO-1 bf16 training through the launcher's ``run``: 4 ranks share
    the card, ``DP_STEPS`` steps on one batch of B 8 x S 512 in 2
    microbatches, remat,
    bf16 gradients; a checkpoint written under a temporary directory and
    restored here.  Returns the launch counts of every rank's steps,
    summed."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        out = launch_train.run([
            "--arch", ARCH, "--devices", str(RING_RANKS),
            "--steps", str(DP_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--microbatches",
            str(TRAIN_MICROBATCHES), "--remat", "--grad-dtype", "bf16",
            "--fixed-batch", "--log-every", "1", "--ckpt-dir", tmp])
        ranks = out["ranks"]
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        tmpl = init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
        t_restore = time.perf_counter()
        path = out["lines"][-1].split(": ", 1)[1]
        params, opt, step = restore_checkpoint(cfg, path, tmpl,
                                               init_opt_state(tmpl))
        restored = {"params": launch_train.checksum(params),
                    "m": launch_train.checksum(opt["m"]),
                    "v": launch_train.checksum(opt["v"])}
        restore_s = time.perf_counter() - t_restore
        del tmpl, params, opt
    _release()
    want = train_launches(cfg, TRAIN_MICROBATCHES, True)
    losses = [s["loss"] for s in ranks[0]["steps"]]
    per_rank = [{
        "wall_ms": [s["wall_ms"] for s in r["steps"]],
        "compute_ms": [s["compute_ms"] for s in r["steps"]],
        "exchange_s": [s["exchange_s"] for s in r["steps"]],
        "wire_bytes": [s["wire_bytes"] for s in r["steps"]],
        "staged_bytes": [s["staged_bytes"] for s in r["steps"]],
        "opt_state_bytes": r["opt_state_bytes"],
        "peak_memory_bytes": r["peak_memory_bytes"],
        "launches": [s["launches"] for s in r["steps"]]} for r in ranks]
    share = [r["opt_state_bytes"] / r["replicated_opt_state_bytes"]
             for r in ranks]
    walls = [s["wall_ms"] for s in ranks[0]["steps"]]
    same = all(r["checksums"] == ranks[0]["checksums"] for r in ranks)
    emit({"phase": "dp_training", "arch": ARCH, "sync": "zero1",
          "ranks": RING_RANKS, "backend": ranks[0]["backend"],
          "devices": [r["device"] for r in ranks], "dtype": "float32",
          "grad_dtype": "bf16", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "microbatches": TRAIN_MICROBATCHES, "remat": True,
          "steps": DP_STEPS, "params": ranks[0]["params"],
          "losses": losses, "lines": out["lines"],
          "step_wall_ms_p50": float(np.percentile(walls, 50)),
          "per_rank": per_rank,
          "opt_state_share_of_replicated": share,
          "want_launches_per_step": want,
          "identical_on_all_ranks": same, "checkpoint_step": step,
          "checkpoint_restored_equal": restored == ranks[0]["checksums"],
          "restore_s": restore_s, "seconds": time.perf_counter() - t0})
    check(all(np.isfinite(losses)), f"non-finite DP loss: {losses}")
    check(losses[-1] <= 0.9 * losses[0],
          f"DP training did not fit its batch: {losses[0]} -> {losses[-1]}")
    check(same, "DP training: ranks end with different parameters")
    check(max(share) <= 0.26, f"ZeRO-1 optimizer state {share} of the "
                              f"replicated one")
    for r in per_rank:
        check(all(n == want for n in r["launches"]),
              f"a DP step launched {r['launches']}, want {want} a step")
    check(restored == ranks[0]["checksums"] and step == DP_STEPS,
          f"restored checkpoint {restored} differs from the ranks' "
          f"{ranks[0]['checksums']}")
    counts = {k: 0 for k in WRAPPERS}
    for r in per_rank:
        for n in r["launches"]:
            for k, v in n.items():
                counts[k] += v
    return counts


def _real_gradient_syncs(local, synced, ctx, world: int) -> dict:
    """The first step's gradient synced again: ``local`` (this rank's,
    flat) by ``ring_q8`` (bit-equal to ``synced``, the step's own sync, a
    list of leaves), by ``ring_q4``, and exactly by ``ring``, in place
    (the card holds four ranks' training state: one extra copy at a
    time).  Each quantizing sync's error against the exact sum (relative
    L2, and its worst over its envelope) and its wire bytes against
    ``ring``'s."""
    layout = flat_layout([local], ctx)
    amax = [float(ccl_prim.ring_all_gather(local[lo:hi].abs().max(),
                                           ctx.group).max())
            for lo, hi in layout.buckets]

    def sync(x, impl):
        torch.cuda.synchronize()
        dist.barrier()
        ex0, t0 = _exchange(), time.perf_counter()
        out = layout.all_reduce(x, impl, ctx.group)
        torch.cuda.synchronize()
        return out, {"seconds": time.perf_counter() - t0,
                     **_exchange_delta(ex0)}

    q8, info8 = sync(local.clone(), "ring_q8")
    equal = all(torch.equal(a, b) for a, b in zip(
        q8.split([g.numel() for g in synced]), (g.reshape(-1)
                                                for g in synced)))
    del q8
    q4, info4 = sync(local.clone(), "ring_q4")
    exact, info = sync(local, "ring")
    n2 = sum(float(exact[lo:hi].double().square().sum())
             for lo, hi in layout.buckets)
    offsets = np.cumsum([0] + [g.numel() for g in synced])
    real = {"ring": info}
    for impl, pieces, inf, qmax in (
            ("ring_q8", [(int(o), g.reshape(-1)) for o, g in
                         zip(offsets, synced)], info8, 127),
            ("ring_q4", [(0, q4)], info4, 7)):
        # the collective's own envelope, bucket by bucket, as the
        # stand-in's: p * absmax / qmax (tests/test_ccl_primitives.py
        # :100-103), absmax over every rank's bucket
        worst, e2 = 0.0, 0.0
        for at, piece in pieces:
            for (lo, hi), a in zip(layout.buckets, amax):
                lo, hi = max(lo, at), min(hi, at + piece.numel())
                if lo >= hi:
                    continue
                d = piece[lo - at:hi - at] - exact[lo:hi]
                worst = max(worst, float(d.abs().max()) / (world * a / qmax))
                e2 += float(d.double().square().sum())
                del d
        real[impl] = {**inf, "rel_l2_err": (e2 / n2) ** 0.5,
                      "wire_ratio": inf["wire_bytes"] / info["wire_bytes"],
                      "worst_err_over_envelope": worst}
    del q4, exact
    real["step_sync_bit_equal_to_ring_q8"] = equal
    real["synced_checksum"] = sum(int(g.view(torch.int32).sum(
        dtype=torch.int64)) for g in synced)
    return real


def dp_q8_rank(rank: int, world: int, seed: int) -> dict:
    """Plain DP on ``ring_q8`` (K2a and K2b in every hop), 3 f32 steps on
    one batch.  At the first step the hook takes the real gradient before
    and after the sync, and (inside the hook, before AdamW's buffers
    exist) syncs it again: ``_real_gradient_syncs``."""
    device = rank_device(DEVICE)
    cfg = get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.float32, device=device)
    ctx = _rank_ctx(world, remat=True, grad_all_reduce="ring_q8")
    opt = init_opt_state(params)
    batch = next(make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed))
    step = make_train_step(cfg, TrainConfig(**DP_Q8_TCFG), ctx)
    taken = {}

    def hook(stage, grads):
        if stage == "local":
            taken["local"] = torch.cat([g.reshape(-1) for g in grads])
        else:
            n0 = launch_counts()
            taken["real"] = _real_gradient_syncs(taken.pop("local"), grads,
                                                 ctx, world)
            taken["launches"] = _delta(n0)

    reset_launch_counts()
    losses, steps = [], []
    for i in range(DP_Q8_STEPS):
        torch.cuda.synchronize()
        n0, ex0, t0 = launch_counts(), _exchange(), time.perf_counter()
        params, opt, m = step(params, opt, batch,
                              grad_hook=hook if i == 0 else None)
        losses.append(float(m["loss"]))
        steps.append({"wall_ms": 1e3 * (time.perf_counter() - t0),
                      **_exchange_delta(ex0), "launches": _delta(n0)})
    counts = launch_counts()
    # the resyncs inside the first step's hook are not the path's
    for k, v in taken["launches"].items():
        counts[k] -= v
    return {"losses": losses, "steps": steps, "launches": counts,
            "real_gradient": taken["real"],
            "gradient_values": sum(p.numel() for p in param_leaves(params))}


def phase_dp_q8(seed: int) -> dict:
    """Plain DP on ring_q8 over 4 ranks; returns the kernel launches of
    every rank's steps, summed."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_q8_rank, RING_RANKS, seed, backend="gloo",
                        timeout_s=900)
    head = ranks[0]
    counts = {k: sum(r["launches"][k] for r in ranks) for k in WRAPPERS}
    same = len({r["real_gradient"]["synced_checksum"] for r in ranks}) == 1
    emit({"phase": "dp_q8", "arch": ARCH, "sync": "ring_q8",
          "ranks": RING_RANKS, "backend": "gloo", "dtype": "float32",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "microbatches": TRAIN_MICROBATCHES, "remat": True,
          "losses": head["losses"],
          "steps_per_rank": [r["steps"] for r in ranks],
          "step_launches_note": "step 0 also times the hook's resyncs",
          "gradient_values": head["gradient_values"],
          "real_gradient_by_rank": [r["real_gradient"] for r in ranks],
          "regime": CODEC_REGIME["q8"],
          "step_sync_within_regime": [
              r["real_gradient"]["ring_q8"]["rel_l2_err"]
              <= CODEC_REGIME["q8"] for r in ranks],
          "synced_identical_on_all_ranks": same,
          "launches": counts, "seconds": time.perf_counter() - t0})
    check(all(np.isfinite(r["losses"]).all() for r in ranks),
          "non-finite ring_q8 DP loss")
    check(same, "ring_q8 DP: ranks synced different gradients")
    for r in ranks:
        rg = r["real_gradient"]
        check(rg["step_sync_bit_equal_to_ring_q8"],
              "the step's ring_q8 sync differs from ring_q8 on the same "
              "gradient")
        for impl in ("ring_q8", "ring_q4"):
            check(rg[impl]["worst_err_over_envelope"] <= 1.0,
                  f"{impl} on the real gradient beyond p * absmax / qmax: "
                  f"{rg[impl]['worst_err_over_envelope']}")
    for name in ("quantize", "dequantize"):
        check(all(r["launches"][name] > 0 for r in ranks),
              f"kernel {name} not launched in every ring_q8 rank")
    return counts


def run_dp(seed: int) -> dict:
    """The data-parallel path (4 gloo ranks on the card, full width and
    depth); returns each phase's launch counts."""
    _release()  # the ranks need the card's memory
    phase_dp_parity(seed)
    return {"dp_training": phase_dp_training(seed + 1),
            "dp_q8": phase_dp_q8(seed + 2)}


# --------------------------------------------------------------------------
# 3d. expert parallelism (dbrx-132b, full width): 4 gloo ranks on the card
# --------------------------------------------------------------------------

EP_RANKS = 4
EP_BATCH, EP_SEQ = 2, 256      # the prefill: B 2 x S 256
EP_SLOTS = 4                   # decode slots
EP_PARITY_STEPS = 8
EP_SERVE_STEPS = 16
EP_NO_DROP = 16.0              # capacity factor: C 512 >= the 128 tokens
EP_TRAIN_FACTOR = 1.25         # a shard sends an expert
EP_MARGIN_ULPS = 8             # bf16 ulps of the top logit: tokens compared
# G2: the bf16 EP decode's max |logit diff| against the single card's, about
# twice the worst sound run on the card: 0.609 and 1.145 in two runs of the
# same code (ep_serving, NVIDIA H100 80GB HBM3, 700 W: a near-tie of the
# router flips between them); the planted fault gave 6.14 and 6.08
EP_DECODE_DIFF_BOUND = 2.3


def _ep_ctx(cfg, mesh_shape, **kw):
    mesh_cfg = MeshConfig(tuple(mesh_shape))
    dgroup, mgroup = mesh_groups(mesh_cfg)
    return make_ctx(dgroup, mesh_cfg, model_group=mgroup, **kw)


def _top2(logits, v: int):
    """(argmax, top-1 minus top-2, top-1) over the true vocabulary."""
    top = logits[..., :v].float().topk(2, dim=-1).values
    return logits[..., :v].argmax(-1), top[..., 0] - top[..., 1], top[..., 0]


def _ulps_bf16(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30))) - 7)


def _ep_teacher_decode(cfg, params, serve, tokens, device, context=None):
    """``tokens`` (slots, steps + 1) fed one a step from position 0 (the
    reference's own greedy choices, so that the two runs see the same
    inputs), over ``context`` (one row a slot, for a config with one);
    returns the logits of every step (slots, steps, V_pad) and each
    step's ms (CUDA events)."""
    slots, steps = tokens.shape[0], tokens.shape[1] - 1
    cache = init_cache(cfg, params, slots, steps,
                       dtype=params["embed"].dtype, context=context)
    out, ms = [], []
    for t in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, lg, cache = serve(params, cache, tokens[:, t:t + 1].to(device), t)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        out.append(lg[:, 0])
    return torch.stack(out, 1), ms


def _ep_reference(cfg, seed: int, tokens, first, steps: int, emulate=None):
    """The single-card dense run of ``cfg`` drawn from ``seed`` on the
    card: prefill logits of ``tokens`` and ``steps`` greedy decode steps of
    ``EP_SLOTS`` slots from the ``first`` tokens; with ``emulate`` (a
    capacity factor) also the prefill through ``moe_ep_train_ref`` on
    ``EP_RANKS`` model ranks.  Returns host tensors; frees the card."""
    dtype = torch.float32 if emulate is not None else torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=dtype, device=DEVICE)
    out = {}
    with torch.no_grad():
        out["prefill"] = make_prefill(cfg)(params, tokens.to(DEVICE)).cpu()
        serve = make_serve_step(cfg)
        cache = init_cache(cfg, params, EP_SLOTS, steps, dtype=dtype)
        tok, fed, logits = first.to(DEVICE), [first], []
        for t in range(steps):
            tok, lg, cache = serve(params, cache, tok, t)
            fed.append(tok.cpu())
            logits.append(lg[:, 0].cpu())
        out["decode"] = torch.stack(logits, 1)
        out["fed"] = torch.cat(fed, 1)
        if emulate is not None:
            dropped = []
            real = moe_mod.moe_apply

            def plain_ep(p, cfg_, x, *, ctx=None, decode=False):
                y, aux, share = moe_mod.moe_ep_train_ref(
                    p, cfg_, x, EP_RANKS, emulate)
                dropped.append(share)
                return y, aux

            moe_mod.moe_apply = plain_ep
            try:
                out["emulated"] = make_prefill(cfg)(
                    params, tokens.to(DEVICE)).cpu()
            finally:
                moe_mod.moe_apply = real
            out["dropped_share"] = dropped
    del params
    _release()
    return out


def _ep_rank_params(cfg, seed: int, dtype, ctx, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, dtype=dtype, device=device, ctx=ctx)


def ep_parity_rank(rank: int, world: int, cfg, seed: int, ref_path: str,
                   device: str) -> dict:
    """f32 (TF32 off) on a (1, 4) mesh: this rank's expert part drawn from
    the seed; EP prefill at capacity factor 16 against the single-card
    dense logits, at 1.25 against the plain emulation; EP decode (teacher
    forced) against the dense decode.  Then on a (2, 2) mesh, on the
    parameters drawn again in the weight-stationary layout, the
    weight-stationary decode of this data rank's slots against the same
    rows of the dense decode.  Launches of each, and a checksum of the
    logits (the same on every rank of a data index)."""
    dev = rank_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(ref_path)
    out = {}
    for name, factor in (("no_drop", EP_NO_DROP), ("drop", EP_TRAIN_FACTOR)):
        ctx = _ep_ctx(cfg, (1, world), remat=False, capacity_factor=factor)
        if name == "no_drop":
            params = _ep_rank_params(cfg, seed, torch.float32, ctx, dev)
        n0 = launch_counts()
        with torch.no_grad():
            logits = make_prefill(cfg, ctx)(params, ref["tokens"].to(dev))
        torch.cuda.synchronize()
        want = ref["prefill" if name == "no_drop" else "emulated"]
        out[name] = _logit_err(logits.cpu(), want, cfg.vocab_size)
        out[name]["launches"] = _delta(n0)
        out[name]["checksum"] = launch_train.checksum([logits])
    with torch.no_grad():
        n0 = launch_counts()
        got, _ = _ep_teacher_decode(cfg, params, make_serve_step(cfg, ctx),
                                    ref["fed"], dev)
    out["decode"] = _logit_err(got.cpu(), ref["decode"], cfg.vocab_size)
    out["decode"]["launches"] = _delta(n0)
    out["decode"]["checksum"] = launch_train.checksum([got])
    del params, got
    _release()
    ctx = _ep_ctx(cfg, (2, world // 2), remat=False,
                  ep_weight_stationary=True)
    params = _ep_rank_params(cfg, seed, torch.float32, ctx, dev)
    rows = slice(ctx.rank * EP_SLOTS // ctx.dp,
                 (ctx.rank + 1) * EP_SLOTS // ctx.dp)
    with torch.no_grad():
        n0 = launch_counts()
        got, _ = _ep_teacher_decode(cfg, params, make_serve_step(cfg, ctx),
                                    ref["fed"][rows], dev)
    out["decode_ws"] = _logit_err(got.cpu(), ref["decode"][rows],
                                  cfg.vocab_size)
    out["decode_ws"]["launches"] = _delta(n0)
    out["decode_ws"]["checksum"] = launch_train.checksum([got])
    out["data_rank"] = ctx.rank
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _logit_err(got, want, v: int, ties=None) -> dict:
    """Max |err| of ``got`` against ``want`` over the true vocabulary, its
    excess over PARITY_TOL and whether the greedy tokens agree; ``ties``
    (a mask of the positions): positions held out of the excess and the
    greedy tokens, counted, their own max |err| reported."""
    err = (got[..., :v].float() - want[..., :v].float()).abs()
    excess = (err - PARITY_TOL["atol"] - PARITY_TOL["rtol"] *
              want[..., :v].float().abs()).amax(-1)
    same = got[..., :v].argmax(-1) == want[..., :v].argmax(-1)
    out = {"max_abs_err": float(err.max())}
    if ties is not None:
        out.update(router_ties=int(ties.sum()),
                   positions_beyond_tol=int((excess > 0).sum()),
                   max_abs_err_at_ties=float(err.amax(-1)[ties].max())
                   if bool(ties.any()) else None)
        excess = excess.masked_fill(ties, -math.inf)
        same = same | ties
    return {**out, "excess": float(excess.max()),
            "greedy_equal": bool(same.all())}


def phase_ep_parity(rng, seed: int) -> dict:
    """dbrx-132b at full width, 2 layers, f32: EP on 4 ranks (mesh (1, 4),
    and the weight-stationary decode on (2, 2)) against the single-card
    dense run (freed first: 31 GB) and the plain emulation."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_PARITY_LAYERS)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (EP_BATCH, EP_SEQ)))
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, (EP_SLOTS, 1)))
    ref = _ep_reference(cfg, seed, tokens, first, EP_PARITY_STEPS,
                        emulate=EP_TRAIN_FACTOR)
    ref["tokens"] = tokens
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="ep_parity_") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save(ref, path)
        ranks = spawn_ranks(ep_parity_rank, EP_RANKS, cfg, seed, path,
                            DEVICE, backend="gloo", timeout_s=600)
    head = ranks[0]
    per_layer = 3 * MOE_PARITY_LAYERS
    for name in ("no_drop", "drop", "decode", "decode_ws"):
        ws = name == "decode_ws"
        # ranks of one data index hold the same logits
        same = all(len({r[name]["checksum"] for r in ranks
                        if r["data_rank"] == d}) == 1
                   for d in {r["data_rank"] for r in ranks}) if ws \
            else len({r[name]["checksum"] for r in ranks}) == 1
        emit({"phase": "ep_parity", "arch": cfg.name, "case": name,
              "path": "moe_ep_decode_ws" if ws else {
                  "decode": "moe_ep_decode"}.get(name, "moe_ep_train"),
              "dtype": "float32", "layers": cfg.num_layers,
              "mesh": [2, EP_RANKS // 2] if ws else [1, EP_RANKS],
              "backend": "gloo",
              "capacity_factor": {"no_drop": EP_NO_DROP,
                                  "drop": EP_TRAIN_FACTOR}.get(
                                      name, EP_NO_DROP),
              "against": "plain emulation" if name == "drop" else "dense",
              **{k: head[name][k] for k in ("max_abs_err", "excess",
                                            "greedy_equal")},
              "tol": PARITY_TOL, "identical_across_model_ranks": same,
              "launches_per_rank": [r[name]["launches"] for r in ranks]})
        check(same, f"ep_parity {name}: ranks hold different logits")
        check(head[name]["excess"] <= 0,
              f"ep_parity {name}: beyond {PARITY_TOL}: max |err| "
              f"{head[name]['max_abs_err']}")
        want = per_layer * (EP_PARITY_STEPS if name.startswith("decode")
                            else 1)
        check(all(r[name]["launches"].get("moe_gmm") == want for r in ranks),
              f"ep_parity {name}: K5 launches a rank "
              f"{[r[name]['launches'] for r in ranks]}, want {want}")
    emit({"phase": "ep_parity_total", "seconds": time.perf_counter() - t0,
          "reference_s": ref_s,
          "dropped_share_at_1.25": ref["dropped_share"],
          "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                         for r in ranks]})
    return _ep_sum([r[k]["launches"] for r in ranks
                    for k in ("no_drop", "drop", "decode", "decode_ws")])


def _ep_sum(deltas) -> dict:
    total = {k: 0 for k in WRAPPERS}
    for d in deltas:
        for k, v in d.items():
            total[k] += v
    return total


def _token_check(got_logits, ref: dict, rows, v: int) -> dict:
    """Greedy tokens of ``got_logits`` (rows of the reference's decode)
    against the reference's, where its top-2 margin exceeds
    ``EP_MARGIN_ULPS`` bf16 ulps of its top logit."""
    want, margin, top = _top2(ref["decode"][rows], v)
    got = got_logits[..., :v].float().argmax(-1)
    firm = margin > EP_MARGIN_ULPS * _ulps_bf16(top)
    diff = (got_logits[..., :v].float() - ref["decode"][rows][..., :v]
            .float()).abs()
    return {"compared": int(firm.sum()), "of": int(firm.numel()),
            "mismatches": int(((got != want) & firm).sum()),
            "unforced_mismatches": int(((got != want) & ~firm).sum()),
            "min_margin_compared": float(margin[firm].min())
            if bool(firm.any()) else None,
            "max_abs_logit_diff": float(diff.max())}


class SkipAttentionReduce:
    """A planted fault: the attention's ``reduce_from_model`` skipped on
    the first of every ``every`` calls (with ``every`` the attention
    layers of a decode step: the first layer's), each rank going on with
    its own heads' partial output."""

    def __init__(self, every: int):
        from repro_torch.models import attention
        self.module, self.every, self.calls = attention, every, 0
        self.real = attention.reduce_from_model

    def __call__(self, x, ctx):
        self.calls += 1
        return x if (self.calls - 1) % self.every == 0 else \
            self.real(x, ctx)

    def __enter__(self):
        self.module.reduce_from_model = self
        return self

    def __exit__(self, *exc):
        self.module.reduce_from_model = self.real


def ep_serving_rank(rank: int, world: int, cfg, seed: int, ref_path: str,
                    device: str) -> dict:
    """bf16 on a (1, 4) mesh: prefill B 2 x S 256 through
    ``make_prefill(cfg, ctx)`` (timed, three calls), then 16 decode steps
    of 4 slots through ``make_serve_step(cfg, ctx=ctx)`` (teacher forced by
    the reference's greedy tokens), with launches, exchange seconds and
    bytes of each; then the same decode with the first layer's attention
    all-reduce skipped (``SkipAttentionReduce``), its max |logit diff|."""
    dev = rank_device(device)
    ref = torch.load(ref_path)
    ctx = _ep_ctx(cfg, (1, world), remat=False)
    params = _ep_rank_params(cfg, seed, torch.bfloat16, ctx, dev)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in param_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    prefill = make_prefill(cfg, ctx)
    tokens = ref["tokens"].to(dev)
    out = {"prefill_ms": []}
    with torch.no_grad():
        for i in range(3):
            dist.barrier()
            n0, ex0 = launch_counts(), _exchange()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            logits = prefill(params, tokens)
            b.record()
            torch.cuda.synchronize()
            out["prefill_ms"].append(a.elapsed_time(b))
            if i == 0:
                out["prefill"] = {"launches": _delta(n0),
                                  **_exchange_delta(ex0)}
        arg, margin, top = _top2(logits[:, -1].cpu(), cfg.vocab_size)
        want, wmargin, wtop = _top2(ref["prefill"][:, -1], cfg.vocab_size)
        out["prefill_tokens"] = {"got": arg.tolist(), "want": want.tolist(),
                                 "margin": wmargin.tolist(),
                                 "firm": (wmargin > EP_MARGIN_ULPS
                                          * _ulps_bf16(wtop)).tolist()}
        del logits
        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        got, ms = _ep_teacher_decode(cfg, params,
                                     make_serve_step(cfg, ctx=ctx),
                                     ref["fed"], dev)
        out["decode"] = {"launches": _delta(n0), **_exchange_delta(ex0),
                         "step_ms": ms}
        out["tokens"] = _token_check(got.cpu(), ref, slice(None),
                                     cfg.vocab_size)
        del got
        with SkipAttentionReduce(sum(s.mixer == "attn"
                                     for s in cfg.layer_specs())):
            bad, _ = _ep_teacher_decode(cfg, params,
                                        make_serve_step(cfg, ctx=ctx),
                                        ref["fed"], dev)
        out["fault_max_abs_logit_diff"] = _token_check(
            bad.cpu(), ref, slice(None), cfg.vocab_size)["max_abs_logit_diff"]
    out["param_bytes"] = param_bytes
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["capacity"] = {"prefill": moe_mod.capacity_for(
        EP_BATCH * EP_SEQ // world, cfg.top_k, cfg.num_experts,
        ctx.capacity_factor),
        "decode": moe_mod.capacity_for(EP_SLOTS, cfg.top_k, cfg.num_experts,
                                       ctx.decode_capacity_factor)}
    return out


def ep_ws_rank(rank: int, world: int, cfg, seed: int, ref_path: str,
               device: str) -> dict:
    """bf16 on a (2, 2) mesh, each data rank on its 2 of the 4 slots: 16
    decode steps through ``moe_ep_decode_ws`` (experts (E/2, d, ff/2) a
    rank), then, on parameters drawn again in the EP layout, through
    ``moe_ep_decode``; teacher forced by the reference's tokens."""
    dev = rank_device(device)
    ref = torch.load(ref_path)
    out = {}
    for name, ws in (("ws", True), ("ep", False)):
        ctx = _ep_ctx(cfg, (2, world // 2), remat=False,
                      ep_weight_stationary=ws)
        params = _ep_rank_params(cfg, seed, torch.bfloat16, ctx, dev)
        torch.cuda.reset_peak_memory_stats()
        rows = slice(ctx.rank * EP_SLOTS // ctx.dp,
                     (ctx.rank + 1) * EP_SLOTS // ctx.dp)
        with torch.no_grad():
            dist.barrier()
            n0, ex0 = launch_counts(), _exchange()
            got, ms = _ep_teacher_decode(cfg, params,
                                         make_serve_step(cfg, ctx=ctx),
                                         ref["fed"][rows], dev)
        out[name] = {"launches": _delta(n0), **_exchange_delta(ex0),
                     "step_ms": ms,
                     "tokens": _token_check(got.cpu(), ref, rows,
                                            cfg.vocab_size),
                     "expert_bytes": sum(
                         t.numel() * t.element_size() for t, e in zip(
                             param_leaves(params), expert_flags(params))
                         if e),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del params, got
        _release()
    return out


def _ep_a2a_bytes(cfg, tp: int, capacity: int, itemsize: int = 2) -> int:
    """Wire bytes of a rank's two all-to-alls a MoE layer (bf16 by
    default): 2 x (tp - 1)/tp of its (tp, E/tp, C, d) buffer."""
    e_local = cfg.num_experts // tp
    return 2 * (tp - 1) * e_local * capacity * cfg.d_model * itemsize


def _ring_ar_bytes(n: int, p: int) -> int:
    """Wire bytes a rank of ``ring_all_reduce`` of ``n`` bf16 values over
    ``p`` ranks: 2 (p - 1) chunks of n / p (padded)."""
    return 2 * (p - 1) * -(-n // p) * 2 if p > 1 else 0


def _ep_decode_bytes(cfg, dp: int, tp: int, ws: bool) -> int:
    """Wire bytes a rank a decode step of ``EP_SLOTS`` slots (bf16) on a
    (dp, tp) mesh, each data rank on its share of the slots: the model
    axis's (``tp_forward_bytes``: the embedding's and the attention's
    all-reduces, the logits' gather, and per MoE layer the model-axis
    all-reduce of the rank's tokens); weight-stationary, the MoE layers
    instead the one packed gather of the tokens (x, the int64 ids and the
    weights a row) and both all-reduces over all of them.  No other
    exchange: the router loss of decode is not summed over the data
    ranks."""
    rows, d, k = EP_SLOTS // dp, cfg.d_model, cfg.top_k
    if not ws:
        return tp_forward_bytes(cfg, tp, rows, 1, 2, moe="decode")
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    gather = (dp - 1) * rows * (2 * d + 8 * k + 2 * k)
    full = EP_SLOTS * d
    return tp_forward_bytes(cfg, tp, rows, 1, 2) + n_moe * (
        gather + _ring_ar_bytes(full, tp) + _ring_ar_bytes(full, dp))


def phase_ep_serving(rng, seed: int) -> dict:
    """dbrx-132b at full width, 4 layers, bf16: the single-card dense run
    (28.6 GB, freed first), then EP serving on (1, 4) and the
    weight-stationary and EP decode on (2, 2), 4 gloo ranks each."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_SERVE_LAYERS)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (EP_BATCH, EP_SEQ)))
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, (EP_SLOTS, 1)))
    ref = _ep_reference(cfg, seed, tokens, first, EP_SERVE_STEPS)
    ref["tokens"] = tokens
    ref_s = time.perf_counter() - t0
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    with tempfile.TemporaryDirectory(prefix="ep_serving_") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save(ref, path)
        t1 = time.perf_counter()
        ranks = spawn_ranks(ep_serving_rank, EP_RANKS, cfg, seed, path,
                            DEVICE, backend="gloo", timeout_s=600)
        serving_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        ws_ranks = spawn_ranks(ep_ws_rank, EP_RANKS, cfg, seed, path,
                               DEVICE, backend="gloo", timeout_s=600)
        ws_s = time.perf_counter() - t1

    tp = EP_RANKS
    head = ranks[0]
    cap = head["capacity"]
    a2a = n_moe * _ep_a2a_bytes(cfg, tp, cap["prefill"])
    gather = n_moe * (tp - 1) * EP_BATCH * (EP_SEQ // tp) * cfg.d_model * 2
    want_prefill_bytes = tp_forward_bytes(cfg, tp, EP_BATCH, EP_SEQ, 2,
                                          moe="train",
                                          capacity=cap["prefill"])
    decode_ms = [m for r in ranks for m in r["decode"]["step_ms"]]
    emit({"phase": "ep_serving", "arch": cfg.name, "dtype": "bfloat16",
          "layers": cfg.num_layers, "mesh": [1, tp], "backend": "gloo",
          "prefill_batch": EP_BATCH, "prefill_seq": EP_SEQ,
          "slots": EP_SLOTS, "steps": EP_SERVE_STEPS, "capacity": cap,
          "prefill_ms": [r["prefill_ms"] for r in ranks],
          "decode_step_ms_p50": float(np.percentile(decode_ms, 50)),
          "decode_step_ms_p99": float(np.percentile(decode_ms, 99)),
          "prefill_exchange_s": [r["prefill"]["exchange_s"] for r in ranks],
          "prefill_wire_bytes": [r["prefill"]["wire_bytes"] for r in ranks],
          "prefill_staged_bytes": [r["prefill"]["staged_bytes"]
                                   for r in ranks],
          "a2a_wire_bytes_formula": a2a, "seq_gather_wire_bytes": gather,
          "prefill_wire_bytes_formula": want_prefill_bytes,
          "decode_exchange_s": [r["decode"]["exchange_s"] for r in ranks],
          "decode_wire_bytes_per_step": [
              r["decode"]["wire_bytes"] / EP_SERVE_STEPS for r in ranks],
          "decode_staged_bytes_per_step": [
              r["decode"]["staged_bytes"] / EP_SERVE_STEPS for r in ranks],
          "prefill_tokens": head["prefill_tokens"],
          "tokens": [r["tokens"] for r in ranks],
          "decode_max_abs_logit_diff": [r["tokens"]["max_abs_logit_diff"]
                                        for r in ranks],
          "decode_diff_bound": EP_DECODE_DIFF_BOUND,
          "fault_decode_max_abs_logit_diff": [
              r["fault_max_abs_logit_diff"] for r in ranks],
          "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
          "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                         for r in ranks],
          "launches_per_rank": {"prefill": [r["prefill"]["launches"]
                                            for r in ranks],
                                "decode": [r["decode"]["launches"]
                                           for r in ranks]},
          "reference_s": ref_s, "ranks_s": serving_s})
    want_prefill = {k: n for k, n in {**prefill_launches(cfg),
                                      **ep_launches(cfg)}.items() if n}
    want_decode = {k: n * EP_SERVE_STEPS
                   for k, n in ep_launches(cfg).items()}
    for r in ranks:
        check(r["prefill"]["launches"] == want_prefill,
              f"ep_serving prefill launched {r['prefill']['launches']}, "
              f"want {want_prefill}")
        check(r["decode"]["launches"] == want_decode,
              f"ep_serving decode launched {r['decode']['launches']}, "
              f"want {want_decode}")
        check(r["prefill"]["wire_bytes"] == want_prefill_bytes,
              f"ep_serving prefill wire bytes {r['prefill']['wire_bytes']}"
              f", want {want_prefill_bytes} (all-to-all {a2a}, sequence "
              f"gather {gather}, the rest the model axis's all-reduces and "
              f"the logits' gather)")
        want_bytes = EP_SERVE_STEPS * _ep_decode_bytes(cfg, 1, tp, False)
        check(r["decode"]["wire_bytes"] == want_bytes,
              f"ep_serving decode wire bytes {r['decode']['wire_bytes']}, "
              f"want {want_bytes}")
        check(r["tokens"]["mismatches"] == 0,
              f"ep_serving: greedy tokens differ from the dense run where "
              f"its margin exceeds {EP_MARGIN_ULPS} bf16 ulps: "
              f"{r['tokens']}")
        sound, bad = (r["tokens"]["max_abs_logit_diff"],
                      r["fault_max_abs_logit_diff"])
        check(sound <= EP_DECODE_DIFF_BOUND < bad,
              f"ep_serving (G2): bf16 EP decode max |logit diff| {sound}, "
              f"with the first attention all-reduce skipped {bad}: want "
              f"the sound run <= {EP_DECODE_DIFF_BOUND} < the faulted one")

    for name in ("ws", "ep"):
        per = [r[name] for r in ws_ranks]
        ms = [m for p in per for m in p["step_ms"]]
        emit({"phase": "ep_ws_decode", "arch": cfg.name,
              "path": {"ws": "moe_ep_decode_ws",
                       "ep": "moe_ep_decode"}[name],
              "dtype": "bfloat16", "layers": cfg.num_layers,
              "mesh": [2, tp // 2], "backend": "gloo", "slots": EP_SLOTS,
              "steps": EP_SERVE_STEPS,
              "step_ms_p50": float(np.percentile(ms, 50)),
              "step_ms_p99": float(np.percentile(ms, 99)),
              "exchange_s": [p["exchange_s"] for p in per],
              "wire_bytes_per_step": [p["wire_bytes"] / EP_SERVE_STEPS
                                      for p in per],
              "staged_bytes_per_step": [p["staged_bytes"] / EP_SERVE_STEPS
                                        for p in per],
              "expert_bytes_per_rank": per[0]["expert_bytes"],
              "peak_memory_bytes_per_rank": [p["peak_memory_bytes"]
                                             for p in per],
              "tokens": [p["tokens"] for p in per],
              "launches_per_rank": [p["launches"] for p in per]})
        want_bytes = EP_SERVE_STEPS * _ep_decode_bytes(
            cfg, 2, tp // 2, name == "ws")
        for p in per:
            check(p["launches"] == want_decode,
                  f"ep_ws_decode {name} launched {p['launches']}, want "
                  f"{want_decode}")
            check(p["wire_bytes"] == want_bytes,
                  f"ep_ws_decode {name} wire bytes {p['wire_bytes']}, want "
                  f"{want_bytes}")
            check(p["tokens"]["mismatches"] == 0,
                  f"ep_ws_decode {name}: greedy tokens differ from the "
                  f"dense run: {p['tokens']}")
    emit({"phase": "ep_serving_total", "seconds": time.perf_counter() - t0,
          "reference_s": ref_s, "serving_ranks_s": serving_s,
          "ws_ranks_s": ws_s})
    return {"ep_serving": _ep_sum(
        [r[k]["launches"] for r in ranks for k in ("prefill", "decode")]),
        "ep_ws_decode": _ep_sum([r[k]["launches"] for r in ws_ranks
                                 for k in ("ws", "ep")])}


# expert-parallel training: dbrx-132b at full width, 1 layer, on (1, 2),
# two gloo ranks sharing the card (8 experts a rank: 2.91 B parameters,
# 35 GB of parameters, gradients and AdamW state a rank); first dbrx's
# smoke config in f32 against the single-card step of the plain emulation
EP_TRAIN_RANKS = 2
EP_TRAIN_STEPS = 5
EP_TRAIN_SMOKE_BATCH, EP_TRAIN_SMOKE_SEQ = 4, 64
EP_TRAIN_TCFG = dict(microbatches=1, remat=False, learning_rate=1e-3,
                     warmup_steps=1, total_steps=EP_TRAIN_STEPS,
                     grad_dtype="bf16", zero1=False)


def ep_training_rank(rank: int, world: int, cfg, seed: int,
                     device: str) -> dict:
    """On a (1, world) mesh at capacity factor 1.25: one f32 step of
    dbrx's smoke config (this rank's experts drawn from ``seed``), then
    ``EP_TRAIN_STEPS`` bf16 steps of ``cfg`` on one batch, each with its
    launches, wall ms (CUDA events), exchange seconds and bytes; the
    peak memory of this rank."""
    # the two ranks hold ~37 GB each of the card's 80: no fragmentation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = rank_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    small = smoke_config(MOE_ARCH)
    ctx = _ep_ctx(small, (1, world), remat=False,
                  capacity_factor=EP_TRAIN_FACTOR)
    params = _ep_rank_params(small, seed, torch.float32, ctx, dev)
    batch = next(make_batches(small, EP_TRAIN_SMOKE_BATCH,
                              EP_TRAIN_SMOKE_SEQ, seed=seed))
    _, _, m = make_train_step(small, TrainConfig(remat=False, zero1=False),
                              ctx)(params, init_opt_state(params), batch)
    out = {"smoke": {k: float(v) for k, v in m.items()}}
    del params, m
    _release()

    ctx = _ep_ctx(cfg, (1, world), remat=False,
                  capacity_factor=EP_TRAIN_FACTOR)
    torch.cuda.reset_peak_memory_stats()
    params = _ep_rank_params(cfg, seed + 1, torch.bfloat16, ctx, dev)
    opt = init_opt_state(params)
    batch = next(make_batches(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                              seed=seed + 1))
    step = make_train_step(cfg, TrainConfig(**EP_TRAIN_TCFG), ctx)
    out["steps"] = []
    for _ in range(EP_TRAIN_STEPS):
        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, opt, m = step(params, opt, batch)
        b.record()
        torch.cuda.synchronize()
        out["steps"].append({"ms": a.elapsed_time(b),
                             "loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "launches": _delta(n0),
                             **_exchange_delta(ex0)})
    out["params"] = sum(t.numel() for t in param_leaves(params))
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    out["capacity"] = moe_mod.capacity_for(
        MOE_TRAIN_BATCH * MOE_TRAIN_SEQ // world, cfg.top_k,
        cfg.num_experts, EP_TRAIN_FACTOR)
    return out


def ep_train_bytes(cfg, tp: int, capacity: int) -> int:
    """Wire bytes a rank a training step (bf16) of a config of GQA and MoE
    layers (dbrx-132b's) on a (1, tp) mesh: per MoE layer the two
    all-to-alls forward and their two transposes backward
    (``_ep_a2a_bytes`` each way), the sequence gather of the output
    forward and of the gradients of x and of the routing weights backward
    (ring all-gathers of a rank's B x S/tp rows); the model axis's
    all-reduces of the (B, S, d) activations, forward the embedding's and
    each attention's, backward the gradients of the LM head's input and of
    each attention's (and of K and V where their heads do not split); the
    loss's gather of the row maxima and all-reduce of the sums of
    exponentials and label logits (f32); once a step the sum of the split
    leaves' squares in the clip's norm (an f64 scalar)."""
    lay = tp_layout(cfg, ParallelCtx(tp=tp, use_ep=True))
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_specs())
    b, s = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ
    rows = b * s // tp
    gathers = (tp - 1) * rows * (2 * cfg.d_model + cfg.top_k) * 2
    n = b * s * cfg.d_model
    kv = 0 if lay.kv else 2 * _ring_ar_bytes(
        b * s * cfg.num_kv_heads * cfg.resolved_head_dim, tp)
    model = (2 if lay.vocab else 0) * _ring_ar_bytes(n, tp) + n_attn * (
        2 * _ring_ar_bytes(n, tp) + kv)
    loss = (tp - 1) * b * s * 4 + _ring_bytes(2 * b * s, tp, 4)
    return n_moe * (2 * _ep_a2a_bytes(cfg, tp, capacity) + gathers) \
        + model + loss + (tp - 1) * 8


def phase_ep_training(seed: int) -> dict:
    """Expert-parallel training on 2 gloo ranks sharing the card: dbrx's
    smoke config in f32, one step against the single-card step whose MoE
    layers run the plain emulation (``moe_ep_train_ref``, the same
    capacity drops at 1.25) on the same batch, loss and grad_norm within
    rtol 1e-5; then dbrx-132b at full width, 1 layer, bf16, 5 steps on one
    batch of B 2 x S 256: the loss falls, each step's wire bytes equal
    ``ep_train_bytes``, each rank's launches a step ``train_launches`` (K5
    and K5-bwd on its 8 experts); step ms, exchange, peak memory a rank.
    Returns the launch counts, summed over the ranks."""
    t0 = time.perf_counter()
    small = smoke_config(MOE_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(small, gen, dtype=torch.float32, device=DEVICE)
    batch = next(make_batches(small, EP_TRAIN_SMOKE_BATCH,
                              EP_TRAIN_SMOKE_SEQ, seed=seed))
    real = moe_mod.moe_apply
    dropped = []

    def plain_ep(p, cfg_, x, *, ctx=None, decode=False):
        y, aux, share = moe_mod.moe_ep_train_ref(
            p, cfg_, x, EP_TRAIN_RANKS, EP_TRAIN_FACTOR)
        dropped.append(share)
        return y, aux

    moe_mod.moe_apply = plain_ep
    try:
        _, _, ref = make_train_step(small, TrainConfig(remat=False,
                                                       zero1=False))(
            params, init_opt_state(params), batch)
    finally:
        moe_mod.moe_apply = real
    ref = {k: float(v) for k, v in ref.items()}
    del params
    _release()

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_TRAIN_LAYERS)
    t1 = time.perf_counter()
    ranks = spawn_ranks(ep_training_rank, EP_TRAIN_RANKS, cfg, seed, DEVICE,
                        backend="gloo", timeout_s=900)
    ranks_s = time.perf_counter() - t1
    rel = [{k: abs(r["smoke"][k] - ref[k]) / abs(ref[k])
            for k in ("loss", "grad_norm")} for r in ranks]
    tp = EP_TRAIN_RANKS
    want_bytes = ep_train_bytes(cfg, tp, ranks[0]["capacity"])
    want_launches = train_launches(cfg, 1, False)
    losses = [s["loss"] for s in ranks[0]["steps"]]
    step_ms = [s["ms"] for r in ranks for s in r["steps"]]
    emit({"phase": "ep_training", "arch": cfg.name, "dtype": "bfloat16",
          "layers": cfg.num_layers, "mesh": [1, tp], "backend": "gloo",
          "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ,
          "capacity_factor": EP_TRAIN_FACTOR,
          "capacity": ranks[0]["capacity"], "params_a_rank": ranks[0]["params"],
          "smoke_parity": {"arch": small.name, "dtype": "float32",
                           "rel_err": rel, "ref": ref,
                           "ref_dropped_share": dropped},
          "losses": losses,
          "step_ms": step_ms, "step_ms_p50": float(np.percentile(step_ms, 50)),
          "exchange_s": [s["exchange_s"] for s in ranks[0]["steps"]],
          "wire_bytes": [s["wire_bytes"] for s in ranks[0]["steps"]],
          "want_wire_bytes": want_bytes,
          "staged_bytes": ranks[0]["steps"][0]["staged_bytes"],
          "launches_a_step": [r["steps"][0]["launches"] for r in ranks],
          "want_launches": want_launches,
          "peak_memory_bytes_a_rank": [r["peak_memory_bytes"]
                                       for r in ranks],
          "peak_reserved_bytes_a_rank": [r["peak_reserved_bytes"]
                                         for r in ranks],
          "ranks_s": ranks_s, "seconds": time.perf_counter() - t0})
    check(all(e["loss"] <= 1e-5 and e["grad_norm"] <= 1e-5 for e in rel),
          f"EP training step disagrees with the single-card emulation: "
          f"{rel}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"EP training did not lower the loss: {losses}")
    check(all(s["wire_bytes"] == want_bytes for r in ranks
              for s in r["steps"]),
          f"EP training wire bytes differ from {want_bytes}")
    check(all(s["launches"] == want_launches for r in ranks
              for s in r["steps"]),
          f"EP training launches differ from {want_launches}")
    return _ep_sum(s["launches"] for r in ranks for s in r["steps"])


def run_ep(rng, seed: int) -> dict:
    """The expert-parallel paths (4 gloo ranks on the card, dbrx-132b at
    full width; training on 2); returns each phase's launch counts,
    summed over the ranks."""
    _release()
    counts = {"ep_parity": phase_ep_parity(rng, seed)}
    counts.update(phase_ep_serving(rng, seed + 1))
    counts["ep_training"] = phase_ep_training(seed + 2)
    return counts


# --------------------------------------------------------------------------
# 3e. tensor parallelism (granite-3-8b, full width): 4 gloo ranks on the card
# --------------------------------------------------------------------------

TP_ARCH = "granite-3-8b"
TP_RANKS = 4
TP_PARITY_LAYERS = 2           # f32: 3.2 GB whole, the step's state 4x that
TP_TRAIN_LAYERS = 4            # 1.20 B parameters: AdamW's state fits
TP_BATCH, TP_SEQ = 2, 256      # the prefill: B 2 x S 256
TP_SLOTS = 4
TP_PARITY_STEPS = 8
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 8, 512
TP_TRAIN_MICROBATCHES, TP_TRAIN_STEPS = 2, 5
# the parity step: lr 1e-3 from the first step, as DP_PARITY_TCFG
TP_PARITY_TCFG = dict(microbatches=1, remat=False, learning_rate=1e-3,
                      warmup_steps=1)
# the launcher's defaults (launch.train._train_config), bf16 gradients
TP_TRAIN_TCFG = dict(learning_rate=3e-3, warmup_steps=10,
                     total_steps=TP_TRAIN_STEPS,
                     microbatches=TP_TRAIN_MICROBATCHES, remat=True,
                     grad_dtype="bf16")
# short requests: a decode step is ~81 ring all-reduces over gloo (granite)
# short requests: a TP decode step is ~0.9 s of gloo loopback
TP_REQUESTS = dict(prompt_lens=(4, 8), new_tokens=4, max_len=16)
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_V = 4, 8, 2
PIPE_MB_SHAPE = (1, 256)       # a microbatch: B 1 x S 256 of granite's d
CMM_ROWS = 2 * 256             # x (2 x 256, 4096) against W (4096, 12800/4)


def _tp_ctx(cfg, mesh_shape, **kw):
    mesh_cfg = MeshConfig(tuple(mesh_shape))
    dgroup, mgroup = mesh_groups(mesh_cfg)
    return make_ctx(dgroup, mesh_cfg, model_group=mgroup, cfg=cfg, **kw)


def _ring_bytes(n: int, p: int, itemsize: int) -> int:
    """Wire bytes a rank of ``ring_all_reduce`` of n values over p ranks:
    2 (p - 1) chunks of n / p (padded)."""
    return 2 * (p - 1) * -(-n // p) * itemsize if p > 1 else 0


def tp_forward_bytes(cfg, tp: int, rows: int, seq: int, itemsize: int,
                     gather: bool = True, *, moe=None,
                     capacity: int = 0) -> int:
    """Wire bytes a rank of one forward of ``rows`` x ``seq`` tokens on a
    model axis of ``tp`` (activations of ``itemsize``): the embedding's
    all-reduce of (rows, seq, d) where the vocabulary splits; per layer one
    a row-parallel product (GQA, MLA and cross-attention where their heads
    split, the encoder-decoder's cross block too, the dense FFN, the
    shared experts, the Mamba out-projection) and, for Mamba, the gated
    norm's mean square (f32); per MoE layer, ``moe`` "train" the two
    all-to-alls at ``capacity`` and the sequence gather of the output,
    "decode" the model-axis all-reduce of the tokens (``None``: the MoE
    layers' routed part not counted); with ``gather``, the logits'
    all-gather (serve).  The encoder's are ``tp_encode_bytes``."""
    lay = tp_layout(cfg, ParallelCtx(tp=tp, use_ep=cfg.is_moe))
    n = rows * seq * cfg.d_model

    def ar(m, size=itemsize):
        return _ring_bytes(m, tp, size)

    total = ar(n) if lay.vocab else 0
    for spec in cfg.layer_specs():
        if spec.mixer in ("attn", "cross_attn") and lay.heads:
            cross_block = cfg.is_encoder_decoder and spec.mixer == "attn"
            total += ar(n) * (2 if cross_block else 1)
        if spec.mixer == "mamba" and lay.ssm:
            total += ar(n) + ar(rows * seq, 4)
        if spec.ffn == "dense" and lay.ffn:
            total += ar(n)
        if spec.ffn == "moe":
            total += ar(n) if lay.shared else 0
            if moe == "decode":
                total += ar(n)
            elif moe == "train":
                total += _ep_a2a_bytes(cfg, tp, capacity, itemsize) + \
                    (tp - 1) * rows * (seq // tp) * cfg.d_model * itemsize
    if gather and lay.vocab:
        total += (tp - 1) * rows * seq * (cfg.padded_vocab // tp) * itemsize
    return total


def fsdp_wire_bytes(cfg, params, ctx, microbatches: int, remat: bool,
                    grad_itemsize: int) -> int:
    """Wire bytes a rank of one FSDP training step on a data-only mesh
    (``parallel.fsdp``; ``params``: this rank's shards): (dp - 1) shards
    of each sharded leaf in its unit's ring all-gather at every use (a
    layer's once a microbatch, again in the recompute under ``remat``; the
    embedding also as the tied LM head) and in the ring reduce-scatter of
    its gradient once a forward use; the replicated leaves' gradient
    all-reduce in the planner's buckets (``grad_itemsize``: the synced
    gradient's); the metrics' and the clip norm's gathers of 3 f32 and one
    f64."""
    dp = ctx.dp
    total = 0
    replicated = 0
    for path, t in _with_paths(params):
        if fsdp_mod._dim(ctx, path) is None:
            replicated += t.numel()
            continue
        layer = path.startswith(("/layers/", "/cross/", "/encoder/layers/"))
        uses = 1 + (path == "/embed" and cfg.tie_embeddings)
        shard = (dp - 1) * t.numel() * t.element_size()
        total += microbatches * uses * shard * (
            (2 if layer and remat else 1) + 1)
    for lo in range(0, replicated, BUCKET_VALUES):
        n = min(BUCKET_VALUES, replicated - lo)
        total += 2 * (dp - 1) * -(-n // dp) * grad_itemsize
    return total + (dp - 1) * (3 * 4 + 8)


def tp_encode_bytes(cfg, tp: int, rows: int, itemsize: int) -> int:
    """Wire bytes a rank of one ``encode`` of ``rows`` stub utterances on
    a model axis of ``tp``: each encoder layer's attention and FFN
    all-reduce of (rows, T, d)."""
    lay = tp_layout(cfg, ParallelCtx(tp=tp))
    n = rows * cfg.num_audio_frames * cfg.d_model
    return cfg.encoder_layers * (lay.heads + lay.ffn) * _ring_bytes(
        n, tp, itemsize)


def tp_batcher_run(cfg, params, requests, ctx=None, context=None) -> dict:
    """A ``ContinuousBatcher`` of ``TP_SLOTS`` slots (bf16 cache) over
    ``requests``, one of them admitted mid-flight, over ``context`` (one
    row a slot, for a config with one): every emitted token with the
    logits it was picked from (read where the batcher gathers them,
    ``serve.step.full_logits``), each step's host ms, the launches and
    exchanges of the run."""
    from repro_torch.serve import batcher as batcher_mod
    batcher = ContinuousBatcher(cfg, params, max_slots=TP_SLOTS,
                                max_len=TP_REQUESTS["max_len"],
                                cache_dtype=torch.bfloat16, ctx=ctx,
                                context=context)
    for rid, prompt in enumerate(requests):
        batcher.submit(prompt, TP_REQUESTS["new_tokens"], rid)
    real, seen = batcher_mod.full_logits, {}

    def spy(cfg_, logits, ctx_=None):
        seen["logits"] = real(cfg_, logits, ctx_)
        seen["slots"] = [r.rid if r is not None else None
                         for r in batcher.slot_req]
        return seen["logits"]

    batcher_mod.full_logits = spy
    emitted = {rid: [] for rid in range(len(requests))}
    step_ms = []
    try:
        n0, ex0 = launch_counts(), _exchange()
        while batcher.active:
            t0 = time.perf_counter()
            got = batcher.step()  # ends in a host copy: synced
            step_ms.append(1e3 * (time.perf_counter() - t0))
            for slot, rid in enumerate(seen["slots"]):
                if rid in got:
                    emitted[rid].append(
                        (got[rid], seen["logits"][slot, 0].float().cpu()))
        launched, ex = _delta(n0), _exchange_delta(ex0)
    finally:
        batcher_mod.full_logits = real
    done = {r.rid: r for r in batcher.completed}
    return {"emitted": emitted, "step_ms": step_ms, "launches": launched,
            **ex, "steps": len(step_ms),
            "admitted_at": {r.rid: r.t_admit for r in done.values()},
            "out": {r.rid: r.out for r in done.values()}}


def _batcher_check(got: dict, ref: dict, v: int) -> dict:
    """Each request's tokens against the single-card run's, in order,
    until the first that differs, which must be one where the reference's
    top-2 margin is at most ``EP_MARGIN_ULPS`` bf16 ulps of its top logit
    (after it the request's inputs differ); the max |logit diff| over the
    tokens compared."""
    compared = mismatches = unforced = 0
    diff = 0.0
    for rid, want in ref["emitted"].items():
        for (tok, lg), (wtok, wlg) in zip(got["emitted"][rid], want):
            top = wlg[:v].topk(2).values
            firm = float(top[0] - top[1]) > EP_MARGIN_ULPS * float(
                _ulps_bf16(top[0]))
            diff = max(diff, float((lg[:v] - wlg[:v]).abs().max()))
            if tok != wtok:
                mismatches += firm
                unforced += not firm
                break
            compared += 1
    return {"compared": compared,
            "of": sum(len(e) for e in ref["emitted"].values()),
            "mismatches": mismatches, "unforced_mismatches": unforced,
            "max_abs_logit_diff": diff}


def _tp_params(cfg, seed: int, dtype, ctx, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, dtype=dtype, device=device, ctx=ctx)


def _timed(fn):
    """(fn(), device ms by CUDA events, wall ms) of one call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b), 1e3 * (time.perf_counter() - t0)


def _single_step(cfg, seed: int, tcfg: TrainConfig, batch, dev):
    """The single-card f32 step of ``cfg`` drawn from ``seed`` (gates
    opened) on ``batch``, kept on the host: (the leaves of the initial
    and updated parameters and of m and v, the metrics).  Frees the
    card."""
    p0 = _tp_params(cfg, seed, torch.float32, None, dev)
    open_gates(p0)
    params = _tp_params(cfg, seed, torch.float32, None, dev)
    open_gates(params)
    params, opt, m = make_train_step(cfg, tcfg)(
        params, init_opt_state(params), batch)
    single = ([[x.cpu() for x in param_leaves(t)]
               for t in (p0, params, opt["m"], opt["v"])],
              {k: float(v) for k, v in m.items()})
    del p0, params, opt
    _release()
    return single


def _tp_step_check(cfg, ctx, params, full, single, tcfg: TrainConfig,
                   metrics: dict, dev) -> dict:
    """A mesh's step held to the single-card one (``single``, on rank 0;
    ``None`` on the others): one leaf at a time gathered over the model
    ranks (the parameters and ``full``'s m and v), checksummed and held
    leaf by leaf (m and v within 1e-5 of their max, the parameters through
    their update); loss and grad_norm's relative errors."""
    dims = tp_dims(cfg, ctx)
    sums = {"params": 0, "m": 0, "v": 0}
    errs = {"m": [], "v": [], "update": []}
    leaves = zip(_paths(params), param_leaves(params),
                 param_leaves(full["m"]), param_leaves(full["v"]))
    for i, (path, *mine) in enumerate(leaves):
        whole = [t if dims[path] is None else torch.cat(
            ccl_prim.ring_all_gather(t.contiguous(), ctx.model_group)
            .unbind(0), dim=dims[path]) for t in mine]
        for k, t in zip(sums, whole):
            sums[k] += launch_train.checksum([t])
        if single is not None:
            a0, b, bm, bv = (t[i] for t in single[0])  # host tensors
            errs["m"].append(_leaf_err(whole[1], bm.to(dev), path))
            errs["v"].append(_leaf_err(whole[2], bv.to(dev), path))
            errs["update"].append(_leaf_update(
                a0, whole[0], b, whole[1], whole[2], path, tcfg,
                metrics["lr"]) + (float((whole[0] - b.to(dev)).abs().max()),))
        del whole
    out = {"checksums": sums}
    if single is not None:
        sm = single[1]
        out["rel_err"] = {k: abs(metrics[k] - sm[k]) / abs(sm[k])
                          for k in ("loss", "grad_norm")}
        out["trees"] = {k: _tree_err_of(errs[k]) for k in ("m", "v")}
        out["params"] = {
            **_update_err_of([e[:3] for e in errs["update"]]),
            "max_abs_err": max(e[3] for e in errs["update"])}
    return out


def tp_parity_rank(rank: int, world: int, cfg, seed: int, ref_path: str,
                   device: str) -> dict:
    """f32 (TF32 off), on a (1, 4) and a (2, 2) mesh: this rank's blocks
    drawn from the seed; prefill of its data rank's prompts through
    ``make_prefill(cfg, ctx)`` and 8 teacher-forced decode steps of its
    slots through ``make_serve_step(cfg, ctx)`` against the single-card
    logits; one training step (B 4 x S 256, ZeRO-1 where the data axis has
    2 ranks), its parameters and moments gathered leaf by leaf and
    checksummed.  Rank 0 first runs the single-card step on the whole batch
    (as ``dp_parity_rank``), keeps its result on the host, and holds each
    mesh's step to it leaf by leaf."""
    dev = rank_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(ref_path)
    batch = next(make_batches(cfg, 4, TP_SEQ, seed=seed))
    tcfg = TrainConfig(**TP_PARITY_TCFG)
    # kept on the host: the card holds the ranks' blocks
    single = _single_step(cfg, seed, tcfg, batch, dev) if rank == 0 \
        else None
    dist.barrier()
    out = {}
    for mesh in ((1, world), (2, world // 2)):
        ctx = _tp_ctx(cfg, mesh, remat=False)
        res = {"mesh": list(mesh), "data_rank": ctx.rank}
        torch.cuda.reset_peak_memory_stats()
        params = _tp_params(cfg, seed, torch.float32, ctx, dev)
        rows = slice(ctx.rank * TP_BATCH // ctx.dp,
                     (ctx.rank + 1) * TP_BATCH // ctx.dp)
        slots = slice(ctx.rank * TP_SLOTS // ctx.dp,
                      (ctx.rank + 1) * TP_SLOTS // ctx.dp)
        with torch.no_grad():
            n0, ex0 = launch_counts(), _exchange()
            logits = make_prefill(cfg, ctx)(params,
                                            ref["tokens"][rows].to(dev))
            torch.cuda.synchronize()
            res["prefill"] = {**_logit_err(logits.cpu(), ref["prefill"][rows],
                                           cfg.vocab_size),
                              "launches": _delta(n0),
                              **_exchange_delta(ex0),
                              "checksum": launch_train.checksum([logits])}
            del logits
            n0 = launch_counts()
            got, _ = _ep_teacher_decode(cfg, params,
                                        make_serve_step(cfg, ctx),
                                        ref["fed"][slots], dev)
            res["decode"] = {**_logit_err(got.cpu(), ref["decode"][slots],
                                          cfg.vocab_size),
                             "launches": _delta(n0),
                             "checksum": launch_train.checksum([got])}
            del got
        zero1 = ctx.dp > 1
        opt = init_opt_state(params, ctx if zero1 else None)
        step = make_train_step(cfg, TrainConfig(zero1=zero1,
                                                **TP_PARITY_TCFG), ctx)
        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        (params, opt, m), ms, wall = _timed(lambda: step(params, opt, batch))
        res["step"] = {"device_ms": ms, "wall_ms": wall,
                       "launches": _delta(n0), **_exchange_delta(ex0),
                       "metrics": {k: float(v) for k, v in m.items()}}
        full = gather_opt_state(opt, ctx, params) if zero1 else opt
        del opt
        res["step"].update(_tp_step_check(cfg, ctx, params, full, single,
                                          tcfg, res["step"]["metrics"],
                                          dev))
        del params, full
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        out["x".join(map(str, mesh))] = res
    return out


def phase_tp_parity(rng, seed: int) -> dict:
    """granite-3-8b at full width, 2 layers, f32: TP on 4 ranks against
    the single-card run (freed first) on meshes (1, 4) and (2, 2)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TP_ARCH),
                              num_layers=TP_PARITY_LAYERS)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (TP_BATCH, TP_SEQ)))
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TP_SLOTS, 1)))
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = _tp_reference(cfg, seed, torch.float32, tokens, first)
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="tp_parity_") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save(ref, path)
        ranks = spawn_ranks(tp_parity_rank, TP_RANKS, cfg, seed, path,
                            DEVICE, backend="gloo", timeout_s=900)
    counts = []
    for mesh in ("1x4", "2x2"):
        per = [r[mesh] for r in ranks]
        head = per[0]
        dp, tp = head["mesh"]
        for case in ("prefill", "decode"):
            same = all(len({p[case]["checksum"] for p in per
                            if p["data_rank"] == d}) == 1 for d in range(dp))
            emit({"phase": "tp_parity", "arch": cfg.name, "case": case,
                  "dtype": "float32", "layers": cfg.num_layers,
                  "mesh": head["mesh"], "backend": "gloo",
                  **{k: max(p[case][k] for p in per)
                     for k in ("max_abs_err", "excess")},
                  "greedy_equal": all(p[case]["greedy_equal"] for p in per),
                  "tol": PARITY_TOL, "identical_across_model_ranks": same,
                  "launches_per_rank": [p[case]["launches"] for p in per]})
            check(same, f"tp_parity {mesh} {case}: the ranks of a data "
                        f"index hold different logits")
            check(all(p[case]["excess"] <= 0 for p in per),
                  f"tp_parity {mesh} {case}: beyond {PARITY_TOL}")
            check(all(p[case]["greedy_equal"] for p in per),
                  f"tp_parity {mesh} {case}: greedy tokens differ")
        want = {"flash_attention": cfg.num_layers}
        for p in per:
            check(p["prefill"]["launches"] == want,
                  f"tp_parity {mesh} prefill launched "
                  f"{p['prefill']['launches']}, want {want}")
            check(p["decode"]["launches"] == {},
                  f"tp_parity {mesh} decode launched {p['decode']['launches']}")
            rows = TP_BATCH // dp
            wb = tp_forward_bytes(cfg, tp, rows, TP_SEQ, 4)
            check(p["prefill"]["wire_bytes"] == wb,
                  f"tp_parity {mesh} prefill wire bytes "
                  f"{p['prefill']['wire_bytes']}, want {wb}")
        st = head["step"]
        same = all(p["step"]["checksums"] == st["checksums"] for p in per)
        emit({"phase": "tp_parity", "arch": cfg.name, "case": "train_step",
              "dtype": "float32", "layers": cfg.num_layers,
              "mesh": head["mesh"], "zero1": dp > 1, "batch": 4,
              "seq": TP_SEQ, "metrics": st["metrics"],
              "rel_err": st["rel_err"], "trees": st["trees"],
              "params": st["params"], "identical_on_all_ranks": same,
              "device_ms": [p["step"]["device_ms"] for p in per],
              "wall_ms": [p["step"]["wall_ms"] for p in per],
              "exchange_s": [p["step"]["exchange_s"] for p in per],
              "wire_bytes_per_rank": [p["step"]["wire_bytes"] for p in per],
              "staged_bytes_per_rank": [p["step"]["staged_bytes"]
                                        for p in per],
              "launches_per_rank": [p["step"]["launches"] for p in per],
              "peak_memory_bytes_per_rank": [p["peak_memory_bytes"]
                                             for p in per]})
        check(same, f"tp_parity {mesh}: ranks gathered different parameters")
        check(max(st["rel_err"].values()) <= 1e-4,
              f"tp_parity {mesh}: loss or grad_norm beyond rtol 1e-4 of the "
              f"single-card step: {st['rel_err']}")
        errs = {k: v["err_over_max"] for k, v in st["trees"].items()}
        check(max(errs.values()) <= 1e-5,
              f"tp_parity {mesh}: moments beyond 1e-5 of their max: {errs}")
        check(st["params"]["adamw_over_lr"] <= 1e-3 and
              st["params"]["update_rel_err"] <= 1e-2,
              f"tp_parity {mesh}: parameters off their update: "
              f"{st['params']}")
        want_step = train_launches(cfg, 1, False, TP_SEQ)
        for p in per:
            check(p["step"]["launches"] == want_step,
                  f"tp_parity {mesh} step launched {p['step']['launches']}, "
                  f"want {want_step}")
        counts += [p[k]["launches"] for p in per
                   for k in ("prefill", "decode", "step")]
    emit({"phase": "tp_parity_total", "seconds": time.perf_counter() - t0,
          "reference_s": ref_s,
          "main_process_allocated_bytes": torch.cuda.memory_allocated(),
          "main_process_reserved_bytes": torch.cuda.memory_reserved()})
    return _ep_sum(counts)


# each rank's first prefill in tp_serving: its collectives by kind, their
# result bytes and its wire bytes (what dryrun_card predicts)
TP_SERVING_PREFILL: list = []


def tp_serving_rank(rank: int, world: int, cfg, seed: int, ref_path: str,
                    device: str) -> dict:
    """bf16 on a (1, 4) mesh: prefill B 2 x S 256 through
    ``make_prefill(cfg, ctx)`` (three calls, timed), then the
    ``ContinuousBatcher`` over the requests (``tp_batcher_run``)."""
    dev = rank_device(device)
    ref = torch.load(ref_path)
    ctx = _tp_ctx(cfg, (1, world), remat=False)
    t0 = time.perf_counter()
    params = _tp_params(cfg, seed, torch.bfloat16, ctx, dev)
    out = {"init_s": time.perf_counter() - t0,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in param_leaves(params))}
    torch.cuda.reset_peak_memory_stats()
    prefill = make_prefill(cfg, ctx)
    tokens = ref["tokens"].to(dev)
    out["prefill_ms"], out["prefill_wall_ms"] = [], []
    with torch.no_grad():
        for i in range(3):
            dist.barrier()
            n0, ex0 = launch_counts(), _exchange()
            with record_collectives() if i == 0 else \
                    contextlib.nullcontext() as coll:
                logits, ms, wall = _timed(lambda: prefill(params, tokens))
            out["prefill_ms"].append(ms)
            out["prefill_wall_ms"].append(wall)
            if i == 0:  # the first call's, which dryrun_card predicts
                out["prefill"] = {"launches": _delta(n0),
                                  **_exchange_delta(ex0),
                                  "collectives": {
                                      "count": coll.count_by_kind,
                                      "bytes": coll.bytes_by_kind,
                                      "sent": coll.sent_bytes}}
        out["prefill_tokens"] = _token_check(
            logits[:, -1:].cpu(), {"decode": ref["prefill"][:, -1:]},
            slice(None), cfg.vocab_size)
        out["prefill_max_abs_logit_diff"] = float(
            (logits.float().cpu() - ref["prefill"].float())[
                ..., :cfg.vocab_size].abs().max())
        del logits
        dist.barrier()
        out["batcher"] = tp_batcher_run(cfg, params, ref["requests"], ctx)
    out["batcher"]["check"] = _batcher_check(out["batcher"], ref["batcher"],
                                             cfg.vocab_size)
    out["batcher"]["emitted"] = None  # held to the reference here
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_tp_serving(rng, seed: int) -> dict:
    """granite-3-8b at full width and depth (40 layers, 16.75 GB in bf16),
    bf16: the single-card run (freed first), then TP serving on (1, 4)."""
    t0 = time.perf_counter()
    cfg = get_config(TP_ARCH)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (TP_BATCH, TP_SEQ)))
    requests = _tp_requests(rng, cfg)
    ref = _tp_reference(cfg, seed, torch.bfloat16, tokens,
                        requests=requests)
    ref["requests"] = requests
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="tp_serving_") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save(ref, path)
        t1 = time.perf_counter()
        ranks = spawn_ranks(tp_serving_rank, TP_RANKS, cfg, seed, path,
                            DEVICE, backend="gloo", timeout_s=900)
        ranks_s = time.perf_counter() - t1
    head = ranks[0]
    tp = TP_RANKS
    TP_SERVING_PREFILL[:] = [dict(r["prefill"]["collectives"],
                                  wire_bytes=r["prefill"]["wire_bytes"])
                             for r in ranks]
    steps = head["batcher"]["steps"]
    step_ms = [m for r in ranks for m in r["batcher"]["step_ms"]]
    want_prefill_bytes = tp_forward_bytes(cfg, tp, TP_BATCH, TP_SEQ, 2)
    want_decode_bytes = steps * tp_forward_bytes(cfg, tp, TP_SLOTS, 1, 2)
    emit({"phase": "tp_serving", "arch": cfg.name, "dtype": "bfloat16",
          "layers": cfg.num_layers, "mesh": [1, tp], "backend": "gloo",
          "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
          "init_s_per_rank": [r["init_s"] for r in ranks],
          "prefill_batch": TP_BATCH, "prefill_seq": TP_SEQ,
          "prefill_device_ms": [r["prefill_ms"] for r in ranks],
          "prefill_wall_ms": [r["prefill_wall_ms"] for r in ranks],
          "prefill_exchange_s": [r["prefill"]["exchange_s"] for r in ranks],
          "prefill_wire_bytes": [r["prefill"]["wire_bytes"] for r in ranks],
          "prefill_wire_bytes_formula": want_prefill_bytes,
          "prefill_staged_bytes": [r["prefill"]["staged_bytes"]
                                   for r in ranks],
          "prefill_tokens": head["prefill_tokens"],
          "prefill_max_abs_logit_diff": [r["prefill_max_abs_logit_diff"]
                                         for r in ranks],
          "slots": TP_SLOTS, "requests": len(requests), "steps": steps,
          "admitted_at": head["batcher"]["admitted_at"],
          "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
          "decode_step_ms_p99": float(np.percentile(step_ms, 99)),
          "single_card_step_ms_p50": float(np.percentile(
              ref["batcher"]["step_ms"], 50)),
          "decode_exchange_s": [r["batcher"]["exchange_s"] for r in ranks],
          "decode_wire_bytes": [r["batcher"]["wire_bytes"] for r in ranks],
          "decode_wire_bytes_formula": want_decode_bytes,
          "decode_staged_bytes": [r["batcher"]["staged_bytes"]
                                  for r in ranks],
          "tokens": [r["batcher"]["check"] for r in ranks],
          "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                         for r in ranks],
          "launches_per_rank": {"prefill": [r["prefill"]["launches"]
                                            for r in ranks],
                                "batcher": [r["batcher"]["launches"]
                                            for r in ranks]},
          "reference_s": ref_s, "ranks_s": ranks_s})
    want = {"flash_attention": cfg.num_layers}
    for r in ranks:
        check(r["prefill"]["launches"] == want,
              f"tp_serving prefill launched {r['prefill']['launches']}, "
              f"want {want}")
        check(r["batcher"]["launches"] == {},
              f"tp_serving decode launched {r['batcher']['launches']}")
        check(r["prefill"]["wire_bytes"] == want_prefill_bytes,
              f"tp_serving prefill wire bytes {r['prefill']['wire_bytes']},"
              f" want {want_prefill_bytes}")
        check(r["batcher"]["wire_bytes"] == want_decode_bytes,
              f"tp_serving decode wire bytes {r['batcher']['wire_bytes']}, "
              f"want {want_decode_bytes}")
        check(r["batcher"]["check"]["mismatches"] == 0,
              f"tp_serving: tokens differ from the single-card run where "
              f"its margin exceeds {EP_MARGIN_ULPS} bf16 ulps: "
              f"{r['batcher']['check']}")
        check(r["prefill_tokens"]["mismatches"] == 0,
              f"tp_serving prefill tokens: {r['prefill_tokens']}")
        check(r["batcher"]["out"] == head["batcher"]["out"],
              "tp_serving: the ranks emitted different tokens")
    check(any(t > 0 for t in head["batcher"]["admitted_at"].values()),
          "tp_serving: no request was admitted mid-flight")
    emit({"phase": "tp_serving_total", "seconds": time.perf_counter() - t0})
    return _ep_sum([r[k]["launches"] for r in ranks
                    for k in ("prefill", "batcher")])


def _tp_requests(rng, cfg) -> list:
    lo, hi = TP_REQUESTS["prompt_lens"]
    return [list(map(int, rng.integers(0, cfg.vocab_size, n)))
            for n in rng.integers(lo, hi + 1, 6)]


def tp_mamba_rank(rank: int, world: int, cfg, seed: int, ref_path: str,
                  device: str) -> dict:
    """mamba2-130m on a (1, 4) mesh (6 of its 24 SSD heads a rank): f32
    prefill and teacher-forced decode against the single-card run, then
    bf16 serving, prefill and the ``ContinuousBatcher``."""
    dev = rank_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = torch.load(ref_path)
    ctx = _tp_ctx(cfg, (1, world), remat=False)
    out = {}
    ref = refs["f32"]
    params = _tp_params(cfg, seed, torch.float32, ctx, dev)
    with torch.no_grad():
        n0, ex0 = launch_counts(), _exchange()
        logits, ms, wall = _timed(lambda: make_prefill(cfg, ctx)(
            params, ref["tokens"].to(dev)))
        out["prefill"] = {**_logit_err(logits.cpu(), ref["prefill"],
                                       cfg.vocab_size),
                          "launches": _delta(n0), **_exchange_delta(ex0),
                          "device_ms": ms, "wall_ms": wall}
        del logits
        n0 = launch_counts()
        got, ms = _ep_teacher_decode(cfg, params, make_serve_step(cfg, ctx),
                                     ref["fed"], dev)
        out["decode"] = {**_logit_err(got.cpu(), ref["decode"],
                                      cfg.vocab_size),
                         "launches": _delta(n0), "step_ms": ms}
    del params, got
    _release()
    ref = refs["bf16"]
    params = _tp_params(cfg, seed, torch.bfloat16, ctx, dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        logits, ms, wall = _timed(lambda: make_prefill(cfg, ctx)(
            params, ref["tokens"].to(dev)))
        out["serve_prefill"] = {"launches": _delta(n0),
                                **_exchange_delta(ex0), "device_ms": ms,
                                "wall_ms": wall,
                                "max_abs_logit_diff": float(
                                    (logits.float().cpu()
                                     - ref["prefill"].float())[
                                        ..., :cfg.vocab_size].abs().max())}
        del logits
        dist.barrier()
        out["batcher"] = tp_batcher_run(cfg, params, refs["requests"], ctx)
    out["batcher"]["check"] = _batcher_check(out["batcher"], ref["batcher"],
                                             cfg.vocab_size)
    out["batcher"]["emitted"] = None
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_tp_mamba(rng, seed: int) -> dict:
    """mamba2-130m at full size on (1, 4): f32 parity, then bf16
    serving, against single-card runs (made first)."""
    t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (TP_BATCH, TP_SEQ)))
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TP_SLOTS, 1)))
    requests = _tp_requests(rng, cfg)
    refs = {"f32": _tp_reference(cfg, seed, torch.float32, tokens, first),
            "bf16": _tp_reference(cfg, seed, torch.bfloat16, tokens,
                                  requests=requests),
            "requests": requests}
    with tempfile.TemporaryDirectory(prefix="tp_mamba_") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save(refs, path)
        ranks = spawn_ranks(tp_mamba_rank, TP_RANKS, cfg, seed, path,
                            DEVICE, backend="gloo", timeout_s=900)
    head = ranks[0]
    tp = TP_RANKS
    step_ms = [m for r in ranks for m in r["batcher"]["step_ms"]]
    emit({"phase": "tp_mamba", "arch": cfg.name, "layers": cfg.num_layers,
          "mesh": [1, tp], "backend": "gloo",
          "ssd_heads_per_rank": cfg.ssm_num_heads // tp,
          "f32": {k: {kk: max(r[k][kk] for r in ranks)
                      for kk in ("max_abs_err", "excess")}
                  for k in ("prefill", "decode")},
          "greedy_equal": all(r[k]["greedy_equal"] for r in ranks
                              for k in ("prefill", "decode")),
          "tol": PARITY_TOL,
          "f32_prefill_device_ms": [r["prefill"]["device_ms"]
                                    for r in ranks],
          "f32_prefill_wire_bytes": [r["prefill"]["wire_bytes"]
                                     for r in ranks],
          "bf16_prefill_device_ms": [r["serve_prefill"]["device_ms"]
                                     for r in ranks],
          "bf16_prefill_wall_ms": [r["serve_prefill"]["wall_ms"]
                                   for r in ranks],
          "bf16_prefill_max_abs_logit_diff": [
              r["serve_prefill"]["max_abs_logit_diff"] for r in ranks],
          "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
          "decode_step_ms_p99": float(np.percentile(step_ms, 99)),
          "single_card_step_ms_p50": float(np.percentile(
              refs["bf16"]["batcher"]["step_ms"], 50)),
          "decode_wire_bytes": [r["batcher"]["wire_bytes"] for r in ranks],
          "decode_staged_bytes": [r["batcher"]["staged_bytes"]
                                  for r in ranks],
          "tokens": [r["batcher"]["check"] for r in ranks],
          "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                         for r in ranks],
          "launches_per_rank": [r["prefill"]["launches"] for r in ranks]})
    want = {k: n for k, n in prefill_launches(cfg).items() if n}
    for r in ranks:
        for k in ("prefill", "decode"):
            check(r[k]["excess"] <= 0 and r[k]["greedy_equal"],
                  f"tp_mamba f32 {k}: beyond {PARITY_TOL} or greedy tokens "
                  f"differ: {r[k]}")
        for k in ("prefill", "serve_prefill"):
            check(r[k]["launches"] == want,
                  f"tp_mamba {k} launched {r[k]['launches']}, want {want}")
        check(r["decode"]["launches"] == {} and
              r["batcher"]["launches"] == {},
              "tp_mamba decode launched a kernel")
        wb = tp_forward_bytes(cfg, tp, TP_BATCH, TP_SEQ, 4)
        check(r["prefill"]["wire_bytes"] == wb,
              f"tp_mamba prefill wire bytes {r['prefill']['wire_bytes']}, "
              f"want {wb}")
        wb = head["batcher"]["steps"] * tp_forward_bytes(cfg, tp, TP_SLOTS,
                                                         1, 2)
        check(r["batcher"]["wire_bytes"] == wb,
              f"tp_mamba decode wire bytes {r['batcher']['wire_bytes']}, "
              f"want {wb}")
        check(r["batcher"]["check"]["mismatches"] == 0,
              f"tp_mamba: tokens differ from the single-card run: "
              f"{r['batcher']['check']}")
        check(r["batcher"]["out"] == head["batcher"]["out"],
              "tp_mamba: the ranks emitted different tokens")
    emit({"phase": "tp_mamba_total", "seconds": time.perf_counter() - t0})
    return _ep_sum([r[k]["launches"] for r in ranks
                    for k in ("prefill", "decode", "serve_prefill",
                              "batcher")])


# tp_training's seed, first step's loss and grad_norm, wire bytes and
# peaks a rank: the ZeRO-1 step that fsdp_tp is held to
TP_TRAINING_FIRST: dict = {}


def tp_training_rank(rank: int, world: int, cfg, seed: int,
                     device: str) -> dict:
    """bf16 ZeRO-1 training on a (2, 2) mesh: 5 steps of
    ``make_train_step`` on one batch of B 8 x S 512 in 2 microbatches,
    remat, bf16 gradients; a step's wall, compute (its start to the local
    gradient, CUDA events) and exchange time, wire and staged bytes and
    launches."""
    dev = rank_device(device)
    ctx = _tp_ctx(cfg, (2, world // 2), remat=True)
    tcfg = TrainConfig(**TP_TRAIN_TCFG)
    params = _tp_params(cfg, seed, torch.bfloat16, ctx, dev)
    opt = init_opt_state(params, ctx)
    step = make_train_step(cfg, tcfg, ctx)
    batch = next(make_batches(cfg, TP_TRAIN_BATCH, TP_TRAIN_SEQ, seed=seed))
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(TP_TRAIN_STEPS):
        marks = {}

        def hook(stage, grads):
            if stage == "local":
                marks["local"] = torch.cuda.Event(enable_timing=True)
                marks["local"].record()

        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        marks["start"] = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks["start"].record()
        params, opt, m = step(params, opt, batch, grad_hook=hook)
        torch.cuda.synchronize()
        steps.append({"wall_ms": 1e3 * (time.perf_counter() - t0),
                      "compute_ms": marks["start"].elapsed_time(
                          marks["local"]),
                      "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "launches": _delta(n0), **_exchange_delta(ex0)})
    return {"steps": steps,
            "params": sum(t.numel() for t in param_leaves(params)),
            "opt_state_bytes": 2 * 4 * opt["m"].numel(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_tp_training(seed: int) -> dict:
    """granite-3-8b at full width, 4 layers, bf16, ZeRO-1 on (2, 2)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TP_ARCH),
                              num_layers=TP_TRAIN_LAYERS)
    ranks = spawn_ranks(tp_training_rank, TP_RANKS, cfg, seed, DEVICE,
                        backend="gloo", timeout_s=900)
    head = ranks[0]
    TP_TRAINING_FIRST.update(
        seed=seed, metrics={k: head["steps"][0][k]
                            for k in ("loss", "grad_norm")},
        wire_bytes=[r["steps"][0]["wire_bytes"] for r in ranks],
        peak_memory_bytes=[r["peak_memory_bytes"] for r in ranks])
    losses = [s["loss"] for s in head["steps"]]
    wall = [s["wall_ms"] for r in ranks for s in r["steps"][1:]]
    emit({"phase": "tp_training", "arch": cfg.name, "dtype": "bfloat16",
          "layers": cfg.num_layers, "params": cfg.param_counts()["total"],
          "mesh": [2, TP_RANKS // 2], "backend": "gloo", "zero1": True,
          "batch": TP_TRAIN_BATCH, "seq": TP_TRAIN_SEQ,
          "microbatches": TP_TRAIN_MICROBATCHES, "remat": True,
          "losses": losses,
          "step_wall_ms_p50": float(np.percentile(wall, 50)),
          "compute_ms": [[s["compute_ms"] for s in r["steps"]]
                         for r in ranks],
          "exchange_s": [[s["exchange_s"] for s in r["steps"]]
                         for r in ranks],
          "wire_bytes_per_step": [r["steps"][-1]["wire_bytes"]
                                  for r in ranks],
          "staged_bytes_per_step": [r["steps"][-1]["staged_bytes"]
                                    for r in ranks],
          "params_per_rank": [r["params"] for r in ranks],
          "opt_state_bytes_per_rank": [r["opt_state_bytes"] for r in ranks],
          "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                         for r in ranks],
          "launches_per_rank_step": [r["steps"][-1]["launches"]
                                     for r in ranks],
          "seconds": time.perf_counter() - t0})
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"tp_training: the loss did not fall: {losses}")
    want = train_launches(cfg, TP_TRAIN_MICROBATCHES, True, TP_TRAIN_SEQ)
    for r in ranks:
        check(len({json.dumps([s["loss"] for s in r["steps"]])}) == 1 and
              [s["loss"] for s in r["steps"]] == losses,
              "tp_training: the ranks' losses differ")
        for s in r["steps"]:
            check(s["launches"] == want,
                  f"tp_training step launched {s['launches']}, want {want}")
    return _ep_sum([s["launches"] for r in ranks for s in r["steps"]])


def tp_cmm_pipeline_rank(rank: int, world: int, cfg, seed: int,
                         device: str) -> dict:
    """Collective matmul at granite's FFN shape in f32 (TF32 off):
    ``ag_matmul`` of this rank's rows of x (2 x 256, 4096) against its
    column block of W (4096, 12800/4), against the bulk all-gather then
    one product; ``matmul_rs`` of its contraction block of x (2 x 256,
    12800) against its rows of W (12800, 4096), against one product then
    the bulk ``ring_reduce_scatter``; seconds (median of 5) and bytes of
    each.  Then the pipelines, each stage a granite layer at full width
    (f32), 8 microbatches of B 1 x S 256: GPipe (4 stages) and the
    interleaved schedule (v = 2, 8 layers), the outputs and each rank's
    layers' gradients of sum(y^2) against the sequential composition of
    the layers on this rank (drawn again from the same seeds)."""
    from repro_torch.models.transformer import _apply_layer, _init_layer
    from repro_torch.parallel.collective_matmul import ag_matmul, matmul_rs
    from repro_torch.parallel.pipeline import (bubble_fraction,
                                               interleaved_pipeline_apply,
                                               pipeline_apply)
    dev = rank_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    d, ff = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((CMM_ROWS, d), generator=gen, device=dev)
    w = torch.randn((d, ff // world), generator=gen, device=dev) / d ** 0.5
    x2 = torch.randn((CMM_ROWS, ff // world), generator=gen, device=dev)
    w2 = torch.randn((ff // world, d), generator=gen, device=dev) / ff ** 0.5
    mb = CMM_ROWS // world
    xl = x[rank * mb:(rank + 1) * mb]
    fns = {"ag_matmul": lambda: ag_matmul(xl, w),
           "bulk_all_gather_matmul": lambda: ccl_prim.ring_all_gather(
               xl).flatten(0, 1) @ w,
           "matmul_rs": lambda: matmul_rs(x2, w2),
           "matmul_bulk_reduce_scatter": lambda: ccl_prim.ring_reduce_scatter(
               (x2 @ w2).view(world, mb, d))}
    got = {}
    for name, fn in fns.items():
        secs = []
        for i in range(5):
            dist.barrier()
            ex0 = _exchange()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                out[name] = _exchange_delta(ex0)
        out[name]["seconds_median"] = float(np.median(secs))
    for a, b in (("ag_matmul", "bulk_all_gather_matmul"),
                 ("matmul_rs", "matmul_bulk_reduce_scatter")):
        out[a]["max_abs_err"] = float((got[a] - got[b]).abs().max())
        out[a]["max_abs"] = float(got[b].abs().max())
    del x, w, x2, w2, got, xl
    _release()

    spec = cfg.layer_specs()[0]
    s = PIPE_MB_SHAPE[1]
    positions = torch.arange(s, device=dev)

    def stage_fn(lp, h):
        return _apply_layer(lp, spec, cfg, h, positions, None)[0]

    def layer(k):  # virtual stage k's layer, from its own seed
        g = torch.Generator(device=dev).manual_seed(seed + 100 + k)
        return _init_layer(cfg, spec, torch.float32, dev, g)

    x_mb = torch.randn((PIPE_MICROBATCHES, *PIPE_MB_SHAPE, d),
                       generator=gen, device=dev)
    # untimed: the first backward of a process loads its kernels, and
    # gloo connects a pair of ranks at its first send (the rings so far
    # sent only to the right)
    lp = tree_map(lambda t: t.requires_grad_(True), layer(rank))
    (pipeline_apply(stage_fn, lp, x_mb[:2]) ** 2).sum().backward()
    del lp
    for name, v in (("gpipe", 1), ("interleaved", PIPE_V)):
        ks = [rank + world * c for c in range(v)]  # this rank's stages
        mine = [tree_map(lambda t: t.requires_grad_(True), layer(k))
                for k in ks]
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if v == 1:
            y = pipeline_apply(stage_fn, mine[0], x_mb)
        else:
            y = interleaved_pipeline_apply(stage_fn, _stack_trees(mine),
                                           x_mb, v=v)
        torch.cuda.synchronize()
        res = {"forward_s": time.perf_counter() - t0,
               "forward": {**_exchange_delta(ex0), "launches": _delta(n0)}}
        n0, ex0 = launch_counts(), _exchange()
        t0 = time.perf_counter()
        (y ** 2).sum().backward()
        torch.cuda.synchronize()
        res.update(backward_s=time.perf_counter() - t0,
                   backward={**_exchange_delta(ex0), "launches": _delta(n0)},
                   bubble_fraction=bubble_fraction(world, PIPE_MICROBATCHES,
                                                   v),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
        grads = [[t.grad for t in param_leaves(lp)] for lp in mine]
        y = y.detach()
        del mine
        _release()
        # the sequential composition of the v p layers, on this rank
        ref, kept = x_mb.flatten(0, 1), {}
        for k in range(world * v):
            lp = layer(k)
            if k in ks:
                kept[k] = tree_map(lambda t: t.requires_grad_(True), lp)
                lp = kept[k]
            ref = stage_fn(lp, ref)
        ref = ref.view_as(y)
        (ref ** 2).sum().backward()
        res["y_max_abs_err"] = float((y - ref.detach()).abs().max())
        res["y_max_abs"] = float(ref.detach().abs().max())
        res["grad_max_rel_err"] = max(
            float((g - t.grad).abs().max())
            / max(float(t.grad.abs().max()), 1e-30)
            for k, gs in zip(ks, grads)
            for g, t in zip(gs, param_leaves(kept[k])))
        del ref, kept, grads, y
        _release()
        out[name] = res
    return out


def _stack_trees(trees: list):
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading dim (the chunk dim of ``interleaved_pipeline_apply``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def phase_tp_cmm_pipeline(seed: int) -> dict:
    """Collective matmul at granite's FFN shape and the two pipelines of
    granite layers, 4 gloo ranks on the card."""
    t0 = time.perf_counter()
    cfg = get_config(TP_ARCH)
    ranks = spawn_ranks(tp_cmm_pipeline_rank, TP_RANKS, cfg, seed, DEVICE,
                        backend="gloo", timeout_s=900)
    p = TP_RANKS
    for name in ("ag_matmul", "matmul_rs"):
        bulk = {"ag_matmul": "bulk_all_gather_matmul",
                "matmul_rs": "matmul_bulk_reduce_scatter"}[name]
        emit({"phase": "cmm", "fn": name, "dtype": "float32",
              "x": [CMM_ROWS, cfg.d_model if name == "ag_matmul"
                    else cfg.d_ff], "ranks": p, "backend": "gloo",
              "seconds_median": [r[name]["seconds_median"] for r in ranks],
              "bulk_seconds_median": [r[bulk]["seconds_median"]
                                      for r in ranks],
              "wire_bytes": [r[name]["wire_bytes"] for r in ranks],
              "bulk_wire_bytes": [r[bulk]["wire_bytes"] for r in ranks],
              "staged_bytes": [r[name]["staged_bytes"] for r in ranks],
              "max_abs_err": max(r[name]["max_abs_err"] for r in ranks),
              "max_abs": max(r[name]["max_abs"] for r in ranks)})
        for r in ranks:
            check(r[name]["max_abs_err"] <= 1e-4 * max(r[name]["max_abs"],
                                                       1.0),
                  f"cmm {name}: beyond 1e-4 of the bulk form: {r[name]}")
        # p - 1 hops of a (rows/p, d) block: x's rows, an output's rows
        want = (p - 1) * (CMM_ROWS // p) * cfg.d_model * 4
        for r in ranks:
            check(r[name]["wire_bytes"] == want,
                  f"cmm {name} wire bytes {r[name]['wire_bytes']}, want "
                  f"{want}")
    counts = []
    act = math.prod(PIPE_MB_SHAPE) * cfg.d_model * 4
    for name, v in (("gpipe", 1), ("interleaved", PIPE_V)):
        per = [r[name] for r in ranks]
        emit({"phase": "pipeline", "schedule": name, "arch": cfg.name,
              "stages": p, "v": v, "layers": p * v, "dtype": "float32",
              "microbatches": PIPE_MICROBATCHES,
              "microbatch": list(PIPE_MB_SHAPE), "backend": "gloo",
              "bubble_fraction": per[0]["bubble_fraction"],
              "forward_s": [q["forward_s"] for q in per],
              "backward_s": [q["backward_s"] for q in per],
              "forward_wire_bytes": [q["forward"]["wire_bytes"]
                                     for q in per],
              "backward_wire_bytes": [q["backward"]["wire_bytes"]
                                      for q in per],
              "staged_bytes": [q["forward"]["staged_bytes"]
                               + q["backward"]["staged_bytes"]
                               for q in per],
              "y_max_abs_err": max(q["y_max_abs_err"] for q in per),
              "grad_max_rel_err": max(q["grad_max_rel_err"] for q in per),
              "peak_memory_bytes_per_rank": [q["peak_memory_bytes"]
                                             for q in per],
              "launches_per_rank": [{"forward": q["forward"]["launches"],
                                     "backward": q["backward"]["launches"]}
                                    for q in per]})
        for q in per:
            check(q["y_max_abs_err"] <= PARITY_TOL["atol"] + PARITY_TOL[
                "rtol"] * q["y_max_abs"],
                  f"pipeline {name}: outputs off the sequential model "
                  f"beyond {PARITY_TOL}: {q['y_max_abs_err']}")
            check(q["grad_max_rel_err"] <= 1e-4,
                  f"pipeline {name}: gradients off the sequential model: "
                  f"{q['grad_max_rel_err']}")
            n = PIPE_MICROBATCHES * v
            want_f = {"flash_attention": n}
            want_b = {"flash_attention_bwd": n * FA_BWD_LAUNCHES}
            check(q["forward"]["launches"] == want_f and
                  q["backward"]["launches"] == want_b,
                  f"pipeline {name} launched {q['forward']['launches']}, "
                  f"{q['backward']['launches']}; want {want_f}, {want_b}")
            counts += [q["forward"]["launches"], q["backward"]["launches"]]
        if v == 1:  # GPipe: M sends a boundary each way, the outputs' psum
            ar = _ring_bytes(PIPE_MICROBATCHES * act // 4, p, 4)
            for r_, q in enumerate(per):
                fw = (PIPE_MICROBATCHES * act if r_ < p - 1 else 0) + ar
                bw = PIPE_MICROBATCHES * act if r_ > 0 else 0
                check(q["forward"]["wire_bytes"] == fw and
                      q["backward"]["wire_bytes"] == bw,
                      f"pipeline gpipe rank {r_} wire bytes "
                      f"{q['forward']['wire_bytes']}, "
                      f"{q['backward']['wire_bytes']}; want {fw}, {bw}")
    emit({"phase": "cmm_pipeline_total",
          "seconds": time.perf_counter() - t0})
    return _ep_sum(counts)


def run_tp(rng, seed: int) -> dict:
    """The tensor-parallel paths (4 gloo ranks on the card): granite-3-8b
    at full width (2 layers for parity, all 40 for serving, 4 for
    training), mamba2-130m whole, collective matmul and the pipelines;
    returns each phase's launch counts, summed over the ranks."""
    _release()
    counts = {"tp_parity": phase_tp_parity(rng, seed)}
    counts["tp_serving"] = phase_tp_serving(rng, seed + 1)
    counts["tp_mamba"] = phase_tp_mamba(rng, seed + 2)
    counts["tp_training"] = phase_tp_training(seed + 3)
    counts["pipeline"] = phase_tp_cmm_pipeline(seed + 4)
    return counts


# --------------------------------------------------------------------------
# 3f. the model axis of MLA, cross-attention and the encoder-decoder
# (deepseek-v2-236b beside expert parallelism, llama-3.2-vision-90b,
# seamless-m4t-medium, full width): 4 gloo ranks on the card
# --------------------------------------------------------------------------

# phase -> (arch, layers kept (0: all), prefill S, bf16 serving, step mesh)
TPF_PHASES = {"tp_mla": (MLA_ARCH, MLA_LAYERS, 256, False, None),
              "tp_cross": (VISION_ARCH, VISION_LAYERS, 256, True, None),
              # 6 + 6 of its 12 + 12 layers: the script's time limit
              "tp_encdec": (ENC_DEC_ARCH, 6, 1024, False, (2, 2))}
TPF_STEP_BATCH, TPF_STEP_SEQ = 4, 256


def _tpf_config(name: str):
    arch, layers, _, _, _ = TPF_PHASES[name]
    cfg = get_config(arch)
    if not layers:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers, **(
        {"encoder_layers": layers} if cfg.is_encoder_decoder else {}))


def _tpf_ctx(cfg, mesh_shape):
    """A rank's context: the model axis, and for a MoE config expert
    parallelism beside it at capacity factor E / top_k (a shard's
    capacity is its token count: no dispatch dropped, as in the dense
    single-card run)."""
    kw = {}
    if cfg.is_moe:
        f = cfg.num_experts / cfg.top_k
        kw = dict(capacity_factor=f, decode_capacity_factor=f)
    return _tp_ctx(cfg, mesh_shape, remat=False, **kw)


def _tpf_params(cfg, seed: int, dtype, ctx, device):
    """This rank's part of the draw from ``seed`` (the whole draw without
    ``ctx``), its cross-attention gates opened."""
    params = _tp_params(cfg, seed, dtype, ctx, device)
    open_gates(params)
    return params


def _tpf_context(cfg, params, seed: int, rows, ctx=None):
    """The context of ``rows`` of the stub's ``TP_SLOTS`` utterances or
    images: the frames encoded on this rank's heads (``ctx``), or the
    patches; ``None`` for a config without one."""
    frames = stub_frames(cfg, params, TP_SLOTS, seed)
    if frames is None:
        return None
    frames = frames[rows]
    return encode(cfg, params, frames, ctx=ctx) if cfg.is_encoder_decoder \
        else frames


# a token whose k-th and (k+1)-th router logits lie this close may take
# another expert under the rounding of the model axis's sums (~1e-5 of the
# router's input): the single-card reference is re-run with the experts
# the model-axis run took there (``_forced_routes``), and the ties counted
ROUTER_TIE = 1e-3


def _router_gap(p, cfg_, x):
    """Each token's gap between its k-th and (k+1)-th router logits."""
    top = (x.float() @ p["router"]).topk(cfg_.top_k + 1, dim=-1).values
    return top[..., -2] - top[..., -1]


def _router_gaps(run):
    """``run()`` with ``models.moe.route`` recording each call's router gap
    of every token (``_router_gap``) and the experts it picked: (the
    result, the gaps and the picks of every call on the host, in order;
    empty without MoE layers)."""
    real, gaps, picks = moe_mod.route, [], []

    def recording(p, cfg_, x, ctx=None):
        gaps.append(_router_gap(p, cfg_, x).cpu())
        ids, weights, aux = real(p, cfg_, x, ctx)
        picks.append(ids.cpu())
        return ids, weights, aux

    moe_mod.route = recording
    try:
        return run(), gaps, picks
    finally:
        moe_mod.route = real


def _forced_routes(run, picks):
    """``run()`` with the i-th call of ``models.moe.route`` taking, at each
    token whose own router gap is below ``ROUTER_TIE``, the experts
    ``picks[i]`` holds there (those a model-axis run took), their weights
    the softmax of the call's own logits over them, normalised as
    ``route`` normalises its own; every other token keeps its own experts
    and weights.  Returns (the result, the tokens whose experts changed)."""
    real, calls, changed = moe_mod.route, iter(picks), [0]

    def forcing(p, cfg_, x, ctx=None):
        ids, weights, aux = real(p, cfg_, x, ctx)
        want = next(calls).to(ids.device)
        tie = (_router_gap(p, cfg_, x) < ROUTER_TIE)[..., None]
        new = torch.where(tie, want, ids)
        w = torch.softmax(x.float() @ p["router"], dim=-1).gather(-1, new)
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        changed[0] += int((new.sort(-1).values != ids.sort(-1).values)
                          .any(-1).sum())
        return new, torch.where(tie, w.to(x.dtype), weights), aux

    moe_mod.route = forcing
    try:
        out = run()
    finally:
        moe_mod.route = real
    if next(calls, None) is not None:
        raise ValueError("the forced run called route fewer times than "
                         "the run whose picks it takes")
    return out, changed[0]


def _ties(gap):
    """The positions of a reference whose router gap is below
    ``ROUTER_TIE`` (``None`` without MoE layers)."""
    return None if gap is None else gap < ROUTER_TIE


def _tp_reference(cfg, seed: int, dtype, tokens, first=None,
                  requests=None) -> dict:
    """The single-card run of ``cfg`` from ``seed`` (gates opened) over
    the stub context (for a config with one): prefill logits of
    ``tokens`` (its first rows of the context) and each token's router
    gap (``_router_gaps``, the least over the MoE layers); with ``first``
    ``TP_PARITY_STEPS`` greedy decode steps of ``TP_SLOTS`` slots from it
    (the tokens fed kept, to teacher-force the ranks) and their router
    gaps; with ``requests`` a ``ContinuousBatcher`` run over them
    (``tp_batcher_run``).  Host tensors; frees the card."""
    params = _tpf_params(cfg, seed, dtype, None, DEVICE)
    out = {"tokens": tokens}
    with torch.no_grad():
        context = _tpf_context(cfg, params, seed, slice(0, len(tokens)))
        logits, gaps, _ = _router_gaps(lambda: make_prefill(cfg)(
            params, tokens.to(DEVICE), context))
        out["prefill"] = logits.cpu()
        out["prefill_gap"] = torch.stack(gaps).amin(0) if gaps else None
        del context, logits
        context = _tpf_context(cfg, params, seed, slice(None))
        if first is not None:
            serve = make_serve_step(cfg)
            cache = init_cache(cfg, params, TP_SLOTS, TP_PARITY_STEPS,
                               dtype=dtype, context=context)
            tok, fed, logits = first.to(DEVICE), [first], []

            def decode():
                nonlocal tok, cache
                for t in range(TP_PARITY_STEPS):
                    tok, lg, cache = serve(params, cache, tok, t)
                    fed.append(tok.cpu())
                    logits.append(lg[:, 0].cpu())

            _, gaps, _ = _router_gaps(decode)
            out["decode"] = torch.stack(logits, 1)
            out["fed"] = torch.cat(fed, 1)
            # (steps x MoE layers, slots, 1) -> (slots, steps)
            out["decode_gap"] = torch.stack(gaps).view(
                TP_PARITY_STEPS, -1, TP_SLOTS).amin(1).T if gaps else None
            del cache
        if requests is not None:
            out["batcher"] = tp_batcher_run(cfg, params, requests,
                                            context=context)
    del params, context
    _release()
    return out


def _tp_forced_reference(cfg, seed: int, ref: dict, run: dict) -> dict:
    """The single-card f32 run of ``_tp_reference`` made again with the
    experts that the model-axis run took at the router ties
    (``_forced_routes`` over ``run``'s picks, rank 0's): prefill logits of
    ``ref["tokens"]`` and the decode teacher-forced over ``ref["fed"]``,
    each with the count of tokens whose experts changed.  Host tensors;
    frees the card."""
    params = _tpf_params(cfg, seed, torch.float32, None, DEVICE)
    out = {}
    with torch.no_grad():
        context = _tpf_context(cfg, params, seed, slice(0, len(ref["tokens"])))
        logits, out["prefill_forced"] = _forced_routes(
            lambda: make_prefill(cfg)(params, ref["tokens"].to(DEVICE),
                                      context), run["prefill_picks"])
        out["prefill"] = logits.cpu()
        del logits, context
        context = _tpf_context(cfg, params, seed, slice(None))
        (got, _), out["decode_forced"] = _forced_routes(
            lambda: _ep_teacher_decode(cfg, params, make_serve_step(cfg),
                                       ref["fed"], DEVICE, context),
            run["decode_picks"])
        out["decode"] = got.cpu()
        del got
    del params, context
    _release()
    return out


def _tie_parity(got, forced, gap, v: int, changed: int) -> dict:
    """``got`` (the model-axis run's logits) against the forced reference
    at every position (PARITY_TOL and the greedy token, no position held
    out), with the count of router ties and of forced tokens."""
    return {**_logit_err(got, forced, v), "router_ties": int(
        _ties(gap).sum()), "forced_positions": changed}


def _picks_sum(picks) -> int:
    """A checksum of a run's picked experts, to hold the ranks' alike."""
    return sum(int((p.long() * (1 + torch.arange(p.numel()).view(
        p.shape))).sum()) for p in picks)


def tpf_rank(rank: int, world: int, name: str, cfg, seed: int,
             ref_path: str, device: str) -> dict:
    """One rank of phase ``name`` (``TPF_PHASES``): f32 (TF32 off) on a
    (1, 4) mesh, this rank's blocks (and experts) drawn from the seed, the
    gates opened: prefill of the reference's prompts through
    ``make_prefill(cfg, ctx)`` over the context (encoded on the ranks for
    the encoder-decoder) and 8 teacher-forced decode steps of its 4 slots
    through ``make_serve_step(cfg, ctx)``, against the single-card logits;
    then, for bf16 serving, the prefill and the ``ContinuousBatcher`` over
    the requests; for a step mesh, one f32 training step (B 4 x S 256 and
    its frames, ZeRO-1 on the data axis) held leaf by leaf to the
    single-card step that rank 0 runs first.  Launches, exchange seconds
    and bytes, device and wall ms of each; peak memory and bytes of
    parameters a rank.  For a MoE config the experts each route call
    picked are recorded (``_router_gaps``), and rank 0 saves its f32
    logits and picks beside ``ref_path`` for the check at the router ties
    (``_tp_forced_reference``)."""
    _, _, seq, serve_bf16, step_mesh = TPF_PHASES[name]
    dev = rank_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = torch.load(ref_path)
    ref = refs["f32"]
    out = {}
    ctx = _tpf_ctx(cfg, (1, world))
    torch.cuda.reset_peak_memory_stats()
    params = _tpf_params(cfg, seed, torch.float32, ctx, dev)
    out["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in param_leaves(params))
    rows = slice(0, len(ref["tokens"]))
    with torch.no_grad():
        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        context, enc_ms, enc_wall = _timed(
            lambda: _tpf_context(cfg, params, seed, rows, ctx))
        out["encode"] = {"launches": _delta(n0), **_exchange_delta(ex0),
                         "device_ms": enc_ms, "wall_ms": enc_wall}
        n0, ex0 = launch_counts(), _exchange()
        (logits, ms, wall), _, picks = _router_gaps(lambda: _timed(
            lambda: make_prefill(cfg, ctx)(params, ref["tokens"].to(dev),
                                           context)))
        out["prefill"] = {**_logit_err(logits.cpu(), ref["prefill"],
                                       cfg.vocab_size,
                                       _ties(ref["prefill_gap"])),
                          "launches": _delta(n0), **_exchange_delta(ex0),
                          "device_ms": ms, "wall_ms": wall,
                          "checksum": launch_train.checksum([logits]),
                          "picks": _picks_sum(picks)}
        kept = {"prefill": logits.cpu(), "prefill_picks": picks} \
            if cfg.is_moe else {}
        del logits, context
        context = _tpf_context(cfg, params, seed, slice(None), ctx)
        n0, ex0 = launch_counts(), _exchange()
        (got, ms), _, picks = _router_gaps(lambda: _ep_teacher_decode(
            cfg, params, make_serve_step(cfg, ctx), ref["fed"], dev,
            context))
        out["decode"] = {**_logit_err(got.cpu(), ref["decode"],
                                      cfg.vocab_size,
                                      _ties(ref["decode_gap"])),
                         "launches": _delta(n0), **_exchange_delta(ex0),
                         "step_ms": ms,
                         "checksum": launch_train.checksum([got]),
                         "picks": _picks_sum(picks)}
        if cfg.is_moe:
            kept.update(decode=got.cpu(), decode_picks=picks)
        del got, context
    if rank == 0 and cfg.is_moe:
        torch.save(kept, os.path.join(os.path.dirname(ref_path),
                                      "rank0.pt"))
    del kept
    del params
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    _release()
    if serve_bf16:
        ref = refs["bf16"]
        torch.cuda.reset_peak_memory_stats()
        params = _tpf_params(cfg, seed, torch.bfloat16, ctx, dev)
        with torch.no_grad():
            context = _tpf_context(cfg, params, seed, rows, ctx)
            dist.barrier()
            n0, ex0 = launch_counts(), _exchange()
            logits, ms, wall = _timed(lambda: make_prefill(cfg, ctx)(
                params, ref["tokens"].to(dev), context))
            out["serve_prefill"] = {
                "launches": _delta(n0), **_exchange_delta(ex0),
                "device_ms": ms, "wall_ms": wall,
                "tokens": _token_check(logits[:, -1:].cpu(),
                                       {"decode": ref["prefill"][:, -1:]},
                                       slice(None), cfg.vocab_size)}
            del logits, context
            context = _tpf_context(cfg, params, seed, slice(None), ctx)
            dist.barrier()
            out["batcher"] = tp_batcher_run(cfg, params, refs["requests"],
                                            ctx, context)
            del context
        out["batcher"]["check"] = _batcher_check(
            out["batcher"], ref["batcher"], cfg.vocab_size)
        out["batcher"]["emitted"] = None  # held to the reference here
        out["serve_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del params
        _release()
    if step_mesh is not None:
        tcfg = TrainConfig(**TP_PARITY_TCFG)
        batch = next(make_batches(cfg, TPF_STEP_BATCH, TPF_STEP_SEQ,
                                  seed=seed))
        batch["context"] = audio_frames(cfg, TPF_STEP_BATCH, seed) \
            if cfg.is_encoder_decoder else vision_patches(
                cfg, TPF_STEP_BATCH, seed)
        single = _single_step(cfg, seed, tcfg, batch, dev) if rank == 0 \
            else None
        dist.barrier()
        ctx = _tpf_ctx(cfg, step_mesh)
        torch.cuda.reset_peak_memory_stats()
        params = _tpf_params(cfg, seed, torch.float32, ctx, dev)
        zero1 = ctx.dp > 1
        opt = init_opt_state(params, ctx if zero1 else None)
        step = make_train_step(cfg, TrainConfig(zero1=zero1,
                                                **TP_PARITY_TCFG), ctx)
        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        (params, opt, m), ms, wall = _timed(lambda: step(params, opt, batch))
        res = {"mesh": list(step_mesh), "device_ms": ms, "wall_ms": wall,
               "launches": _delta(n0), **_exchange_delta(ex0),
               "metrics": {k: float(v) for k, v in m.items()}}
        full = gather_opt_state(opt, ctx, params) if zero1 else opt
        del opt
        _release()  # the step's cached blocks, for the ranks' checks
        res.update(_tp_step_check(cfg, ctx, params, full, single, tcfg,
                                  res["metrics"], dev))
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["step"] = res
        del params, full
        _release()
    return out


def phase_tp_family(name: str, rng, seed: int) -> dict:
    """Phase ``name`` of ``TPF_PHASES`` on 4 gloo ranks sharing the card:
    the single-card references (f32, and bf16 for serving) made first and
    freed, then ``tpf_rank``; prints each case's errors, wire bytes against
    ``tp_forward_bytes`` (and the encoder's ``tp_encode_bytes``), launches
    a rank against ``prefill_launches`` / ``encode_launches`` /
    ``train_launches``, times and memory; returns the launch counts,
    summed over the ranks."""
    t0 = time.perf_counter()
    cfg = _tpf_config(name)
    _, _, seq, serve_bf16, step_mesh = TPF_PHASES[name]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (TP_BATCH, seq)))
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TP_SLOTS, 1)))
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = {"f32": _tp_reference(cfg, seed, torch.float32, tokens, first)}
    if serve_bf16:
        stokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (TP_BATCH, TP_SEQ)))
        refs["requests"] = _tp_requests(rng, cfg)
        refs["bf16"] = _tp_reference(cfg, seed, torch.bfloat16, stokens,
                                      requests=refs["requests"])
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix=name + "_") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save(refs, path)
        t1 = time.perf_counter()
        ranks = spawn_ranks(tpf_rank, TP_RANKS, name, cfg, seed, path,
                            DEVICE, backend="gloo", timeout_s=900)
        ranks_s = time.perf_counter() - t1
        tie_err, forced_s = {}, 0.0
        if cfg.is_moe:  # G3: every position, the ties' experts forced
            t2 = time.perf_counter()
            run0 = torch.load(os.path.join(tmp, "rank0.pt"))
            forced = _tp_forced_reference(cfg, seed, refs["f32"], run0)
            tie_err = {case: _tie_parity(
                run0[case], forced[case], refs["f32"][case + "_gap"],
                cfg.vocab_size, forced[case + "_forced"])
                for case in ("prefill", "decode")}
            del run0, forced
            forced_s = time.perf_counter() - t2
    tp = TP_RANKS
    head = ranks[0]
    moe = "train" if cfg.is_moe else None
    cap = moe_mod.capacity_for(TP_BATCH * seq // tp, cfg.top_k,
                               cfg.num_experts, cfg.num_experts / cfg.top_k) \
        if cfg.is_moe else 0
    want_bytes = {
        "encode": tp_encode_bytes(cfg, tp, TP_BATCH, 4)
        if cfg.is_encoder_decoder else 0,
        "prefill": tp_forward_bytes(cfg, tp, TP_BATCH, seq, 4, moe=moe,
                                    capacity=cap),
        "decode": TP_PARITY_STEPS * tp_forward_bytes(
            cfg, tp, TP_SLOTS, 1, 4, moe="decode" if cfg.is_moe else None)}
    want_launches = {
        "encode": {k: n for k, n in encode_launches(cfg).items()
                   if n and cfg.is_encoder_decoder},
        "prefill": {k: n for k, n in prefill_launches(cfg, seq).items() if n},
        "decode": {k: n * TP_PARITY_STEPS
                   for k, n in ep_launches(cfg).items() if n}}
    counts = []
    for case in ("encode", "prefill", "decode"):
        per = [r[case] for r in ranks]
        line = {"phase": name, "arch": cfg.name, "case": case,
                "dtype": "float32", "layers": cfg.num_layers,
                "mesh": [1, tp], "backend": "gloo", "batch": TP_BATCH,
                "seq": seq if case != "decode" else 1,
                "wire_bytes_per_rank": [p["wire_bytes"] for p in per],
                "wire_bytes_formula": want_bytes[case],
                "staged_bytes_per_rank": [p["staged_bytes"] for p in per],
                "exchange_s": [p["exchange_s"] for p in per],
                "launches_per_rank": [p["launches"] for p in per],
                "want_launches": want_launches[case]}
        if case == "decode":
            line.update(slots=TP_SLOTS, steps=TP_PARITY_STEPS,
                        step_ms_p50=float(np.percentile(
                            [m for p in per for m in p["step_ms"]], 50)))
        else:
            line.update(device_ms=[p["device_ms"] for p in per],
                        wall_ms=[p["wall_ms"] for p in per])
        if case != "encode":
            same = len({p["checksum"] for p in per}) == 1
            line.update({k: max(p[k] for p in per)
                         for k in ("max_abs_err", "excess")},
                        greedy_equal=all(p["greedy_equal"] for p in per),
                        tol=PARITY_TOL, identical_on_all_ranks=same)
            if cfg.is_moe:
                # every position against the single card re-run with the
                # experts rank 0 took at the ties; the unforced reference's
                # errors at the ties beside it
                line.update(tie_err[case], router_tie=ROUTER_TIE,
                            against="single card, router ties forced to "
                                    "the model axis's experts",
                            unforced={k: per[0][k] for k in (
                                "positions_beyond_tol",
                                "max_abs_err_at_ties")})
                check(len({p["picks"] for p in per}) == 1,
                      f"{name} {case}: the ranks picked different experts")
            check(same, f"{name} {case}: the ranks hold different logits")
            check(line["excess"] <= 0,
                  f"{name} {case}: beyond {PARITY_TOL}: max |err| "
                  f"{line['max_abs_err']}")
            check(line["greedy_equal"], f"{name} {case}: greedy tokens "
                                        f"differ from the single card's")
        emit(line)
        for p in per:
            check(p["wire_bytes"] == want_bytes[case],
                  f"{name} {case} wire bytes {p['wire_bytes']}, want "
                  f"{want_bytes[case]}")
            check(p["launches"] == want_launches[case],
                  f"{name} {case} launched {p['launches']}, want "
                  f"{want_launches[case]}")
        counts += [p["launches"] for p in per]
    if serve_bf16:
        per = [r["serve_prefill"] for r in ranks]
        bat = [r["batcher"] for r in ranks]
        steps = bat[0]["steps"]
        want_pb = tp_forward_bytes(cfg, tp, TP_BATCH, TP_SEQ, 2)
        want_db = steps * tp_forward_bytes(cfg, tp, TP_SLOTS, 1, 2)
        step_ms = [m for b in bat for m in b["step_ms"]]
        emit({"phase": name, "arch": cfg.name, "case": "serving",
              "dtype": "bfloat16", "layers": cfg.num_layers,
              "mesh": [1, tp], "backend": "gloo",
              "prefill_batch": TP_BATCH, "prefill_seq": TP_SEQ,
              "prefill_device_ms": [p["device_ms"] for p in per],
              "prefill_wall_ms": [p["wall_ms"] for p in per],
              "prefill_wire_bytes": [p["wire_bytes"] for p in per],
              "prefill_wire_bytes_formula": want_pb,
              "prefill_staged_bytes": [p["staged_bytes"] for p in per],
              "prefill_tokens": per[0]["tokens"],
              "slots": TP_SLOTS, "requests": len(refs["requests"]),
              "steps": steps, "admitted_at": bat[0]["admitted_at"],
              "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
              "decode_step_ms_p99": float(np.percentile(step_ms, 99)),
              "single_card_step_ms_p50": float(np.percentile(
                  refs["bf16"]["batcher"]["step_ms"], 50)),
              "decode_exchange_s": [b["exchange_s"] for b in bat],
              "decode_wire_bytes": [b["wire_bytes"] for b in bat],
              "decode_wire_bytes_formula": want_db,
              "decode_staged_bytes": [b["staged_bytes"] for b in bat],
              "tokens": [b["check"] for b in bat],
              "peak_memory_bytes_per_rank": [r["serve_peak_memory_bytes"]
                                             for r in ranks],
              "launches_per_rank": {"prefill": [p["launches"] for p in per],
                                    "batcher": [b["launches"] for b in bat]}})
        want_pl = {k: n for k, n in prefill_launches(cfg, TP_SEQ).items()
                   if n}
        for p, b in zip(per, bat):
            check(p["launches"] == want_pl,
                  f"{name} serving prefill launched {p['launches']}, want "
                  f"{want_pl}")
            check(b["launches"] == {},
                  f"{name} serving decode launched {b['launches']}")
            check(p["wire_bytes"] == want_pb,
                  f"{name} serving prefill wire bytes {p['wire_bytes']}, "
                  f"want {want_pb}")
            check(b["wire_bytes"] == want_db,
                  f"{name} serving decode wire bytes {b['wire_bytes']}, "
                  f"want {want_db}")
            check(b["check"]["mismatches"] == 0,
                  f"{name}: tokens differ from the single-card run where "
                  f"its margin exceeds {EP_MARGIN_ULPS} bf16 ulps: "
                  f"{b['check']}")
            check(p["tokens"]["mismatches"] == 0,
                  f"{name} serving prefill tokens: {p['tokens']}")
            check(b["out"] == bat[0]["out"],
                  f"{name}: the ranks emitted different tokens")
        check(any(t > 0 for t in bat[0]["admitted_at"].values()),
              f"{name}: no request was admitted mid-flight")
        counts += [p["launches"] for p in per] + [b["launches"] for b in bat]
    if step_mesh is not None:
        per = [r["step"] for r in ranks]
        st = per[0]
        same = all(p["checksums"] == st["checksums"] for p in per)
        want_step = train_launches(cfg, 1, False, TPF_STEP_SEQ)
        emit({"phase": name, "arch": cfg.name, "case": "train_step",
              "dtype": "float32", "layers": cfg.num_layers,
              "mesh": st["mesh"], "zero1": step_mesh[0] > 1,
              "batch": TPF_STEP_BATCH, "seq": TPF_STEP_SEQ,
              "metrics": st["metrics"], "rel_err": st["rel_err"],
              "trees": st["trees"], "params": st["params"],
              "identical_on_all_ranks": same,
              "device_ms": [p["device_ms"] for p in per],
              "wall_ms": [p["wall_ms"] for p in per],
              "exchange_s": [p["exchange_s"] for p in per],
              "wire_bytes_per_rank": [p["wire_bytes"] for p in per],
              "staged_bytes_per_rank": [p["staged_bytes"] for p in per],
              "launches_per_rank": [p["launches"] for p in per],
              "want_launches": want_step,
              "peak_memory_bytes_per_rank": [p["peak_memory_bytes"]
                                             for p in per]})
        check(same, f"{name}: ranks gathered different parameters")
        check(max(st["rel_err"].values()) <= 1e-4,
              f"{name}: loss or grad_norm beyond rtol 1e-4 of the "
              f"single-card step: {st['rel_err']}")
        errs = {k: v["err_over_max"] for k, v in st["trees"].items()}
        check(max(errs.values()) <= 1e-5,
              f"{name}: moments beyond 1e-5 of their max: {errs}")
        check(st["params"]["adamw_over_lr"] <= 1e-3 and
              st["params"]["update_rel_err"] <= 1e-2,
              f"{name}: parameters off their update: {st['params']}")
        for p in per:
            check(p["launches"] == want_step,
                  f"{name} step launched {p['launches']}, want {want_step}")
        counts += [p["launches"] for p in per]
    emit({"phase": name + "_total", "seconds": time.perf_counter() - t0,
          "reference_s": ref_s, "ranks_s": ranks_s,
          "forced_reference_s": forced_s,
          "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
          "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                         for r in ranks]})
    return _ep_sum(counts)


def run_tp_families(rng, seed: int) -> dict:
    """The model axis of the MLA, cross-attention and encoder-decoder
    families (``TPF_PHASES``); returns each phase's launch counts, summed
    over the ranks."""
    _release()
    return {name: phase_tp_family(name, rng, seed + i)
            for i, name in enumerate(TPF_PHASES)}


# --------------------------------------------------------------------------
# the dry-run and FSDP (ROADMAP item 13b)
# --------------------------------------------------------------------------

# the dry-run's host pool: started after the build, on CPUs of its own
# (the last DRYRUN_WORKERS of this process's); the card's phases and the
# ranks they start keep the others.  Sharing all CPUs with them, it slowed
# the host-bound phases by 1.2-2x.
DRYRUN_WORKERS = 2
# the 16 x 16 sweep's shapes, in the JAX package's cost mode (``unroll``:
# attention chunks of 2048, 4x fewer ops on the meta device); prefill_32k
# is the CLI's (``python -m repro_torch.launch.dryrun --shape
# prefill_32k``: 100-400 s of host an arch)
DRYRUN_SHAPES = ("train_4k", "decode_32k", "long_500k")
# one arch of each family, and MLA: the extrapolation held to the sweep
DRYRUN_FAMILIES = ("granite-3-8b", "mamba2-130m", "dbrx-132b",
                   "seamless-m4t-medium", "llama-3.2-vision-90b",
                   "jamba-1.5-large-398b", "deepseek-v2-236b")
DRYRUN_FSDP = {"dbrx-132b", "llama-3.2-vision-90b", "deepseek-v2-236b",
               "jamba-1.5-large-398b"}
# dryrun_card: qwen2-0.5b on one card, bf16
CARD_SHAPES = {"prefill": ShapeConfig("card_prefill", 512, 4, "prefill"),
               "decode": ShapeConfig("card_decode", 512, 4, "decode"),
               "train": ShapeConfig("card_train", TRAIN_SEQ, TRAIN_BATCH,
                                    "train")}
CARD_TRAIN = dict(microbatches=TRAIN_MICROBATCHES, remat=True,
                  grad_dtype="bf16")
# the caching allocator's rounding: every block a multiple of 512 bytes,
# and a block of more than 1 MiB keeps a remainder of up to 1 MiB that it
# does not split off (CUDACachingAllocator's ``kSmallSize``)
ALLOC_ROUND = 512
ALLOC_UNSPLIT = 2 ** 20


def alloc_slack(tensors) -> int:
    """The most the allocator may hold above ``tensors``' bytes."""
    return sum(ALLOC_ROUND + (ALLOC_UNSPLIT if t.untyped_storage().nbytes()
                              > ALLOC_UNSPLIT else 0) for t in tensors)
# fsdp: qwen2-0.5b whole on (4, 1); granite-3-8b 4 layers on (2, 2);
# deepseek-v2-236b 2 layers, f32 prefill B 1 x S 4096 on the chunked path
FSDP_SEQ = TRAIN_SEQ
FSDP_STEPS = 5
FSDP_TCFG = dict(learning_rate=3e-3, warmup_steps=10, total_steps=FSDP_STEPS,
                 **CARD_TRAIN)  # the launcher's, as dp_training runs it
SKIP_SHAPE = (1, 4096)


def _dryrun_worker_init(cpus) -> None:
    os.sched_setaffinity(0, cpus)
    torch.set_num_threads(1)


def dryrun_job(kind: str, args: tuple) -> dict:
    """One job of the dry-run's pool (a process of its own, on a fake
    world): "sweep" (arch, shape, multi_pod) the full-depth run and its
    analysis; "extrapolate" (arch, shape) ``measure_costs``; "program"
    (arch, shape name, build keywords) one rank's counts."""
    from repro_torch.launch import dryrun as dr
    t0 = time.perf_counter()
    if kind == "extrapolate":
        return {"costs": dr.measure_costs(*args),
                "seconds": time.perf_counter() - t0}
    if kind == "sweep":
        arch, shape, mp = args
        program, meta = dr.build_dryrun(arch, shape, multi_pod=mp,
                                        unroll=True)
    else:
        arch, shape, kw = args
        program, meta = dr.build_dryrun(arch, shape, **kw)
    acc = program()
    costs = dr._cost_vector(acc)
    mem = dr.memory_summary(acc)
    return {"meta": meta, "costs": costs, "memory": mem,
            "analysis": dr.analyse(meta, mem, costs)
            if kind == "sweep" else None,
            "argument_bytes": acc.argument_bytes,
            "temp_bytes": acc.temp_bytes,
            "collectives": {"count": acc.collectives.count_by_kind,
                            "bytes": acc.collectives.bytes_by_kind,
                            "sent": acc.collectives.sent_bytes},
            "seconds": time.perf_counter() - t0}


def _dryrun_jobs() -> dict:
    """Every job of the pool, by key, the longest (training) first."""
    from repro_torch.configs import ARCHS
    jobs = {}
    for shape in DRYRUN_SHAPES:
        for arch in ARCHS:
            jobs[("sweep", arch, shape, "16x16")] = ("sweep",
                                                     (arch, shape, False))
        if shape == "train_4k":
            for arch in ARCHS:
                jobs[("sweep", arch, shape, "2x16x16")] = (
                    "sweep", (arch, shape, True))
    for arch in DRYRUN_FAMILIES:
        jobs[("extrapolate", arch)] = ("extrapolate", (arch, "decode_32k"))
    one = MeshConfig((1, 1))
    qwen, granite = get_config(ARCH), get_config(TP_ARCH)
    for k, shape in CARD_SHAPES.items():
        jobs[("card", k)] = ("program", (ARCH, shape.name, dict(
            mesh=one, shape=shape, cfg_override=qwen,
            **(CARD_TRAIN if k == "train" else {}))))
    tp_shape = ShapeConfig("tp_prefill", TP_SEQ, TP_BATCH, "prefill")
    granite4 = dataclasses.replace(granite, num_layers=TP_TRAIN_LAYERS)
    train = ShapeConfig("fsdp_train", FSDP_SEQ, TRAIN_BATCH, "train")
    tp_train = ShapeConfig("fsdp_tp_train", TP_TRAIN_SEQ, TP_TRAIN_BATCH,
                           "train")
    for r in range(TP_RANKS):
        jobs[("tp_serving", r)] = ("program", (TP_ARCH, "tp_prefill", dict(
            mesh=MeshConfig((1, TP_RANKS)), shape=tp_shape, rank=r,
            cfg_override=granite, gather_logits=True)))
        jobs[("fsdp_qwen", r)] = ("program", (ARCH, "fsdp_train", dict(
            mesh=MeshConfig((RING_RANKS, 1)), shape=train, rank=r,
            fsdp=True, cfg_override=qwen, **CARD_TRAIN)))
        jobs[("fsdp_granite", r)] = ("program", (TP_ARCH, "fsdp_tp_train",
                                                 dict(
            mesh=MeshConfig((2, TP_RANKS // 2)), shape=tp_train, rank=r,
            fsdp=True, cfg_override=granite4,
            microbatches=TP_TRAIN_MICROBATCHES, remat=True,
            grad_dtype="bf16")))
    return jobs


def start_dryrun():
    """The dry-run's pool of spawned processes (each job on a fake world
    of its own) on the last ``DRYRUN_WORKERS`` CPUs of this process, which
    keeps the others (and passes them to the ranks it starts); its futures
    by key.  ``phase_dryrun`` collects them and gives the CPUs back."""
    import concurrent.futures
    import multiprocessing
    cpus = sorted(os.sched_getaffinity(0))
    mine = cpus[-DRYRUN_WORKERS:] if len(cpus) > 2 * DRYRUN_WORKERS \
        else cpus
    pool = concurrent.futures.ProcessPoolExecutor(
        DRYRUN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_dryrun_worker_init, initargs=(mine,))
    futures = {key: pool.submit(dryrun_job, *job)
               for key, job in _dryrun_jobs().items()}
    if mine != cpus:
        os.sched_setaffinity(0, cpus[:-DRYRUN_WORKERS])
    return pool, futures, time.perf_counter(), cpus


def phase_dryrun(pool, futures, t0: float, cpus) -> dict:
    """The production meshes on the host: one line a combination, the
    four configs above 4 GiB a device under FSDP, the extrapolation equal
    to the full-depth count for a config of each family.  Returns every
    job's result by key."""
    t_wait = time.perf_counter()
    try:
        got = {key: f.result() for key, f in futures.items()}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        os.sched_setaffinity(0, cpus)
    waited = time.perf_counter() - t_wait
    sweep = sorted(k for k in got if k[0] == "sweep")
    for key in sweep:
        a = got[key]["analysis"]
        emit({"phase": "dryrun", "arch": key[1], "shape": key[2],
              "mesh": key[3], "fsdp": a["fsdp"],
              "swa_variant": a["swa_variant"],
              "param_bytes": a["param_bytes"],
              "flops_per_device": a["flops_per_device"],
              "bytes_per_device": a["bytes_per_device"],
              "collective_bytes_per_device":
                  a["collective_bytes_per_device"],
              "collectives_by_kind": a["collectives_by_kind"],
              "collective_counts": a["collective_counts"],
              "wire_bytes_per_device": got[key]["costs"]["wire_bytes"],
              "roofline": a["roofline"], "dominant": a["dominant"],
              "useful_flops_ratio": a["useful_flops_ratio"],
              "argument_gib": a["memory"]["argument_size_in_bytes"] / 2**30,
              "temp_gib": a["memory"]["temp_size_in_bytes"] / 2**30,
              "seconds": got[key]["seconds"]})
        check(a["fsdp"] == (key[1] in DRYRUN_FSDP),
              f"dryrun {key}: fsdp={a['fsdp']}")
        check(all(math.isfinite(v) and v >= 0 for v in a["roofline"].values())
              and a["flops_per_device"] > 0,
              f"dryrun {key}: {a['roofline']}")
    exact = {}
    for arch in DRYRUN_FAMILIES:
        want = got[("sweep", arch, "decode_32k", "16x16")]["costs"]
        ext = got[("extrapolate", arch)]["costs"]
        diff = {k: (ext.get(k), want.get(k)) for k in set(ext) | set(want)
                if ext.get(k) != want.get(k)}
        exact[arch] = not diff
        check(not diff, f"dryrun {arch}: the extrapolation differs from "
                        f"the full-depth count: {diff}")
    emit({"phase": "dryrun_total", "combinations": len(sweep),
          "extrapolation_exact": exact,
          "host_seconds": sum(v["seconds"] for v in got.values()),
          "workers": DRYRUN_WORKERS, "waited_s": waited,
          "since_start_s": time.perf_counter() - t0})
    return got


def _card_args(cfg, kind: str, seed: int):
    """qwen2-0.5b's arguments of ``kind`` on the card, bf16, as the
    dry-run builds them: (the step as a function, the argument tensors)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    shape = CARD_SHAPES[kind]
    rng = np.random.default_rng(seed)

    def ids(*dims):
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, dims).astype(np.int32)).to(dev)

    if kind == "train":
        opt = init_opt_state(params)
        batch = {"tokens": ids(shape.global_batch, shape.seq_len),
                 "labels": ids(shape.global_batch, shape.seq_len)}
        step = make_train_step(cfg, TrainConfig(**CARD_TRAIN))
        return (lambda: step(params, opt, batch),
                list(param_leaves(params)) + list(param_leaves(opt))
                + list(batch.values()))
    if kind == "decode":
        cache = init_cache(cfg, params, shape.global_batch, shape.seq_len,
                           torch.bfloat16)
        tokens = ids(shape.global_batch, 1)
        return (lambda: decode_step(cfg, params, cache, tokens,
                                    shape.seq_len - 1)[0],
                list(param_leaves(params)) + list(param_leaves(cache))
                + [tokens])
    tokens = ids(shape.global_batch, shape.seq_len)
    return (lambda: forward(cfg, params, tokens)[0],
            list(param_leaves(params)) + [tokens])


def phase_dryrun_card(got: dict, seed: int) -> dict:
    """The dry-run's predictions against runs on the card: (i) qwen2-0.5b
    prefill, decode step and training step on one card: the argument
    bytes against the allocator's, the device ms against the roofline's
    compute term, the predicted peak beside the measured one; (ii)
    granite's TP prefill on (1, 4) (``tp_serving``'s run): each rank's
    predicted wire bytes and collectives by kind against the measured."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    launches = {}
    for kind in CARD_SHAPES:
        pred = got[("card", kind)]
        _release()
        base = torch.cuda.memory_allocated()
        fn, args = _card_args(cfg, kind, seed)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        with torch.no_grad() if kind != "train" else \
                contextlib.nullcontext():
            fn()  # warm
            torch.cuda.reset_peak_memory_stats()
            n0 = launch_counts()
            _, ms, wall = _timed(fn)
            launches[kind] = _delta(n0)
        peak = torch.cuda.max_memory_allocated() - base
        compute_ms = 1e3 * pred["costs"]["flops"] / hw.PEAK_FLOPS_BF16
        predicted_peak = pred["argument_bytes"] + pred["temp_bytes"]
        emit({"phase": "dryrun_card", "arch": ARCH, "kind": kind,
              "dtype": "bfloat16", "batch": CARD_SHAPES[kind].global_batch,
              "seq": CARD_SHAPES[kind].seq_len,
              "argument_bytes_predicted": pred["argument_bytes"],
              "argument_bytes_allocated": held, "tensors": len(args),
              "allocator_slack_max": alloc_slack(args),
              "flops_predicted": pred["costs"]["flops"],
              "roofline_compute_ms": compute_ms,
              "roofline_memory_ms": 1e3 * pred["costs"]["bytes"] / hw.HBM_BW,
              "device_ms": ms, "wall_ms": wall,
              "peak_bytes_predicted": predicted_peak,
              "peak_bytes_measured": peak,
              "peak_ratio_measured_over_predicted": peak / predicted_peak,
              "launches": launches[kind]})
        check(0 <= held - pred["argument_bytes"] <= alloc_slack(args),
              f"dryrun_card {kind}: {held} bytes allocated for "
              f"{pred['argument_bytes']} predicted ({len(args)} tensors, "
              f"the allocator's rounding at most {alloc_slack(args)})")
        check(ms >= compute_ms, f"dryrun_card {kind}: {ms} ms is faster "
              f"than the counted FLOPs allow ({compute_ms} ms)")
        del fn, args
    measured = TP_SERVING_PREFILL
    check(len(measured) == TP_RANKS, "dryrun_card: no tp_serving prefill "
                                     "was measured")
    rows = []
    for r, m in enumerate(measured):
        pred = got[("tp_serving", r)]["collectives"]
        rows.append({"rank": r, "wire_predicted": pred["sent"],
                     "wire_measured": m["sent"],
                     "counts_predicted": pred["count"],
                     "counts_measured": m["count"],
                     "result_bytes_predicted": pred["bytes"],
                     "result_bytes_measured": m["bytes"]})
        check(pred["sent"] == m["sent"] == m["wire_bytes"],
              f"dryrun_card tp rank {r}: wire {pred['sent']} predicted, "
              f"{m['sent']} / {m['wire_bytes']} measured")
        check(pred["count"] == m["count"] and pred["bytes"] == m["bytes"],
              f"dryrun_card tp rank {r}: {pred['count']} / {pred['bytes']}"
              f" predicted, {m['count']} / {m['bytes']} measured")
    emit({"phase": "dryrun_card_tp", "arch": TP_ARCH, "mesh": [1, TP_RANKS],
          "batch": TP_BATCH, "seq": TP_SEQ, "ranks": rows,
          "seconds": time.perf_counter() - t0})
    return _ep_sum(list(launches.values()))


def _fsdp_ctx(cfg, mesh_shape, **kw):
    mesh_cfg = MeshConfig(tuple(mesh_shape))
    dgroup, mgroup = mesh_groups(mesh_cfg)
    return make_ctx(dgroup, mesh_cfg, model_group=mgroup, cfg=cfg, **kw)


def _shard_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in param_leaves(tree))


def fsdp_qwen_rank(rank: int, world: int, seed: int, device: str) -> dict:
    """qwen2-0.5b whole on (4, 1), bf16: ``FSDP_STEPS`` FSDP steps on one
    batch as ``dp_training`` runs them (its f32 step is ``dp_parity``'s
    third mode): losses, wire bytes, launches and the bytes a rank
    holds."""
    dev = rank_device(device)
    cfg = get_config(ARCH)
    tcfg = TrainConfig(**FSDP_TCFG)
    ctx = _fsdp_ctx(cfg, (world, 1), remat=True, fsdp=True)
    batch = next(make_batches(cfg, TRAIN_BATCH, FSDP_SEQ, seed=seed))
    gen = torch.Generator(device=dev).manual_seed(seed)
    whole = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    out = {"replicated_bytes": _shard_bytes(whole) + 2 * 4 * sum(
        t.numel() for t in param_leaves(whole))}
    params = fsdp_mod.fsdp_shard(whole, ctx)
    del whole
    _release()
    opt = init_opt_state(params)
    out["held_bytes"] = _shard_bytes(params) + _shard_bytes(opt["m"]) + \
        _shard_bytes(opt["v"])
    out["formula_bytes"] = fsdp_wire_bytes(
        cfg, params, ctx, tcfg.microbatches, tcfg.remat, 2)
    step = make_train_step(cfg, tcfg, ctx)
    torch.cuda.reset_peak_memory_stats()
    out["steps"] = []
    for _ in range(FSDP_STEPS):
        dist.barrier()
        n0, ex0 = launch_counts(), _exchange()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        out["steps"].append({"wall_ms": 1e3 * (time.perf_counter() - t0),
                             "loss": float(m["loss"]),
                             "launches": _delta(n0),
                             **_exchange_delta(ex0)})
    out["checksum_trained"] = launch_train.checksum(
        fsdp_mod.fsdp_gather(params, ctx))
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def fsdp_granite_rank(rank: int, world: int, cfg, seed: int,
                      device: str) -> dict:
    """granite-3-8b, 4 layers, bf16 on (2, 2): the FSDP x TP step from
    ``tp_training``'s parameters on its batch (its ``seed``), whose first
    ZeRO-1 step it is held to: metrics, wire bytes, peak memory a rank."""
    dev = rank_device(device)
    tcfg = TrainConfig(**TP_TRAIN_TCFG)
    batch = next(make_batches(cfg, TP_TRAIN_BATCH, TP_TRAIN_SEQ, seed=seed))
    ctx = _fsdp_ctx(cfg, (2, world // 2), remat=True, fsdp=True)
    params = fsdp_mod.fsdp_shard(
        _tp_params(cfg, seed, torch.bfloat16, ctx, dev), ctx)
    opt = init_opt_state(params)
    _release()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, tcfg, ctx)
    dist.barrier()
    n0, ex0 = launch_counts(), _exchange()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    return {"wall_ms": 1e3 * (time.perf_counter() - t0),
            "metrics": {k: float(v) for k, v in m.items()},
            "launches": _delta(n0), **_exchange_delta(ex0),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def fsdp_rank(rank: int, world: int, seed: int, gcfg, gseed: int,
              device: str) -> dict:
    """Both FSDP paths on the same 4 ranks: ``fsdp_qwen_rank`` on (4, 1),
    then ``fsdp_granite_rank`` on (2, 2)."""
    qwen = fsdp_qwen_rank(rank, world, seed, device)
    _release()
    return {"qwen": qwen,
            "granite": fsdp_granite_rank(rank, world, gcfg, gseed, device)}


def phase_causal_skip(seed: int) -> dict:
    """deepseek-v2-236b, 2 layers, f32 prefill B 1 x S 4096: MLA on the
    chunked path, with ``causal_skip`` off and on (``ParallelCtx``):
    logits within PARITY_TOL, FLOPs (counted on the meta device) and
    device ms.  Returns the launch counts."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.float32, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, SKIP_SHAPE)).to(dev)
    meta = init_params(cfg, torch.Generator(), device="meta")
    out = {}
    logits = {}
    with torch.no_grad():
        for skip in (False, True):
            ctx = ParallelCtx(causal_skip=skip)
            with FlopCounterMode(display=False) as fc:
                forward(cfg, meta, tokens.to("meta"), ctx=ctx)
            n0 = launch_counts()
            lg, ms, wall = _timed(lambda: forward(cfg, params, tokens,
                                                  ctx=ctx)[0])
            logits[skip] = lg.float().cpu()
            out["skip" if skip else "uniform"] = {
                "flops": fc.get_total_flops(), "device_ms": ms,
                "wall_ms": wall, "launches": _delta(n0)}
            del lg
    v = cfg.vocab_size
    diff = (logits[True] - logits[False])[..., :v]
    out["max_abs_logit_diff"] = float(diff.abs().max())
    within = bool(torch.allclose(logits[True][..., :v],
                                 logits[False][..., :v], **PARITY_TOL))
    del params, logits
    _release()
    emit({"phase": "causal_skip", "arch": MLA_ARCH, "layers": MLA_LAYERS,
          "dtype": "float32", "shape": list(SKIP_SHAPE), **out,
          "flops_ratio": out["skip"]["flops"] / out["uniform"]["flops"],
          "seconds": time.perf_counter() - t0})
    check(within, f"causal_skip: logits differ by "
                  f"{out['max_abs_logit_diff']}")
    check(out["skip"]["flops"] < out["uniform"]["flops"],
          "causal_skip: no FLOPs saved")
    return _ep_sum([out[k]["launches"] for k in ("uniform", "skip")])


def phase_fsdp(got: dict, seed: int) -> dict:
    """FSDP on 4 gloo ranks sharing the card: qwen2-0.5b's bf16 steps on
    (4, 1) against the dry-run and the formula, granite 4 layers FSDP x TP
    on (2, 2) against ``tp_training``'s first step.  Returns the launch
    counts."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    gcfg = dataclasses.replace(get_config(TP_ARCH),
                               num_layers=TP_TRAIN_LAYERS)
    zero1 = TP_TRAINING_FIRST
    check("seed" in zero1, "fsdp_tp: tp_training did not run")
    both = spawn_ranks(fsdp_rank, RING_RANKS, seed, gcfg, zero1["seed"],
                       DEVICE, backend="gloo", timeout_s=900)
    ranks = [r["qwen"] for r in both]
    granite = [r["granite"] for r in both]
    head = ranks[0]
    losses = [s["loss"] for s in head["steps"]]
    want_k1 = {k: n for k, n in train_launches(
        cfg, TRAIN_MICROBATCHES, True, FSDP_SEQ).items()
        if k.startswith("flash_attention")}
    share = [r["held_bytes"] / r["replicated_bytes"] for r in ranks]
    pred = [got[("fsdp_qwen", r)]["collectives"]["sent"]
            for r in range(RING_RANKS)]
    emit({"phase": "fsdp", "arch": ARCH, "mesh": [RING_RANKS, 1],
          "backend": "gloo", "dtype": "bfloat16", "batch": TRAIN_BATCH,
          "seq": FSDP_SEQ,
          "microbatches": TRAIN_MICROBATCHES, "remat": True,
          "losses": losses,
          "step_wall_ms": [[s["wall_ms"] for s in r["steps"]]
                           for r in ranks],
          "exchange_s": [[s["exchange_s"] for s in r["steps"]]
                         for r in ranks],
          "wire_bytes_per_step": [r["steps"][-1]["wire_bytes"]
                                  for r in ranks],
          "wire_bytes_predicted": pred,
          "wire_bytes_formula": [r["formula_bytes"] for r in ranks],
          "held_share_of_replicated": share,
          "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                         for r in ranks],
          "launches_per_rank_step": [r["steps"][-1]["launches"]
                                     for r in ranks],
          "want_k1_per_step": want_k1})
    check(len({r["checksum_trained"] for r in ranks}) == 1,
          "fsdp: the ranks' gathered parameters differ")
    check(all(math.isfinite(x) for x in losses) and
          losses[-1] <= 0.9 * losses[0],
          f"fsdp training did not fit its batch: {losses}")
    check(max(share) <= 0.26, f"fsdp: a rank holds {share} of the "
                              f"replicated parameters and state")
    for r, p in zip(ranks, pred):
        for s in r["steps"]:
            k1 = {k: n for k, n in s["launches"].items()
                  if k.startswith("flash_attention")}
            check(k1 == want_k1, f"fsdp step launched {k1}, want {want_k1}")
            check(s["wire_bytes"] == p == r["formula_bytes"],
                  f"fsdp wire bytes {s['wire_bytes']} a step, predicted "
                  f"{p}, formula {r['formula_bytes']}")
    gpred = [got[("fsdp_granite", r)]["collectives"]["sent"]
             for r in range(TP_RANKS)]
    g0 = granite[0]
    rel = {k: abs(g0["metrics"][k] - zero1["metrics"][k])
           / abs(zero1["metrics"][k]) for k in ("loss", "grad_norm")}
    emit({"phase": "fsdp_tp", "arch": gcfg.name, "layers": gcfg.num_layers,
          "mesh": [2, TP_RANKS // 2], "dtype": "bfloat16",
          "batch": TP_TRAIN_BATCH, "seq": TP_TRAIN_SEQ,
          "metrics": g0["metrics"], "zero1_metrics": zero1["metrics"],
          "rel_err": rel, "wall_ms": [r["wall_ms"] for r in granite],
          "exchange_s": [r["exchange_s"] for r in granite],
          "wire_bytes": [r["wire_bytes"] for r in granite],
          "wire_bytes_predicted": gpred,
          "zero1_wire_bytes": zero1["wire_bytes"],
          "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                         for r in granite],
          "zero1_peak_memory_bytes_per_rank": zero1["peak_memory_bytes"],
          "launches": [r["launches"] for r in granite]})
    check(rel["loss"] <= 1e-3 and rel["grad_norm"] <= 2e-2,
          f"fsdp_tp: the FSDP x TP step is off tp_training's first ZeRO-1 "
          f"step: {rel}")
    for r, p in zip(granite, gpred):
        check(r["wire_bytes"] == p,
              f"fsdp_tp wire bytes {r['wire_bytes']}, predicted {p}")
    emit({"phase": "fsdp_total", "seconds": time.perf_counter() - t0})
    return _ep_sum([s["launches"] for r in ranks for s in r["steps"]]
                   + [r["launches"] for r in granite])


def run_paths(rng) -> dict:
    """The three serving paths; returns each path's launch counts."""
    paths = {}
    for arch, seed in ((ARCH, SEED), (SSM_ARCH, SEED + 2)):
        cfg = get_config(arch)
        phase_parity(rng, cfg, 2, 256, seed)
        _release()
        paths[arch] = phase_serving(
            rng, cfg, prefill_batch=4, prefill_lens=(128, 256, 512),
            prompt_lens=(128, 256), new_tokens=32, max_len=320,
            seed=seed + 1)
        _release()

    moe = get_config(MOE_ARCH)
    cut = dataclasses.replace(moe, num_layers=MOE_PARITY_LAYERS)
    phase_parity(rng, cut, 2, 128, SEED + 4)
    _release()
    paths[MOE_ARCH] = phase_serving(
        rng, dataclasses.replace(moe, num_layers=MOE_SERVE_LAYERS),
        prefill_batch=2, prefill_lens=(256,), prompt_lens=(32, 64),
        new_tokens=16, max_len=96, seed=SEED + 5)
    _release()
    return paths


def run_context_paths(rng) -> dict:
    """The families with MLA, cross-attention and an encoder, at full
    width: f32 parity, then bf16 serving; returns each path's launch
    counts.  seamless-m4t-medium whole (prefill at S 128 and at S = T =
    1024, where its 12 cross blocks take K1); llama-3.2-vision-90b cut to
    one period of 5 layers (its layer 4 the cross layer, 1601 patches);
    deepseek-v2-236b cut to 2 layers (MLA on the plain path; the MoE layer
    of 160 experts on K5)."""
    paths = {}
    full = get_config(ENC_DEC_ARCH)
    vision = dataclasses.replace(get_config(VISION_ARCH),
                                 num_layers=VISION_LAYERS)
    mla = dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS)
    for cfg, lens, seed in ((full, (128, 1024), SEED + 14),
                            (vision, (128,), SEED + 16),
                            (mla, (256,), SEED + 18)):
        phase_parity(rng, cfg, 2, 128, seed)
        _release()
        paths[cfg.name] = phase_serving(
            rng, cfg, prefill_batch=2, prefill_lens=lens,
            prompt_lens=(32, 64), new_tokens=16, max_len=96, seed=seed + 1)
        _release()
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script checks the "
              "port on the card only", file=sys.stderr)
        return 2
    # f32 references in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "networkx": networkx.__version__,
          "device": torch.cuda.get_device_name(0)})
    rng = np.random.default_rng(SEED)
    phase_build()
    dryrun = start_dryrun()  # the host's meta runs, on CPUs of their own
    timings = phase_kernels(rng)
    timings["flash_attention_bwd"] = phase_bwd_kernel(rng)
    timings["ssd_scan"] = phase_ssd_kernel(rng)
    timings["moe_gmm"] = phase_gmm_kernel(rng)
    timings["ssd_scan_bwd"] = phase_ssd_bwd_kernel(rng)
    timings["moe_gmm_bwd"] = phase_gmm_bwd_kernel(rng)
    n_values = gradient_values()
    timings.update(phase_compress_kernels(n_values))
    paths = run_paths(rng)
    paths.update(run_context_paths(rng))
    paths["training"] = run_training(SEED + 8)
    paths.update(run_family_training(SEED + 30))
    paths.update(run_dp(SEED + 10))
    paths.update(run_ep(rng, SEED + 12))
    paths.update(run_tp(rng, SEED + 20))
    paths.update(run_tp_families(rng, SEED + 40))
    codecs = phase_codecs(SEED + 6)
    check(codecs["values"] == n_values, "gradient size changed")
    paths["codecs"] = codecs["counts"]
    paths["codecs_real"] = phase_codecs_real(SEED + 9)
    paths["collectives"] = phase_collectives(n_values, SEED + 7)
    paths["planner"] = phase_planner(SEED + 11)
    paths["codesign"] = phase_codesign(SEED + 13)
    paths["causal_skip"] = phase_causal_skip(SEED + 52)
    predicted = phase_dryrun(*dryrun)
    paths["dryrun_card"] = phase_dryrun_card(predicted, SEED + 50)
    paths["fsdp"] = phase_fsdp(predicted, SEED + 51)

    # each kernel's launches are read from the path that runs it
    main_path = {"flash_attention": ARCH, "flash_attention_bwd": "training",
                 "ssd_scan": SSM_ARCH, "ssd_scan_bwd": "training_mamba2",
                 "moe_gmm": MOE_ARCH, "moe_gmm_bwd": "training_dbrx",
                 "quantize": "collectives",
                 "dequantize": "collectives", "sparsify": "codecs",
                 "matmul": "codecs"}
    kernels = []
    for name in WRAPPERS:
        t = timings[name]["path"]
        entry = {"name": name, **KERNEL_INFO[name],
                 "launches": paths[main_path[name]][name],
                 "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "shape": t["shape"], "dtype": t["dtype"],
                 **{key: t[key] for key in (
                     "variant", "split", "products", "graph_ms",
                     "library_graph_ms", "library_backend",
                     "launches_per_call", "stage_ms", "bound_tc_ms",
                     "bound_tc_by") if key in t},
                 "path": main_path[name],
                 "launches_by_path": {p: c.get(name, 0)
                                      for p, c in paths.items()}}
        check(entry["launches"] > 0,
              f"kernel {name} was not launched on its path "
              f"{main_path[name]}")
        for key, extra in timings[name].items():  # other shapes timed
            if key != "path":
                entry[key] = extra
        kernels.append(entry)
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
