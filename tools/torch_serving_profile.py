#!/usr/bin/env python3
"""Where the time of the port's serving path goes on the card.

    python3 tools/torch_serving_profile.py [--arch qwen2-0.5b] [--steps 20]

One model at full width in bf16, on one card (dbrx-132b cut to 4 of its
40 layers, which is what one card holds):
times a prefill (B 4 x S 512; dbrx-132b B 2 x S 256) and the decode steps
of a 4-slot ContinuousBatcher, first with the profiler off (host clock
around synchronised work), then under torch.profiler.  Prints one JSON line per window: wall time, device busy
time (the sum of kernel times; one stream, so kernels do not overlap), the
device's idle share, kernel launches and host-side operator calls, and the
kernels that take the most device time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import SOURCES, _build  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import make_prefill  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher  # noqa: E402


def _window(name, fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3 / reps
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    host_ops = sum(a.count for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU
                   and a.key.startswith("aten::"))
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:12]
    print(json.dumps({
        "window": name, "reps": reps, "wall_ms": wall_ms,
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
        "kernel_launches": sum(a.count for a in kernels) / reps,
        "aten_calls": host_ops / reps,
        "top_kernels": [{"name": a.key[:90], "calls": a.count / reps,
                         "ms": a.self_device_time_total / 1e3 / reps}
                        for a in top]}), flush=True)


# depth that one card holds in bf16 where the full model does not fit
LAYERS = {"dbrx-132b": 4}
PREFILL_SHAPE = {"dbrx-132b": (2, 256)}  # (B, S); others B 4 x S 512


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the families that take a context (cross-attention, encoder) are
    # profiled by chip_smoke.py's serving phases, not here
    ap.add_argument("--arch", default="qwen2-0.5b", choices=[
        a for a in ARCHS if not (get_config(a).cross_attn_period
                                 or get_config(a).is_encoder_decoder)])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_serving_profile: needs a CUDA card")
    _build.build(list(SOURCES.values()))
    cfg = get_config(args.arch)
    if args.arch in LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=LAYERS[args.arch])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(args.seed)
    print(json.dumps({"arch": args.arch, "layers": cfg.num_layers,
                      "dtype": "bfloat16"}), flush=True)

    prefill = make_prefill(cfg)
    b, s = PREFILL_SHAPE.get(args.arch, (4, 512))
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    prefill(params, tokens)  # warm-up: cuBLAS handles, kernel load
    _window(f"prefill_b{b}_s{s}", lambda: prefill(params, tokens), 3)
    del tokens
    torch.cuda.empty_cache()

    # decode steps with all 4 slots busy: prompts of 8 tokens, then a long
    # generation, so the window sees the steady state of a full batch
    batcher = ContinuousBatcher(cfg, params, max_slots=4, max_len=1024,
                                cache_dtype=torch.bfloat16)
    for rid in range(4):
        batcher.submit(list(map(int, rng.integers(0, cfg.vocab_size, 8))),
                       1000, rid)
    for _ in range(16):
        batcher.step()
    _window("decode_step_4_slots", batcher.step, args.steps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.splitlines()[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
