#!/usr/bin/env python3
"""Where the time of the port's codec path goes on the card.

    python3 tools/torch_codec_profile.py [--reps 2]

qwen2-0.5b's stand-in gradient (one seeded tensor per parameter, f32, full
width and depth) through one encode + decode step of each codec (q8, q4,
topk, lowrank) and through the payload-level quantize/dequantize over the
flattened gradient, each first with the profiler off, then under
torch.profiler.  Prints one JSON line per window (the fields of
``tools/torch_serving_profile.py``): wall time, device busy time, the
device's idle share, kernel launches, host-side operator calls and the
kernels that take the most device time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.compress import get_codec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import SOURCES, _build  # noqa: E402
from repro_torch.kernels.compress import ops  # noqa: E402
from repro_torch.models import init_params, param_leaves  # noqa: E402
from torch_serving_profile import _window  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_codec_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(list(SOURCES.values()))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(get_config("qwen2-0.5b"), gen, dtype=torch.float32,
                         device="cuda")
    grads = list(param_leaves(params))
    for g in grads:
        g.normal_(generator=gen)  # the stand-in gradient, in place
    print(json.dumps({"arch": "qwen2-0.5b", "tensors": len(grads),
                      "values": sum(g.numel() for g in grads)}), flush=True)

    for name in ("q8", "q4", "topk", "lowrank"):
        codec = get_codec(name)
        states = [codec.init_state(g) for g in grads]

        def step():
            for i, g in enumerate(grads):
                enc, states[i] = codec.encode(g, states[i])
                codec.decode(enc)

        step()  # warm-up
        _window(f"codec_{name}_step", step, args.reps)

    flat = torch.cat([g.reshape(-1) for g in grads])

    def payload():
        q, s, shape = ops.quantize(flat)
        ops.dequantize(q, s, shape)

    payload()
    _window("payload_quantize_dequantize", payload, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
