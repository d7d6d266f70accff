#!/usr/bin/env python3
"""K5-bwd and K6-bwd of one tree of the port, timed at the training paths'
shapes, for comparing two trees in turns on one card.

    python3 tools/bwd_kernel_compare.py [--tree DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there, and prints one JSON line: for K5-bwd (``moe_gmm_bwd``)
at dbrx-132b's gate / up product (E 16, T 512, d 6144, f 10752, the tokens
expanded), its down product (16, 512, 10752, 6144) and an expert-parallel
rank's (8, 160, 6144, 10752), bf16, the device ms of a call (the second of
two CUDA-graph captures) and of each launch (torch.profiler), and
``torch.bmm`` computing the same two products; for K6-bwd
(``ssd_scan_bwd``) at mamba2-130m's training microbatch (B 4 x L 512, H 24,
P 64, N 128, f32) the same, by stage; and the sha256 of K6's forward
output and of both gradients' outputs on fixed inputs, so that two trees
whose forward is the same show the same forward hash.  Run it in fresh
processes, the parent tree and this one in turns (parent, this, this,
parent).  Then the card's name and power limit.  Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys


def graph_ms(fn, iters: int) -> float:
    """Device ms of one call: ``iters`` calls in a CUDA graph, the second
    of two captures replayed three times."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    ms = None
    for _ in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
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


def launch_ms(fn, iters: int) -> dict:
    """Device ms a call of each kernel, by name (torch.profiler)."""
    import torch
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
        kernel = re.search(r"(\w+_kernel(?:<[^>]*>)?)", ev.key)
        if ev.device_type == DeviceType.CUDA and kernel:
            name = kernel.group(1)
            out[name] = out.get(name, 0.0) + \
                ev.self_device_time_total / 1e3 / iters
    return out


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


GMM_SHAPES = {"gate_up": (16, 512, 6144, 10752, True),
              "down": (16, 512, 10752, 6144, False),
              "ep_rank": (8, 160, 6144, 10752, False)}
SSD_SHAPE = (4, 24, 512, 64, 128)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_workspace

    out = {"tree": args.label or tree, "gmm": {}, "ssd": {}}
    for name, (e, c, d, f, expand) in GMM_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn((c, d) if expand else (e, c, d), device="cuda",
                        generator=gen).bfloat16()
        w = (torch.randn((e, d, f), device="cuda", generator=gen)
             * d ** -0.5).bfloat16()
        dy = torch.randn((e, c, f), device="cuda", generator=gen).bfloat16()
        xe = x.expand(e, c, d) if expand else x

        def kernel():
            return moe_gmm_bwd(x, w, dy, expanded=expand)

        def library():
            return (torch.bmm(dy, w.transpose(1, 2)),
                    torch.bmm(xe.transpose(1, 2), dy))

        got = kernel()
        out["gmm"][name] = {
            "graph_ms": graph_ms(kernel, 3), "launch_ms": launch_ms(kernel, 3),
            "variant": getattr(moe_gmm_bwd, "last_variant", None),
            "bmm_graph_ms": graph_ms(library, 3), "sha256": digest(*got)}
        del x, w, dy, xe, got
        torch.cuda.empty_cache()

    b, h, l, p, n = SSD_SHAPE
    rng = np.random.default_rng(5)

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * scale).cuda()

    x = mk(b, l, h, p, scale=0.5).permute(0, 2, 1, 3)
    dt = torch.nn.functional.softplus(mk(b, l, h)).permute(0, 2, 1)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    bb, cc = mk(b, l, n, scale=0.3), mk(b, l, n, scale=0.3)
    dy = mk(b, l, h, p).permute(0, 2, 1, 3)
    y, work = ssd_scan_workspace(x, dt, a, bb, cc)

    def kernel():
        return ssd_scan_bwd(x, dt, a, bb, cc, dy, workspace=work)

    out["ssd"] = {"graph_ms": graph_ms(kernel, 10),
                  "launch_ms": launch_ms(kernel, 10),
                  "forward_sha256": digest(y),
                  "sha256": digest(*kernel())}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
