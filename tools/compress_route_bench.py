#!/usr/bin/env python3
"""Device times of K4's two routes for M^T @ P and of K2b's variants.

    python3 tools/compress_route_bench.py [--iters 10]

For every distinct M^T @ P that LowRankCodec computes over qwen2-0.5b's
gradient (M^T the transposed view of a tensor's matrix, P its QR factor,
column-major), and for sizes between the codec's where the two cross, the
device time of the streamed route ("cols_bulk") and of the per-row route
("cols"), both through the same C entry point, with the route the wrapper
takes, torch.matmul beside them, the byte bound and how often the codec
meets the shape (0 for the sizes between).  Then K2b at a ring chunk and
at the gradient's rows of 256 on each of its variants.  Times replay the
calls from a CUDA graph (``chip_smoke.graph_ms``): the device alone.  Last
the host's microseconds a call of the wrappers and of what they are made
of, on an input small enough that the card never sets the pace.  One JSON
line per case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from chip_smoke import (LOWRANK_RANK, RING_CHUNK, ROW_LEN,  # noqa: E402
                        dequantize_bound, graph_ms, matmul_bound)
from repro_torch.compress import get_codec  # noqa: E402
from repro_torch.compress.lowrank import _matrix_shape  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.compress import ops  # noqa: E402
from repro_torch.models import init_params, param_leaves  # noqa: E402


def _matmul_on(route: str, a, b):
    """M^T @ P through the entry point on ``route``, as the wrapper calls
    it (the wrapper itself takes the route the layout gives)."""
    (m, k), n = a.shape, b.shape[1]
    code = ops._ROUTE_CODES[route]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ws = ops._matmul_workspace(m, n, k, code, 0)
    work = torch.empty((max(ws, 1),), dtype=torch.float32, device=a.device)
    rc = ops._lib().compress_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), work.data_ptr(), m, n,
        k, *a.stride(), *b.stride(), 0, code,
        _build.raw_stream(a.device))
    if rc >> 4:
        raise RuntimeError(f"{route} failed: CUDA error {rc >> 4}")
    return out


def _dequantize_on(variant: str, q, s):
    m, n = q.shape
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    rc = ops._lib().compress_dequantize(
        q.data_ptr(), s.data_ptr(), out.data_ptr(), m, n,
        ops._DQ_CODES[variant], _build.raw_stream(q.device))
    if rc >> 4:
        raise RuntimeError(f"{variant} failed: CUDA error {rc >> 4}")
    return out


def host_us(fn, n: int) -> float:
    """Host microseconds a call over ``n`` calls, after a warm-up."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compress_route_bench: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build([ops.SOURCE])
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(get_config("qwen2-0.5b"), torch.Generator(),
                         device="meta")
    shapes = collections.Counter(_matrix_shape(tuple(t.shape))
                                 for t in param_leaves(params))
    # M of the embedding's width between the MLP's 17 MB and the
    # embedding's 545 MB
    for rows in (9_504, 19_008, 38_016, 76_032):
        shapes[(rows, 896)] += 0
    codec = get_codec("lowrank")
    for (rows, cols), count in sorted(shapes.items(),
                                      key=lambda kv: -kv[0][0] * kv[0][1]):
        mat = torch.randn((rows, cols), generator=gen, device=dev)
        r = min(LOWRANK_RANK, rows, cols)
        p, _ = torch.linalg.qr(ops.matmul_kernel(
            mat, codec._test_matrix(cols, r, dev)))
        a = mat.T
        ref = torch.matmul(a, p)
        times = {}
        for route in ("cols_bulk", "cols"):
            err = float((_matmul_on(route, a, p) - ref).abs().max())
            times[route] = {"graph_ms": graph_ms(
                lambda: _matmul_on(route, a, p), args.iters),
                "max_abs_err_vs_torch": err}
        bound_ms, bound_by = matmul_bound(cols, rows, r)
        print(json.dumps({
            "kernel": "matmul", "product": "M^T @ P", "a": [cols, rows],
            "a_strides": list(a.stride()), "p_strides": list(p.stride()),
            "tensors": count, "wrapper_route": ops.matmul_variant(a, p),
            **times, "library_graph_ms": graph_ms(
                lambda: torch.matmul(a, p), args.iters),
            "bound_ms": bound_ms, "bound_by": bound_by}), flush=True)
        del mat, p, a, ref

    for label, (m, n) in (("ring chunk", (1, RING_CHUNK)),
                          ("gradient rows", (1_930_264, ROW_LEN))):
        q = torch.randint(-127, 128, (m, n), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((m, 1), generator=gen, device=dev) + 0.01
        ref = torch.mul(q, s)
        iters = args.iters * (20 if m == 1 else 1)
        times = {}
        for variant in ("vec16", "vec4", "scalar"):
            bad = int((_dequantize_on(variant, q, s) != ref).sum())
            times[variant] = {"graph_ms": graph_ms(
                lambda: _dequantize_on(variant, q, s), iters),
                "mismatches_vs_torch_mul": bad}
        bound_ms, bound_by = dequantize_bound(m, n)
        print(json.dumps({
            "kernel": "dequantize", "case": label, "shape": [m, n],
            "wrapper_variant": ops.dequantize_variant(n, q.data_ptr()),
            **times, "library_graph_ms": graph_ms(lambda: torch.mul(q, s),
                                                  iters),
            "bound_ms": bound_ms, "bound_by": bound_by}), flush=True)
        del q, s, ref
    # host cost a call, on an input small enough that the card never sets
    # the pace (a 4,096-value row: ~2 us of device time)
    q = torch.randint(-127, 128, (1, 4096), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((1, 1), generator=gen, device=dev) + 0.01
    x = torch.randn((1, 4096), generator=gen, device=dev)
    out = torch.empty((1, 4096), device=dev)
    entry, stream = ops._lib().compress_dequantize, _build.raw_stream(dev)
    ptrs = (q.data_ptr(), s.data_ptr(), out.data_ptr())
    calls = {
        "dequantize_kernel": lambda: ops.dequantize_kernel(q, s),
        "torch.mul(q, scale)": lambda: torch.mul(q, s),
        "quantize_kernel": lambda: ops.quantize_kernel(x),
        "torch.empty(m, n, dtype=, device=)": lambda: torch.empty(
            1, 4096, dtype=torch.float32, device=dev),
        "torch.empty((m, n), dtype=, device=)": lambda: torch.empty(
            (1, 4096), dtype=torch.float32, device=dev),
        "compress_dequantize entry point (ctypes + launch)":
            lambda: entry(*ptrs, 1, 4096, 0, stream),
        "compress_dequantize refusing m = 0 (ctypes alone)":
            lambda: entry(*ptrs, 0, 4096, 0, stream)}
    for rnd in range(2):  # the host's speed drifts: two rounds, in turns
        for name, fn in calls.items():
            print(json.dumps({"host_us_a_call": name, "round": rnd,
                              "us": host_us(fn, 4000)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
