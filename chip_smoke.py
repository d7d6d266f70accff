#!/usr/bin/env python3
"""Drives the PyTorch / H100 port's serving paths on one card and checks them.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and nothing else of the repo
but ``src/repro_torch``.  Phases, each printing JSON lines; any failure
exits non-zero:

1. build: compiles every kernel from ``src/repro_torch`` with nvcc into
   ``build/`` (one nvcc per source, all started together).
2. kernels: each kernel (flash attention K1, SSD scan K6, grouped expert
   GEMM K5) against its plain PyTorch version on the card, at the JAX
   kernel tests' shapes and the paths' own; times at the paths' shapes
   beside the plain version, one PyTorch library call (where one exists)
   and the bound.
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
     K5).
   Each model's parameters are freed before the next model is built.
4. The kernels line, the card's name and power limit, and last the line
   {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

try:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import (SOURCES, WRAPPERS, _build, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    from repro_torch.models import init_cache, init_params, prefill_launches
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.serve.batcher import ContinuousBatcher
except ImportError as e:  # run outside the repo, or without torch
    sys.exit(f"chip_smoke: cannot import the port ({e}); run it from the "
             f"root of the repository")

SEED = 0
ARCH = "qwen2-0.5b"
SSM_ARCH = "mamba2-130m"
MOE_ARCH = "dbrx-132b"
MOE_PARITY_LAYERS = 2   # 31 GB in f32; all 40 layers (264 GB) fit no card
MOE_SERVE_LAYERS = 4    # 28.6 GB in bf16
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
PEAK_BYTES = 3.35e12
KERNEL_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
              torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
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
    "ssd_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:69",
    },
    "moe_gmm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:40",
    },
}


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


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.time()
    libs = _build.build(list(SOURCES.values()))
    seconds = time.time() - t0
    ptxas = {}
    for src, lib in libs.items():
        log = lib.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[src.name] = [ln.split("ptxas info    :")[-1].strip()
                           for ln in lines
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds,
          "libraries": [str(p.relative_to(ROOT)) for p in libs.values()],
          "ptxas": ptxas})


# --------------------------------------------------------------------------
# 2. kernel against its plain version
# --------------------------------------------------------------------------

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
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def _qkv(rng, b, h, kv, sq, sk, d, dtype):
    def mk(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(DEVICE).to(dtype)
    return mk(b, h, sq, d), mk(b, kv, sk, d), mk(b, kv, sk, d)


# the sweep of tests/test_kernels.py:21-28 (both dtypes, causal / full /
# window 128; GQA, MQA, rectangular), plus head dims 32, 80, 128, ragged
# lengths, group size 7, and the serving path's prefill shapes
_SWEEP = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
          (1, 8, 1, 256, 512, 128)]
_MASKS = [(True, None), (False, None), (True, 128)]
PATH_SHAPE = (4, 14, 2, 512, 512, 64)   # qwen2-0.5b prefill, B 4 x S 512
LONG_SHAPE = (1, 14, 2, 4096, 4096, 64)


def _kernel_cases():
    cases = [(s, c, w, dt) for dt in (torch.float32, torch.bfloat16)
             for s in _SWEEP for c, w in _MASKS]
    for dt in (torch.float32, torch.bfloat16):
        cases += [((1, 8, 2, 256, 256, 80), True, 128, dt),
                  ((2, 4, 2, 200, 200, 32), True, None, dt),
                  ((1, 14, 2, 300, 300, 64), True, 128, dt),
                  ((1, 4, 1, 100, 300, 128), False, 64, dt),
                  ((1, 4, 2, 300, 100, 64), True, 32, dt),
                  (PATH_SHAPE, True, None, dt)]
    cases.append((LONG_SHAPE, True, None, torch.bfloat16))
    return cases


def phase_kernels(rng) -> dict:
    for shape, causal, window, dtype in _kernel_cases():
        q, k, v = _qkv(rng, *shape, dtype)
        out = flash_attention(q, k, v, causal=causal, window=window)
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
              "causal": causal, "window": window, "max_abs_err": max_err,
              "tol": tol, "mismatches": bad, "finite": finite})
        check(finite and bad == 0,
              f"flash_attention disagrees with attention_ref at {shape} "
              f"{dtype} causal={causal} window={window}: {bad} elements "
              f"out of tolerance, max |err| {max_err}")

    timings = {}
    for name, shape, iters in (("path", PATH_SHAPE, 50),
                               ("long", LONG_SHAPE, 10)):
        q, k, v = _qkv(rng, *shape, torch.bfloat16)
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True),
                           max(2, iters // 5))
        # yardstick only: the port never calls it
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters)
        lib_err = float((F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True).float()
            - attention_ref(q, k, v, causal=True).float()).abs().max())
        max_err = float((flash_attention(q, k, v, causal=True).float()
                         - attention_ref(q, k, v, causal=True).float())
                        .abs().max())
        bound_ms, bound_by = attention_bound(*shape, True, None,
                                             torch.bfloat16)
        timings[name] = {"shape": list(shape), "dtype": "bfloat16",
                         "causal": True, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "max_abs_err": max_err,
                         "library_max_abs_err": lib_err}
        emit({"phase": "kernel_time", "kernel": "flash_attention",
              **timings[name]})
    return {"flash_attention": timings}


# --------------------------------------------------------------------------
# 2b. SSD scan (K6) against its plain version
# --------------------------------------------------------------------------

# tests/test_kernels.py:53-58, a ragged L, and mamba2-130m prefill at
# B 4 x S 512 (H 24, P 64, N 128, f32, the model's chunk 256)
_SSD_SWEEP = [(1, 2, 256, 64, 32, 64), (2, 4, 512, 64, 128, 128),
              (1, 2, 256, 128, 64, 256), (1, 3, 200, 32, 16, 256)]
SSD_PATH_SHAPE = (4, 24, 512, 64, 128, 256)


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
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


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
    ms = cuda_ms(lambda: ssd_scan(*args, chunk=chunk), 50)
    plain_ms = cuda_ms(lambda: ssd_scan_ref(*args, chunk=chunk), 10)
    bound_ms, bound_by = ssd_bound(*SSD_PATH_SHAPE[:5])
    timing = {"shape": list(SSD_PATH_SHAPE), "dtype": "float32", "ms": ms,
              "plain_ms": plain_ms, "library_ms": None,  # no single call
              "bound_ms": bound_ms, "bound_by": bound_by,
              "max_abs_err": path_err}
    emit({"phase": "kernel_time", "kernel": "ssd_scan", **timing})
    return {"path": timing}


# --------------------------------------------------------------------------
# 2c. grouped expert GEMM (K5) against its plain version
# --------------------------------------------------------------------------

# (E, C, d, f, x expanded over experts): tests/test_kernels.py:102-107,
# odd sizes, and dbrx-132b's products: decode (C = 4 slots) gate/up with
# the tokens expanded and down, prefill at B 2 x S 256 (C 512) and the f32
# parity prefill at B 2 x S 128 (C 256)
_GMM_SWEEP = [(2, 128, 256, 128, False), (4, 256, 512, 384, False),
              (16, 128, 256, 256, False), (3, 77, 100, 60, True)]
GMM_DECODE = (16, 4, 6144, 10752, True)
GMM_DECODE_DOWN = (16, 4, 10752, 6144, False)
GMM_PREFILL = (16, 512, 6144, 10752, True)
GMM_PARITY_PREFILL = (16, 256, 6144, 10752, True)


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
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_gmm_kernel(rng) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = [(s, dt) for dt in (torch.float32, torch.bfloat16)
             for s in _GMM_SWEEP]
    cases += [(GMM_DECODE, torch.bfloat16), (GMM_DECODE_DOWN, torch.bfloat16),
              (GMM_PREFILL, torch.bfloat16), (GMM_DECODE, torch.float32),
              (GMM_PARITY_PREFILL, torch.float32)]
    errs = {}
    for shape, dtype in cases:
        e, c, d, f, expand = shape
        path = shape in (GMM_DECODE, GMM_DECODE_DOWN, GMM_PREFILL,
                         GMM_PARITY_PREFILL)
        # the path's weights have the model's scale (dense_init: 1/sqrt(d));
        # the sweep's that of tests/test_kernels.py:108
        x, w = _gmm_inputs(rng, gen, *shape, dtype,
                           d ** -0.5 if path else 0.05)
        out = moe_gmm(x, w)
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
              "dtype": str(dtype).split(".")[-1], "max_abs_err": max_err,
              "tol": tol, "mismatches": bad, "finite": finite})
        check(finite and bad == 0,
              f"moe_gmm disagrees with moe_gmm_ref at {shape} {dtype}: "
              f"{bad} elements out of tolerance, max |err| {max_err}")
        del x, w, out, ref, err

    timings = {}
    for name, shape, iters in (("decode", GMM_DECODE, 20),
                               ("prefill", GMM_PREFILL, 5)):
        x, w = _gmm_inputs(rng, gen, *shape, torch.bfloat16,
                           shape[2] ** -0.5)
        ms = cuda_ms(lambda: moe_gmm(x, w), iters)
        plain_ms = cuda_ms(lambda: moe_gmm_ref(x, w), iters)
        # yardstick only: the port never calls it
        library_ms = cuda_ms(lambda: torch.matmul(x, w), iters)
        bound_ms, bound_by = gmm_bound(*shape, torch.bfloat16)
        timings[name] = {"shape": list(shape[:4]), "x_expert_stride_0": True,
                         "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by,
                         "max_abs_err": errs[(shape, torch.bfloat16)]}
        emit({"phase": "kernel_time", "kernel": "moe_gmm", **timings[name]})
        del x, w
    return {"path": timings["decode"], "prefill": timings["prefill"]}


# --------------------------------------------------------------------------
# 3. full-width parity in f32: prefill (kernels) vs decode replay
# --------------------------------------------------------------------------

def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def _release() -> None:
    """Return the freed blocks of a model to the card before the next one
    is built (the caller has dropped its references)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_parity(rng, cfg, b: int, s: int, seed: int):
    """Prefill logits through the kernels vs the prompt replayed through
    decode_step (which launches no K1 and no K6; K5 runs in decode too), at
    every position, and the greedy next token."""
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).to(DEVICE)

    n0 = launch_counts()
    logits = make_prefill(cfg)(params, tokens)
    torch.cuda.synchronize()
    launched = _delta(n0)
    check(launched == prefill_launches(cfg),
          f"prefill launched {launched}, want {prefill_launches(cfg)}")

    cache = init_cache(cfg, params, b, s)
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
    want = {"flash_attention": 0, "ssd_scan": 0,
            "moe_gmm": prefill_launches(cfg)["moe_gmm"] * s}
    check(decode_launched == want,
          f"decode replay launched {decode_launched}, want {want}")
    greedy_prefill = logits[:, -1].argmax(-1)
    top2 = logits[:, -1].topk(2, dim=-1).values
    result = {"phase": "parity", "arch": cfg.name, "dtype": "float32",
              "layers": cfg.num_layers, "batch": b, "seq": s,
              "kernel_launches": launched,
              "decode_kernel_launches": decode_launched,
              "max_abs_err": float(max_err), "tol": PARITY_TOL,
              "logit_max_abs": float(logits[:, :, :cfg.vocab_size].abs()
                                     .max()),
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
    n_params = sum(t.numel() for t in _leaves(params))
    prefill = make_prefill(cfg)
    prompts = {s: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (prefill_batch, s))).to(DEVICE)
        for s in prefill_lens}
    requests = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
                for n in rng.integers(prompt_lens[0], prompt_lens[1] + 1, 6)]
    batcher = ContinuousBatcher(cfg, params, max_slots=4, max_len=max_len,
                                cache_dtype=torch.bfloat16)
    for rid, prompt in enumerate(requests):
        batcher.submit(prompt, new_tokens, rid)
    torch.cuda.synchronize()

    reset_launch_counts()
    prefill_ms = {}
    for s, tokens in prompts.items():
        t0 = time.perf_counter()
        logits = prefill(params, tokens)
        torch.cuda.synchronize()
        prefill_ms[s] = 1e3 * (time.perf_counter() - t0)
        check(tuple(logits.shape) == (prefill_batch, s, cfg.padded_vocab),
              f"prefill logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits[..., :cfg.vocab_size].float())
                   .all()), f"non-finite prefill logits at S={s}")
        check(int(logits.argmax(-1).max()) < cfg.vocab_size,
              "prefill argmax picked a padded vocabulary id")
        del logits
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
          "device": torch.cuda.get_device_name(0)})
    rng = np.random.default_rng(SEED)
    phase_build()
    timings = phase_kernels(rng)
    timings["ssd_scan"] = phase_ssd_kernel(rng)
    timings["moe_gmm"] = phase_gmm_kernel(rng)
    paths = run_paths(rng)

    # each kernel's launches are read from the first path that runs it
    main_path = {"flash_attention": ARCH, "ssd_scan": SSM_ARCH,
                 "moe_gmm": MOE_ARCH}
    kernels = []
    for name in WRAPPERS:
        t = timings[name]["path"]
        entry = {"name": name, **KERNEL_INFO[name],
                 "launches": paths[main_path[name]][name],
                 "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "shape": t["shape"], "dtype": t["dtype"],
                 "path": main_path[name],
                 "launches_by_path": {p: c[name] for p, c in paths.items()}}
        if "prefill" in timings[name]:
            entry["prefill"] = timings[name]["prefill"]
        kernels.append(entry)
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    # count: the one card this script drives
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
