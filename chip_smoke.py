#!/usr/bin/env python3
"""Drives the PyTorch / H100 port's serving path on one card and checks it.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and nothing else of the repo
but ``src/repro_torch``.  Phases, each printing JSON lines; any failure
exits non-zero:

1. build: compiles every kernel of the path from ``src/repro_torch`` with
   nvcc into ``build/`` (one nvcc per source, all started together).
2. kernels: each kernel against its plain PyTorch version on the card, at
   the JAX kernel tests' shapes and the path's own; times at the path's
   shapes beside the plain version, one PyTorch library call and the bound.
3. parity: qwen2-0.5b at full width (24 layers) in f32: prefill logits
   (through the kernel) against replaying the prompt through decode_step
   (no kernel), at every position, and the greedy next token.
4. serving (the main path): qwen2-0.5b at full width in bf16: make_prefill
   on batches of prompts, then a ContinuousBatcher answering requests.
   Launch counts are set to 0 just before and read just after.
5. The kernels line, the card's name and power limit, and last the line
   {"ok": true, "device": {...}}.
"""
from __future__ import annotations

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
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.serve.batcher import ContinuousBatcher
except ImportError as e:  # run outside the repo, or without torch
    sys.exit(f"chip_smoke: cannot import the port ({e}); run it from the "
             f"root of the repository")

SEED = 0
ARCH = "qwen2-0.5b"
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
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
# 3. full-width parity in f32: prefill (kernel) vs decode replay (no kernel)
# --------------------------------------------------------------------------

def phase_parity(rng) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    b, s = 2, 256
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).to(DEVICE)

    n0 = flash_attention.launches
    logits = make_prefill(cfg)(params, tokens)
    torch.cuda.synchronize()
    launched = flash_attention.launches - n0
    check(launched == cfg.num_layers,
          f"prefill launched flash_attention {launched} times, want "
          f"{cfg.num_layers} (one per layer)")

    cache = init_cache(cfg, params, b, s)
    serve = make_serve_step(cfg)
    n0 = flash_attention.launches
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
    check(flash_attention.launches == n0,
          "decode_step launched the prefill kernel")
    greedy_prefill = logits[:, -1].argmax(-1)
    top2 = logits[:, -1].topk(2, dim=-1).values
    result = {"phase": "parity", "arch": ARCH, "dtype": "float32",
              "layers": cfg.num_layers, "batch": b, "seq": s,
              "kernel_launches": launched,
              "max_abs_err": float(max_err), "tol": PARITY_TOL,
              "logit_max_abs": float(logits[:, :, :cfg.vocab_size].abs()
                                     .max()),
              "greedy_prefill": greedy_prefill.tolist(),
              "greedy_decode": tok[:, 0].tolist(),
              "top2_gap": (top2[:, 0] - top2[:, 1]).tolist()}
    emit(result)
    check(float(excess) <= 0,
          f"prefill and decode replay disagree beyond {PARITY_TOL}: max "
          f"|err| {float(max_err)}")
    check(torch.equal(greedy_prefill, tok[:, 0]),
          "greedy token after the prompt differs between prefill and "
          "decode replay")


# --------------------------------------------------------------------------
# 4. serving, the main path
# --------------------------------------------------------------------------

def phase_serving(rng) -> dict:
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=DEVICE)
    n_params = sum(t.numel() for t in _leaves(params))
    prefill = make_prefill(cfg)
    prompts = {s: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, s))).to(DEVICE)
        for s in (128, 256, 512)}
    requests = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
                for n in rng.integers(128, 257, 6)]
    batcher = ContinuousBatcher(cfg, params, max_slots=4, max_len=320,
                                cache_dtype=torch.bfloat16)
    for rid, prompt in enumerate(requests):
        batcher.submit(prompt, 32, rid)
    torch.cuda.synchronize()

    reset_launch_counts()
    prefill_ms = {}
    for s, tokens in prompts.items():
        t0 = time.perf_counter()
        logits = prefill(params, tokens)
        torch.cuda.synchronize()
        prefill_ms[s] = 1e3 * (time.perf_counter() - t0)
        check(tuple(logits.shape) == (4, s, cfg.padded_vocab),
              f"prefill logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits[..., :cfg.vocab_size].float())
                   .all()), f"non-finite prefill logits at S={s}")
        check(int(logits.argmax(-1).max()) < cfg.vocab_size,
              "prefill argmax picked a padded vocabulary id")
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
        check(len(r.out) == 32, f"request {r.rid} emitted {len(r.out)}")
        check(max(r.out) < cfg.vocab_size,
              f"request {r.rid} emitted a padded id")
    check(any(r.t_admit > 0 for r in done.values()),
          "no request was admitted mid-flight")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    generated = sum(len(r.out) for r in done.values())
    ingested = sum(len(p) for p in requests)
    emit({"phase": "serving", "arch": ARCH, "dtype": "bfloat16",
          "params": n_params, "layers": cfg.num_layers,
          "prefill_batch": 4, "prefill_ms": prefill_ms,
          "slots": 4, "requests": len(requests), "new_tokens_each": 32,
          "prompt_tokens": ingested, "steps": len(step_ms),
          "run_s": run_s, "generated_tokens_per_s": generated / run_s,
          "step_ms_p50": float(np.percentile(step_ms, 50)),
          "step_ms_p99": float(np.percentile(step_ms, 99)),
          "admitted_at": {r.rid: r.t_admit for r in done.values()},
          "launches": counts})
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script checks the "
              "port on the card only", file=sys.stderr)
        return 2
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    rng = np.random.default_rng(SEED)
    phase_build()
    timings = phase_kernels(rng)
    phase_parity(rng)
    counts = phase_serving(rng)

    kernels = []
    for name in WRAPPERS:
        t = timings[name]["path"]
        kernels.append({"name": name, **KERNEL_INFO[name],
                        "launches": counts[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "shape": t["shape"],
                        "dtype": t["dtype"]})
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
