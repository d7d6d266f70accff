"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode continuously, reporting per-step latency and aggregate tokens/s;
the port's copy of ``examples/serve_batch.py``.  Works for every
architecture family, including the attention-free (mamba2) and hybrid
(jamba) decode paths.  It runs on the card unless ``--device cpu`` asks
for the host; on the card the step times are taken after a
``torch.cuda.synchronize``.

    PYTHONPATH=src python examples/torch_serve_batch.py --arch mamba2-130m

``--codesign`` adds the modeled half: a serving tenant co-scheduled next
to a training tenant on a shared fat-tree via ``plan_cluster``, printing
SLO attainment and the naive-vs-staggered tail latency
(``repro_torch.codesign.serving``).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.data import audio_frames, vision_patches
from repro_torch.models import encode, init_cache, init_params
from repro_torch.serve import make_serve_step


def codesign_cotenancy():
    """Mixed training + serving co-tenancy through the codesign engine:
    one DP-4 training tenant and one disaggregated serving tenant share
    the tor<->agg uplinks of an oversubscribed fat-tree."""
    from repro_torch.codesign import (JobSpec, ServingSLO, ServingSpec,
                                      plan_cluster)
    from repro_torch.configs import get_config
    from repro_torch.core.demand_builder import DemandParams
    from repro_torch.core.types import MeshConfig, SHAPES_BY_NAME
    from repro_torch.net.topology import fat_tree
    from repro_torch.sched.arrivals import PoissonArrivals

    topo = fat_tree(num_hosts=4, gpus_per_host=2, hosts_per_rack=2,
                    nic_bw=2e9, agg_bw=8e9, oversub=4.0, pcie_bw=4e9)
    cfg = get_config("qwen2-0.5b")
    mesh = MeshConfig(shape=(4,), axis_names=("data",),
                      data_axes=("data",), model_axes=())
    train = JobSpec("train", cfg, SHAPES_BY_NAME["train_4k"], mesh,
                    policy="serial",
                    devices=topo.hosts[0] + topo.hosts[2],
                    dp_params=DemandParams(zero1=False))
    svc = ServingSpec(name="svc", cfg=cfg, prefill_devices=2,
                      decode_devices=2,
                      arrivals=PoissonArrivals(rate_rps=3.0,
                                               prompt_tokens=1024,
                                               decode_tokens=32, seed=0),
                      slo=ServingSLO(ttft_s=0.05, tpot_s=0.01),
                      prefill_batch=1, decode_slots=8, horizon_s=8.0)
    serve = JobSpec("svc", serving=svc,
                    devices=topo.hosts[1] + topo.hosts[3])
    rep = plan_cluster([train, serve], topo, grid=6)
    sm = rep.serving["svc"]
    print(f"\nco-tenancy on shared fabric "
          f"({len(rep.contended)} contended links):")
    print(f"  training JCT: solo {rep.solo_jct['train']:.3f}s -> "
          f"co-tenant {rep.staggered_jct['train']:.3f}s")
    print(f"  serving burst stretch: naive "
          f"{sm['naive_burst_stretch']:.4f} -> staggered "
          f"{sm['staggered_burst_stretch']:.4f}")
    print(f"  serving TTFT p99: naive {sm['naive_ttft_p99']*1e3:.2f}ms "
          f"-> staggered {sm['staggered_ttft_p99']*1e3:.2f}ms")
    print(f"  SLO attainment: {sm['staggered_slo_attainment']:.2%}  "
          f"goodput {sm['staggered_goodput']:.1f} req/s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--codesign", action="store_true",
                    help="also model training/serving co-tenancy on a "
                         "shared fat-tree (plan_cluster)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    print(f"serving {cfg.name}: batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen_len}")

    context = None
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            context = encode(cfg, params, torch.from_numpy(
                audio_frames(cfg, args.batch)).to(device))
            print(f"  encoder context: {tuple(context.shape)}")
        elif cfg.cross_attn_period:
            context = torch.from_numpy(vision_patches(cfg, args.batch)) \
                .to(device)
            print(f"  vision context: {tuple(context.shape)}")

    max_len = args.prompt_len + args.gen_len
    cache = init_cache(cfg, params, args.batch, max_len, context=context)
    serve = make_serve_step(cfg, temperature=args.temperature)
    gen = torch.Generator(device=device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), device=device,
                            generator=gen)
    outs, lat = [], []
    with torch.no_grad():
        # prefill by feeding the prompt through decode steps (cache-exact)
        tok = None
        t0 = time.time()
        for t in range(args.prompt_len):
            tok, _, cache = serve(params, cache, prompts[:, t:t + 1], t,
                                  gen)
        sync()
        prefill_s = time.time() - t0
        for t in range(args.prompt_len, max_len):
            t1 = time.time()
            tok, _, cache = serve(params, cache, tok, t, gen)
            sync()
            lat.append(time.time() - t1)
            outs.append(tok[:, 0].cpu().numpy())
    out = np.stack(outs, axis=1)
    assert out.max() < cfg.vocab_size  # padding logits masked
    total = args.batch * args.gen_len
    print(f"prefill: {prefill_s*1e3:.1f} ms")
    print(f"decode:  p50={np.percentile(lat, 50)*1e3:.2f} ms/step  "
          f"p99={np.percentile(lat, 99)*1e3:.2f} ms/step  "
          f"throughput={total/sum(lat):,.0f} tok/s")
    print("sample:", out[0][:24].tolist())

    if args.codesign:
        codesign_cotenancy()


if __name__ == "__main__":
    main()
