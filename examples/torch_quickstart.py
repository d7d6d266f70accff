"""Quickstart on the PyTorch port: build a reduced model, train it on the
synthetic pipeline, then decode from it; the port's copy of
``examples/quickstart.py``.  It runs on the card (the flash-attention,
SSD-scan and grouped-GEMM kernels where the model takes them) unless
``--device cpu`` asks for the host.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch dbrx-132b]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.core.types import TrainConfig
from repro_torch.data import make_batches
from repro_torch.models import init_cache, init_params
from repro_torch.optim import init_opt_state
from repro_torch.serve import make_serve_step
from repro_torch.train import make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # 1) a reduced (CPU-sized) variant of the assigned architecture
    cfg = smoke_config(args.arch)
    print(f"config: {cfg.name} ({cfg.family}), "
          f"{cfg.param_counts()['total']/1e6:.1f}M params")

    # 2) train on the deterministic synthetic pipeline
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5,
                       total_steps=args.steps, remat=False)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg)
    for i, batch in zip(range(args.steps),
                        make_batches(cfg, batch_size=8, seq_len=64)):
        params, opt, m = step(params, opt, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}")

    # 3) greedy decode: the model should continue the learned bigram chain
    prompt = torch.tensor([[1, 2, 3, 4]], device=device) % cfg.vocab_size
    cache = init_cache(cfg, params, 1, 64)
    serve = make_serve_step(cfg)
    tok = None
    with torch.no_grad():
        for t in range(prompt.shape[1]):
            tok, _, cache = serve(params, cache, prompt[:, t:t + 1], t)
        out = [int(tok[0, 0])]
        for t in range(prompt.shape[1], prompt.shape[1] + 12):
            tok, _, cache = serve(params, cache, tok, t)
            out.append(int(tok[0, 0]))
    print("prompt:", prompt[0].tolist(), "-> generated:", out)


if __name__ == "__main__":
    main()
