"""End-to-end training driver on the PyTorch port: a ~100M-parameter dense
model trained for a few hundred steps on the synthetic pipeline, with LR
schedule, gradient clipping, checkpointing and eval; the port's copy of
``examples/train_100m.py``.  It runs on the card (flash attention and its
backward kernel) unless ``--device cpu`` asks for the host.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300

CPU note: ~100M params at seq 256 is a few seconds/step on one core; use
``--d-model 384 --layers 6 --steps 100`` for a faster demonstration run.
"""
import argparse
import dataclasses
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.types import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim import init_opt_state
from repro_torch.train import make_eval_step, make_train_step


def build_config(args):
    """~100M-param member of the qwen2 family (GQA + QKV-bias + SwiGLU)."""
    base = get_config("qwen2-0.5b")
    return dataclasses.replace(
        base, name="qwen2-100m", num_layers=args.layers,
        d_model=args.d_model, num_heads=args.d_model // 64, num_kv_heads=2,
        head_dim=64, d_ff=args.d_model * 4, vocab_size=args.vocab,
        tie_embeddings=True, max_seq_len=args.seq)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=640)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m"))
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = build_config(args)
    n = cfg.param_counts()["total"]
    print(f"model: {cfg.name} = {n/1e6:.1f}M params "
          f"(L={cfg.num_layers}, d={cfg.d_model}, V={cfg.vocab_size})")

    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=20,
                       total_steps=args.steps, grad_clip=1.0, remat=False)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg)
    evaluate = make_eval_step(cfg)

    # same seed => same bigram permutation; eval uses a held-out epoch so
    # the sequences (start tokens) differ but the task is the same
    train_ds = SyntheticLM(cfg.vocab_size, args.seq, seed=0)
    eval_ds = SyntheticLM(cfg.vocab_size, args.seq, seed=0)
    eval_batch = eval_ds.batch(1, 0, args.batch)
    uniform = math.log(cfg.vocab_size)
    print(f"uniform-baseline loss = {uniform:.3f}")

    t0 = time.time()
    for i in range(args.steps):
        batch = train_ds.batch(0, i * args.batch, args.batch)
        params, opt, m = step(params, opt, batch)
        if i % 10 == 0 or i == args.steps - 1:
            tps = (i + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f} tok/s={tps:,.0f}")
        if i and i % args.eval_every == 0:
            print(f"  eval ce={float(evaluate(params, eval_batch)):.4f}")

    eval_ce = float(evaluate(params, eval_batch))
    print(f"final eval ce={eval_ce:.4f} (uniform {uniform:.3f})")
    path = save_checkpoint(cfg, args.ckpt_dir, args.steps, params, opt,
                           extra={"eval_ce": f"{eval_ce:.6f}"})
    print(f"checkpoint written: {path}")
    _, _, s = restore_checkpoint(cfg, path, params)
    assert s == args.steps
    print("checkpoint restore verified")


if __name__ == "__main__":
    main()
