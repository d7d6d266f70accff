#!/usr/bin/env python3
"""How close the SSD scan's versions come to an f64 recurrence, at the
mamba2-130m prefill shape and a long scan, with the model's decays.

    python3 tools/ssd_scan_accuracy.py [--device cpu|cuda]

Inputs are drawn as ``chip_smoke.py`` draws them (seeded numpy).  For each
shape it prints |err| / max(|ref|, 1) against y_t = C_t h_t, h_t = h_{t-1}
exp(dt_t a) + x_t (dt_t B_t), one row at a time in f64, of: the plain
version (``ssd_scan_ref``, the model's chunk 256), the same with its
segment sums taken as differences of one cumsum (the JAX package's
form), the kernel's three stages in plain PyTorch with f32,
3xTF32 and one-TF32 products (``ssd_scan_staged``), and, on the card, the
kernel.  The kernel tolerance is 3e-5 of that scale.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.kernels.ssd_scan import ref as sref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

SHAPES = [(4, 24, 512, 64, 128), (1, 4, 4096, 64, 128)]


def inputs(rng, b, h, l, p, n, device):
    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * scale).to(device)
    x = mk(b, l, h, p, scale=0.5).permute(0, 2, 1, 3)
    dt = torch.nn.functional.softplus(mk(b, l, h)).permute(0, 2, 1)
    a = -torch.linspace(1.0, 16.0, h, device=device)
    return x, dt, a, mk(b, l, n, scale=0.3), mk(b, l, n, scale=0.3)


def recurrence_f64(x, dt, a, b, c):
    x, dt, a, b, c = (v.double() for v in (x, dt, a, b, c))
    bsz, h, l, p = x.shape
    state = torch.zeros(bsz, h, p, b.shape[-1], dtype=torch.float64,
                        device=x.device)
    ys = []
    for t in range(l):
        state = state * torch.exp(dt[:, :, t] * a)[..., None, None] + \
            x[:, :, t, :, None] * (dt[:, :, t, None, None]
                                   * b[:, None, t, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=2)


def segsum_difference(dac):
    """The segment sums as cs_i - cs_j of one cumsum."""
    q = dac.shape[-1]
    cs = torch.cumsum(dac, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=dac.device))
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("ssd_scan_accuracy: no CUDA card (use --device cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    for shape in SHAPES:
        args_ = inputs(rng, *shape, args.device)
        ref = recurrence_f64(*args_)
        scale = max(float(ref.abs().max()), 1.0)

        def err(y):
            return float((y.double() - ref).abs().max()) / scale

        row = {"shape": list(shape), "device": args.device, "scale": scale,
               "plain": err(sref.ssd_scan_ref(*args_, chunk=256))}
        stable = sref._segsum
        sref._segsum = segsum_difference
        try:
            row["plain_difference_segsum"] = err(
                sref.ssd_scan_ref(*args_, chunk=256))
        finally:
            sref._segsum = stable
        for product in ("f32", "3xtf32", "tf32"):
            row[f"staged_{product}"] = err(
                sref.ssd_scan_staged(*args_, product=product))
        if args.device == "cuda":
            row["kernel"] = err(ssd_scan(*args_, chunk=256))
            row["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
