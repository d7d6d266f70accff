#!/usr/bin/env python3
"""K3 (sparsify) design sweep on the card: the port's kernel against
variants of its grid and loads (``csrc/sparsify_variants.cu``) and
``F.hardshrink``, at qwen2-0.5b's gradient (494,147,584 f32 values).

    python3 tools/sparsify_bench.py [--rounds 2]

Builds the variants with nvcc into ``build/tools/``; every variant is
checked bit for bit against the plain version and timed back to back
(CUDA events over 10 calls), all in turns, ``--rounds`` times; then the
card's name and power limit.  One JSON line per timing.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.compress import ops as cops  # noqa: E402
from repro_torch.kernels.compress import ref as cref  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
VALUES = 1_930_264 * 256  # qwen2-0.5b's gradient in rows of 256
THRESH = 1.645
VARIANTS = {0: "spans of 1 item a thread", 1: "spans of 2 items a thread",
            2: "spans of 4 items a thread",
            3: "spans of 1 item a thread, streaming hints",
            4: "one wave looping, 4 items a thread",
            5: "one wave looping, 4 items a thread, streaming hints"}


def timed(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sparsify_bench: needs a CUDA card")
    _build.build([cops.SOURCE])
    out_dir = os.path.join(HERE, "..", "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "sparsify_variants.so")
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(HERE, "csrc", "sparsify_variants.cu")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.sparsify_variant.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_float, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(VALUES // 256, 256, device="cuda", generator=gen)
    t = torch.full((x.shape[0], 1), THRESH, device="cuda")
    ref = cref.sparsify_ref(x, t)
    out = torch.empty_like(x)
    lambd = float(torch.nextafter(torch.tensor(THRESH), torch.tensor(0.0)))

    def variant(v):
        def fn():
            assert lib.sparsify_variant(v, x.data_ptr(), out.data_ptr(),
                                        VALUES // 4, THRESH, sms) == 0
        return fn

    runs = {"port, rows of 256": lambda: cops.sparsify_kernel(x, t),
            "port, one row": lambda: cops.sparsify_kernel(x.view(1, -1),
                                                          t[:1]),
            "F.hardshrink": lambda: F.hardshrink(x, lambd)}
    runs.update({name: variant(v) for v, name in VARIANTS.items()})
    for name, fn in runs.items():  # bit for bit first
        res = fn()
        got = out if res is None else res
        torch.cuda.synchronize()
        assert torch.equal(got.view_as(ref), ref), name
    for rnd in range(args.rounds):
        for name, fn in runs.items():
            print(json.dumps({"round": rnd, "run": name, "values": VALUES,
                              "ms": timed(fn)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.splitlines()[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
