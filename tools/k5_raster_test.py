#!/usr/bin/env python3
"""Does the raster order alone explain the old grouped GEMM's prefill time?

    python3 tools/k5_raster_test.py [--reps 5]

K5's mma.sync variant (``csrc/moe_gmm.cu``: ``gmm_bf16_kernel``, the whole
bf16 kernel before the wgmma redesign) launches its grid with the f tile
varying fastest, so the M tiles that share one expert's weight columns run
84 tiles apart in launch order.  The hypothesis: each M tile then reads w
from HBM again (8 x 2.1 GB at dbrx prefill).  This script builds that
variant twice from the checkout's source, as it is and with only its grid
reordered (the M tile fastest), and times both at dbrx-132b's prefill shape
(E 16, C 512, d 6144, f 10752, bf16, x expanded over experts) in turns
(as is, reordered, reordered, as is).  Prints one JSON line with the times
and whether the two outputs are bit-equal, then the card's name and power
limit.  Needs one card and nvcc.
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

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import SOURCE  # noqa: E402

SHAPE = (16, 512, 6144, 10752)  # dbrx-132b prefill, B 2 x S 256
# the two lines that set the grid order of gmm_bf16_kernel
BLOCK = ("const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;",
         "const int m0 = blockIdx.x * H_BM, n0 = blockIdx.y * H_BN;")
GRID = ("const dim3 grid((F + H_BN - 1) / H_BN, (C + H_BM - 1) / H_BM, E);",
        "const dim3 grid((C + H_BM - 1) / H_BM, (F + H_BN - 1) / H_BN, E);")


def build_pair() -> dict:
    """Both orders as libraries under build/k5_raster, from copies of the
    source that include the shared header by its absolute path."""
    text = SOURCE.read_text().replace(
        '#include "../../hopper.cuh"',
        f'#include "{_build.SHARED_HEADERS / "hopper.cuh"}"')
    for old, _ in (BLOCK, GRID):
        if text.count(old) != 1:
            raise RuntimeError(f"{SOURCE.name} changed: {old!r} not found "
                               f"exactly once")
    out_dir = _build.BUILD_DIR.parent / "k5_raster"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    libs, procs = {}, []
    for name, src in (("as_is", text),
                      ("m_fastest", text.replace(*BLOCK).replace(*GRID))):
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        libs[name] = out_dir / f"{name}.so"
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(libs[name]), str(cu)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    for proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{err}")
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k5_raster_test: needs a CUDA card")
    e, c, d, f = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((c, d), device="cuda", generator=gen).to(
        torch.bfloat16).expand(e, c, d)
    w = (torch.randn((e, d, f), device="cuda", generator=gen)
         * d ** -0.5).to(torch.bfloat16)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns, outs = {}, {}
    for name, path in build_pair().items():
        lib = ctypes.CDLL(str(path))
        lib.moe_gmm.argtypes = [p, p, p, i, i, i, i, ll, ll, i, i, p]
        lib.moe_gmm.restype = i
        out = torch.empty((e, c, f), dtype=torch.bfloat16, device="cuda")

        def run(lib=lib, out=out):  # variant 0: the mma.sync kernel
            err = lib.moe_gmm(x.data_ptr(), w.data_ptr(), out.data_ptr(), e,
                              c, d, f, x.stride(0), x.stride(1), 1, 0,
                              torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        fns[name], outs[name] = run, out
    ms = {name: [] for name in fns}
    for name in ("as_is", "m_fastest", "m_fastest", "as_is"):
        for _ in range(2):  # warm up
            fns[name]()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fns[name]()
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end) / args.reps)
    print(json.dumps({"shape": list(SHAPE), "dtype": "bfloat16",
                      "x_expert_stride_0": True, "variant": "mma_sync",
                      "ms": ms, "bit_equal": bool(torch.equal(
                          outs["as_is"], outs["m_fastest"]))}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
