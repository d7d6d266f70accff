#!/usr/bin/env python3
"""Throughput of mma.sync m16n8k8 TF32 on the card, alone and with the
3xTF32 operand splits between the products (``csrc/tf32_mma_bench.cu``).

    python3 tools/tf32_mma_bench.py

Builds the source with nvcc into ``build/tools/``, runs each mode at 1, 2,
4 and 8 blocks of 256 threads an SM, and prints one JSON line per run:
TFLOP/s of the mmas and clocks an mma takes on one SM sub-partition at the
card's maximum SM clock, then the card's name, power limit and clocks.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
MODES = {0: "mma only", 1: "split by cvt.rna", 2: "split by integer rounding"}


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("tf32_mma_bench: needs a CUDA card")
    out_dir = os.path.join(HERE, "..", "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "tf32_mma_bench.so")
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(HERE, "csrc", "tf32_mma_bench.cu")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.tf32_mma_bench.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(smi("clocks.max.sm")) * 1e6
    out = torch.empty(sms * 8 * 256, device="cuda")
    iters = 4096
    for mode, name in MODES.items():
        for per_sm in (1, 2, 4, 8):
            blocks = sms * per_sm
            assert lib.tf32_mma_bench(mode, out.data_ptr(), blocks, iters) == 0
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.tf32_mma_bench(mode, out.data_ptr(), blocks, iters)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            mmas = blocks * 8 * iters * 8  # warps x iterations x 8
            print(json.dumps({
                "mode": name, "blocks_per_sm": per_sm, "ms": ms,
                "tflops": mmas * 2048 / ms / 1e9,
                "clocks_per_mma_per_subpartition":
                    ms * 1e-3 * clock_hz / (mmas / sms / 4)}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi("name,power.limit,clocks.max.sm")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
