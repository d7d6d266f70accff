#!/usr/bin/env python3
"""Where K1-bwd's bf16 time goes: the kernel against copies of it with one
part taken out.

    python3 tools/k1_bwd_ablation.py

Builds copies of ``kernels/flash_attention/csrc/flash_attn_bwd.cu`` under
``build/k1_bwd_ablation/``, each with one change, and times each through
the port's wrapper at three causal bf16 shapes on the model's (B,S,H,D)
views: qwen2-0.5b's training microbatch (B 4 x S 512, H 14 / KV 2, D 64),
B 1 x S 4096, and dbrx-132b's heads (B 2 x S 256, H 48 / KV 8, D 128).
The variants run in turns, the list and then the list reversed; each line
gives the graph ms of a call and each launch's device ms (torch.profiler).

- ``kernel``: the source as it is;
- ``no_exp_pass``: the dK/dV launch skips the pass that turns S^T and dP^T
  into P^T and dS^T (exponentials, masks, the D term);
- ``no_rs``: the dK/dV launch skips dV += P^T dO and dK += dS^T Q, and
  with them the pass above, whose results nothing reads any more;
- ``no_ss``: the dK/dV launch skips S^T = K Q^T and dP^T = V dO^T;
- ``no_head_sum``: the dQ launch has no blocks that sum the G heads'
  partial dK, dV;
- ``two_blocks``: the launch bounds ask for two blocks a SM at D 64, not
  three.

The first four leave out work, so their gradients are wrong by
construction; ``two_blocks`` must give the kernel's bits, and the line says
whether it does.  Then the card's name and power limit.  Needs one card
and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

SHAPES = {"train": (cs.TRAIN_SHAPE, 20), "long": (cs.LONG_SHAPE, 6),
          "dbrx": (cs.DBRX_SHAPE, 20)}
_EW = ("    for (int j = 0; j < BQ / 8; ++j) {\n"
       "      const float2 l2 = *reinterpret_cast<const float2*>"
       "(lq + 8 * j + 2 * quad);")
_RS = ("    rs_product<DP, BQ / 16>(dv, pa, so, TB::QSUB);  // dV += P^T dO\n"
       "    rs_product<DP, BQ / 16>(dk, da, sq, TB::QSUB);  // dK += dS^T Q\n")
_SS = ("    ss_product<DP, BQ>(s, sk, TB::KSUB, sq, TB::QSUB);   // S^T = K Q^T\n"
       "    ss_product<DP, BQ>(dp, sv, TB::KSUB, so, TB::QSUB);  // dP^T = V dO^T\n")
_SUM = "  const int n_sum = a.B * a.KV * ((a.Sk + SUM_ROWS - 1) / SUM_ROWS);"
_BLOCKS = "static constexpr int MIN_BLOCKS = DP == 64 ? 3 : 2;"
VARIANTS = {
    "kernel": [],
    "no_exp_pass": [(_EW, _EW.replace("j < BQ / 8", "j < 0"))],
    "no_rs": [(_RS, "")],
    "no_ss": [(_SS, "")],
    "no_head_sum": [(_SUM, "  const int n_sum = 0;")],
    "two_blocks": [(_BLOCKS, "static constexpr int MIN_BLOCKS = 2;")],
}
SAME_BITS = ("kernel", "two_blocks")


def build() -> dict:
    """Every variant as a library, built in parallel: {name: CDLL}."""
    text = ops.BWD_SOURCE.read_text().replace(
        '#include "../../hopper.cuh"',
        f'#include "{_build.SHARED_HEADERS / "hopper.cuh"}"')
    out_dir = _build.BUILD_DIR.parent / "k1_bwd_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{ops.BWD_SOURCE.name} changed: {old!r} "
                                   f"not found exactly once")
            src = src.replace(old, new)
        sources[name] = out_dir / f"{name}.cu"
        sources[name].write_text(src)
    paths = _build.build(list(sources.values()))
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, src in sources.items():
        lib = ctypes.CDLL(str(paths[src]))
        lib.flash_attn_bwd.argtypes = [*[p] * 10, *[i] * 6, *[ll] * 24, i, i,
                                       i, ctypes.c_float, p]
        lib.flash_attn_bwd.restype = i
        lib.flash_attn_bwd_scratch.argtypes = [i] * 6
        lib.flash_attn_bwd_scratch.restype = ll
        lib.flash_attn_bwd_error_string.argtypes = [i]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("k1_bwd_ablation: needs a CUDA card")
    libs = build()
    rng = np.random.default_rng(0)
    inputs = {}
    for key, (shape, _) in SHAPES.items():
        q, k, v = cs._qkv(rng, *shape, torch.bfloat16, views=True)
        do = torch.from_numpy(rng.standard_normal(
            q.shape, dtype=np.float32)).to("cuda", torch.bfloat16)
        o, lse = cs.flash_attention_stats(q, k, v, causal=True)
        inputs[key] = (q, k, v, o, lse, do)
    first = {}
    names = list(VARIANTS)
    for name in names + names[::-1]:
        ops._bwd_lib = lambda lib=libs[name]: lib
        for key, (shape, iters) in SHAPES.items():
            q, k, v, o, lse, do = inputs[key]

            def bwd():
                return ops.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=True)
            grads = bwd()
            torch.cuda.synchronize()
            line = {"variant": name, "shape": list(shape),
                    "graph_ms": cs.graph_ms(bwd, iters),
                    "stage_ms": cs.stage_ms(bwd, iters, cs.BWD_STAGES)}
            if name in SAME_BITS:
                first.setdefault(key, grads)
                line["bit_equal_to_kernel"] = all(
                    torch.equal(a, b) for a, b in zip(grads, first[key]))
            print(json.dumps(line), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
