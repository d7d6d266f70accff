"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its
own into a shared library under ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of the sources and flags, at first use.
Only the sources in the repository are built; nothing is fetched.  A failed
build raises with nvcc's error output.  Also the launch helpers the
wrappers share: the current device and stream, and ``refuse_grad`` for the
kernels that have no backward kernel (the compression kernels, whose
inputs are detached gradients).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")

# -Xptxas -v: registers, shared memory and spills of each kernel, kept in the
# .log beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                       "the CUDA kernels can only be built where the CUDA "
                       "toolkit is installed")


# headers shared by the kernels (hopper.cuh), included as "../../hopper.cuh"
SHARED_HEADERS = Path(__file__).resolve().parent


def library_path(source: Path) -> Path:
    """Where ``source`` is built: keyed by the bytes of every file in its
    directory (the .cu and any headers it includes), of the shared headers
    and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = [f for f in sorted(source.parent.iterdir()) if f.is_file()]
    for f in files + sorted(SHARED_HEADERS.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path]) -> Dict[Path, Path]:
    """Compile every source that is not built yet, one nvcc process per
    source, all started together.  Returns {source: library path}."""
    sources = list(dict.fromkeys(sources))  # a source shared by kernels
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((src, proc, tmp, out))
    errors = []
    for src, proc, tmp, out in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                          f"{stdout}{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return {src: library_path(src) for src in sources}


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build([source])[source]))


_CURRENT = contextlib.nullcontext()  # reusable: it holds no state


def on_device(device: torch.device):
    """Makes ``device`` current for a launch: a no-op where it already is
    (the usual case, for which ``torch.cuda.device`` still switches the
    device twice)."""
    if torch._C._cuda_getDevice() == device.index:
        return _CURRENT
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream on ``device`` as the integer handle a C
    entry point takes: PyTorch's own getter, which builds no Stream object
    (``torch.cuda.current_stream().cuda_stream`` does, on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def refuse_grad(kernel: str, backward: str, *tensors) -> None:
    """Raises NotImplementedError where autograd would record a CUDA launch
    of ``kernel``, whose gradient has no kernel: its wrapper returns a
    tensor without a grad_fn, which would cut the graph silently.  The
    codecs (detached gradients) and calls under no_grad pass."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} on CUDA tensors that require grad: {backward} has no "
            f"kernel yet, and the wrapper would cut the autograd graph; run "
            f"under torch.no_grad() or on CPU tensors (the plain version, "
            f"which autograd differentiates)")
