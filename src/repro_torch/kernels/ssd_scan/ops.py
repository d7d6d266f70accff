"""Public wrappers of the SSD chunked-scan kernels, forward and backward.

On CUDA tensors they launch the hand-written Hopper kernels
(``csrc/ssd_scan_fwd.cu``: three launches, chunk states, the carry, the
chunks' outputs, through an f32 workspace allocated here; its gradient
``csrc/ssd_scan_bwd.cu``: four launches, reading that workspace) or raise;
on CPU tensors they compute the plain PyTorch versions
(``ref.ssd_scan_ref``, which autograd differentiates, and
``ref.ssd_scan_bwd_ref``).  The device of the tensors decides: there is no
flag and no fallback.  Where autograd needs the gradient of a CUDA call,
``ssd_scan`` goes through ``SsdScan``, a ``torch.autograd.Function`` that
keeps the forward's workspace and whose backward is the backward kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import (check_chunk, ssd_scan_bwd_ref,
                                              ssd_scan_ref)

# devices whose tensors take the plain version: the host, and the meta
# device (shapes only: the dry-run, ``launch.dryrun``)
PLAIN_DEVICES = ("cpu", "meta")
# the plain version, by the name the JAX package's ops module gives it
reference = ssd_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan_fwd.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan_bwd.cu"

HEAD_DIMS = (32, 64, 128)      # P, instantiated in the kernel
STATE_DIMS = (16, 32, 64, 128)  # N
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES_PER_CALL = 3  # chunk states, the carry, the outputs
# backward: the states' gradients, their reverse carry, every gradient of
# a chunk for a group of heads, the sums over the groups and chunks
BWD_LAUNCHES_PER_CALL = 4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_workspace.argtypes = [i, i, i, i, i]
    lib.ssd_scan_workspace.restype = ll
    lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                 ll, ll, ll, ll, ll, ll, i, p]
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_bwd_workspace.argtypes = [i, i, i, i, i]
    lib.ssd_scan_bwd_workspace.restype = ll
    lib.ssd_scan_bwd.argtypes = [*[p] * 13, *[i] * 5, *[ll] * 9, p]
    lib.ssd_scan_bwd.restype = i
    lib.ssd_scan_bwd_error_string.argtypes = [i]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=256)
def _workspace(b: int, h: int, l: int, p: int, n: int) -> int:
    return _lib().ssd_scan_workspace(b, h, l, p, n)


@functools.lru_cache(maxsize=256)
def _bwd_workspace(b: int, h: int, l: int, p: int, n: int) -> int:
    return _bwd_lib().ssd_scan_bwd_workspace(b, h, l, p, n)


def _check(x, dt, a, b, c) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3 or \
            c.shape != b.shape:
        raise ValueError(f"want x (B,H,L,P), dt (B,H,L), a (H,), b = c "
                         f"(B,L,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, h, l, p = x.shape
    if tuple(dt.shape) != (bsz, h, l) or a.shape[0] != h or \
            b.shape[:2] != (bsz, l):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if p not in HEAD_DIMS or b.shape[2] not in STATE_DIMS:
        raise ValueError(f"(P, N) = ({p}, {b.shape[2]}) not supported; the "
                         f"kernel takes P in {HEAD_DIMS}, N in {STATE_DIMS}")
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype:
        raise TypeError(f"want x, b, c all f32 or all bf16; got {x.dtype}, "
                        f"{b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"want f32 dt and a; got {dt.dtype}, {a.dtype}")
    # x and dt may be strided views (the model passes its (B,L,H,P) and
    # (B,L,H) tensors permuted, without a copy); b, c, a must be contiguous
    if x.stride(3) != 1:
        raise ValueError(f"x must have a unit stride along P; strides "
                         f"{x.stride()}")
    if not (b.is_contiguous() and c.is_contiguous() and a.is_contiguous()):
        raise ValueError("b, c and a must be contiguous")
    if not (x.device == dt.device == a.device == b.device == c.device):
        raise ValueError("x, dt, a, b, c on different devices")


def _launch_fwd(x, dt, a, b, c):
    """K6 on CUDA tensors: (y, the f32 workspace the backward reads)."""
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    bsz, h, l, p = x.shape
    n = b.shape[2]
    dev = x.device
    y = torch.empty(bsz, h, l, p, dtype=x.dtype, device=dev)
    work = torch.empty(_workspace(bsz, h, l, p, n), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    with _build.on_device(dev):
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), work.data_ptr(), bsz, h, l, p, n,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), _DTYPE_CODES[x.dtype],
            _build.raw_stream(dev))
    ssd_scan.launches += rc & 15
    if rc >> 4:
        raise RuntimeError(
            f"ssd_scan_fwd launch failed: CUDA error {rc >> 4} "
            f"({lib.ssd_scan_error_string(rc >> 4).decode()})")
    return y, work


class SsdScan(torch.autograd.Function):
    """K6 with its gradient: the forward keeps its workspace (the states
    after each chunk, C B^T, the chunks' decays) beside the inputs, and the
    backward is ``ssd_scan_bwd``, which reads it instead of recomputing
    it.  On CUDA tensors both are kernels (this is what ``ssd_scan``
    records there); on CPU tensors both are the plain versions, which the
    CPU tests hold against autograd.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward, and the workspace read is that
    run's."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        if x.device.type in PLAIN_DEVICES:
            y, work = ssd_scan_ref(x, dt, a, b, c, chunk=chunk), None
        else:
            y, work = _launch_fwd(x, dt, a, b, c)
        ctx.save_for_backward(x, dt, a, b, c, work)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c, work = ctx.saved_tensors
        return (*ssd_scan_bwd(x, dt, a, b, c, dy, chunk=ctx.chunk,
                              workspace=work), None)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """Chunked SSD scan, forward.

    x: (B,H,L,P) f32 or bf16 (unit stride along P, any other strides);
    dt: (B,H,L) f32 (post-softplus, any strides); a: (H,) f32 decay rates;
    b, c: (B,L,N) contiguous, in x's dtype, shared by all heads.  Returns
    y (B,H,L,P) contiguous in x's dtype, computed in f32.  L must be a
    multiple of min(chunk, L), as in the JAX package; the function does not
    depend on the chunk, so the kernel tiles L its own way.
    Differentiable: on CUDA tensors through ``SsdScan`` where autograd
    records (f32 only: the backward kernel's dtype)."""
    _check(x, dt, a, b, c)
    check_chunk(x.shape[2], chunk)
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_ref(x, dt, a, b, c, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c)):
        return SsdScan.apply(x, dt, a, b, c, chunk)
    return _launch_fwd(x, dt, a, b, c)[0]


ssd_scan.launches = 0  # kernel launches, counted only where they happen


def ssd_scan_workspace(x, dt, a, b, c):
    """The forward with the workspace that ``ssd_scan_bwd`` reads: (y,
    workspace), not recorded by autograd; on CUDA tensors three launches of
    K6, on CPU tensors the plain version and no workspace (the plain
    backward recomputes the states)."""
    _check(x, dt, a, b, c)
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_ref(x, dt, a, b, c, chunk=x.shape[2]), None
    return _launch_fwd(x, dt, a, b, c)


def ssd_scan_bwd(x, dt, a, b, c, dy, *, chunk: int = 128, workspace=None):
    """Gradient of ``ssd_scan``: (dx, ddt, da, db, dc), dx (B,H,L,P) and
    ddt (B,H,L) contiguous, in the inputs' dtypes.

    x, dt, a, b, c as the forward took them; dy the output's gradient (any
    strides with a unit stride along P; copied otherwise).  On CUDA tensors
    f32 only, four launches (``BWD_LAUNCHES_PER_CALL``; every product in
    3xTF32 on the tensor cores) that read the forward's ``workspace``
    (``ssd_scan_workspace``, or the one ``SsdScan`` keeps) and one f32
    buffer of their own: the states' gradients and the partials of db and
    dc of each group of heads, summed over the groups in a fixed order.
    On CPU tensors ``ref.ssd_scan_bwd_ref`` at ``chunk``."""
    _check(x, dt, a, b, c)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_bwd_ref(x, dt, a, b, c, dy, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan_bwd for device {x.device}")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"the SSD scan's backward kernel takes f32 x, b, c "
                        f"and dy (the model's scan); got {x.dtype}, "
                        f"{dy.dtype}")
    bsz, h, l, p = x.shape
    n = b.shape[2]
    if workspace is None or workspace.numel() != _workspace(bsz, h, l, p, n):
        raise ValueError("ssd_scan_bwd needs the forward's workspace "
                         "(ssd_scan_workspace) of these inputs")
    if dy.stride(3) != 1:
        dy = dy.contiguous()
    dev = x.device
    dx = torch.empty(bsz, h, l, p, dtype=torch.float32, device=dev)
    ddt = torch.empty(bsz, h, l, dtype=torch.float32, device=dev)
    da = torch.empty(h, dtype=torch.float32, device=dev)
    db = torch.empty(bsz, l, n, dtype=torch.float32, device=dev)
    dc = torch.empty(bsz, l, n, dtype=torch.float32, device=dev)
    work = torch.empty(_bwd_workspace(bsz, h, l, p, n), dtype=torch.float32,
                       device=dev)
    lib = _bwd_lib()
    with _build.on_device(dev):
        rc = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), dy.data_ptr(), workspace.data_ptr(),
            work.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
            db.data_ptr(), dc.data_ptr(), bsz, h, l, p, n,
            x.stride(0), x.stride(1), x.stride(2),
            dy.stride(0), dy.stride(1), dy.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), _build.raw_stream(dev))
    ssd_scan_bwd.launches += rc & 15
    if rc >> 4:
        raise RuntimeError(
            f"ssd_scan_bwd launch failed: CUDA error {rc >> 4} "
            f"({lib.ssd_scan_bwd_error_string(rc >> 4).decode()})")
    return dx, ddt, da, db, dc


ssd_scan_bwd.launches = 0  # kernel launches, counted only where they happen
