"""Public wrappers of the grouped expert GEMM kernels, forward and
backward.

On CUDA tensors they launch the hand-written Hopper kernels
(``csrc/moe_gmm.cu``; its gradient ``csrc/moe_gmm_bwd.cu``, two launches,
dx and dw, in the variant ``gmm_bwd_variant`` picks) or raise; on CPU tensors they compute the plain PyTorch
versions (``ref.moe_gmm_ref``, which autograd differentiates, and
``ref.moe_gmm_bwd_ref``).  The device of the tensors decides: there is no
flag and no fallback.  Where autograd needs the gradient of a CUDA call,
``moe_gmm`` goes through ``MoeGmm``, a ``torch.autograd.Function`` whose
backward is the backward kernel; with ``expanded`` it holds the tokens
once, so autograd never materialises their E copies.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref, moe_gmm_ref

# devices whose tensors take the plain version: the host, and the meta
# device (shapes only: the dry-run, ``launch.dryrun``)
PLAIN_DEVICES = ("cpu", "meta")

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm_bwd.cu"
BWD_LAUNCHES_PER_CALL = 2  # dx, dw (a split dx sums its parts in-kernel)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"f32": 0, "mma_sync": 0, "wgmma": 1, "wgmma_swap": 1}
WGMMA_MIN_C = 64  # below, a 64-row tile would be mostly padding: swap-AB


def gmm_variant(dtype, c: int, f: int, x_strides, x_ptr: int,
                w_ptr: int) -> str:
    """Which of the kernel's variants a call takes (csrc/moe_gmm.cu):
    "f32" (CUDA cores) for f32; for bf16 where TMA can address the operands
    (16-byte-aligned bases and x row and expert strides, f a multiple of 8)
    "wgmma" (128 x 256 tiles) from ``WGMMA_MIN_C`` tokens on and
    "wgmma_swap" (swap-AB, decode's few slots) below; else "mma_sync"."""
    if dtype == torch.float32:
        return "f32"
    sxe, sxc = x_strides[0], x_strides[1]
    if x_ptr % 16 or w_ptr % 16 or f % 8 or sxc % 8 or sxe % 8:
        return "mma_sync"
    return "wgmma" if c >= WGMMA_MIN_C else "wgmma_swap"


_BWD_VARIANT_CODES = {"f32": 0, "mma_sync": 0, "wgmma": 1}
# the backward's wgmma tiles: 128 rows x 256 columns, 64-deep slices
BWD_TILE_M, BWD_TILE_N, BWD_SLICE = 128, 256, 64
MAX_SPLIT = 16
PART_FLOATS = 256 * 128  # f32 of one part's tile: 256 threads x 128


def gmm_bwd_variant(dtype, d: int, f: int, x_strides, x_ptr: int,
                    w_ptr: int, dy_ptr: int) -> str:
    """Which of the backward kernel's variants a call takes
    (csrc/moe_gmm_bwd.cu): "f32" (CUDA cores) for f32; for bf16 where TMA
    can address every operand (16-byte-aligned bases and x row and expert
    strides, d and f multiples of 8) "wgmma", at any C; else "mma_sync"."""
    if dtype == torch.float32:
        return "f32"
    sxe, sxc = x_strides[0], x_strides[1]
    if x_ptr % 16 or w_ptr % 16 or dy_ptr % 16 or d % 8 or f % 8 or \
            sxc % 8 or sxe % 8:
        return "mma_sync"
    return "wgmma"


def gmm_bwd_tiles(e: int, c: int, d: int, expanded: bool) -> int:
    """Output tiles of the wgmma variant's dx: 128 (C) x 256 (d) of each
    expert's (C, d), or of the one expanded sum."""
    return (math.ceil(c / BWD_TILE_M) * math.ceil(d / BWD_TILE_N)
            * (1 if expanded else e))


def gmm_bwd_walk(e: int, f: int, expanded: bool) -> int:
    """Steps of dx's K loop: the 64-deep slices of f, of every expert where
    expanded (the walk over (expert, slice) pairs)."""
    return (e if expanded else 1) * math.ceil(f / BWD_SLICE)


def gmm_bwd_split(tiles: int, steps: int, sms: int) -> int:
    """Parts that dx's K walk is cut into so that ``tiles`` output tiles
    fill ``sms`` SMs: the number of parts s whose rounds of work units,
    ceil(tiles s / sms) / s of a whole tile's time, come within 5% of the
    least over 1 .. MAX_SPLIT (the smallest such s: each part adds an f32
    tile to write and sum).  1 where the tiles fill the SMs already.  At
    dbrx's step (96 tiles, 132 SMs) 4: 384 units, three rounds of a
    quarter tile each."""
    top = max(1, min(MAX_SPLIT, steps))
    cost = {s: math.ceil(tiles * s / sms) / s for s in range(1, top + 1)}
    best = min(cost.values())
    return min(s for s, c in cost.items() if c <= best * 1.05)


def gmm_bwd_parts(steps: int, split: int):
    """The [begin, end) steps of each part, in the order the kernel sums
    them: part s takes floor(s steps / split) up to floor((s + 1) steps /
    split)."""
    return [(s * steps // split, (s + 1) * steps // split)
            for s in range(split)]


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_gmm.argtypes = [p, p, p, i, i, i, i, ll, ll, i, i, p]
    lib.moe_gmm.restype = i
    lib.moe_gmm_error_string.argtypes = [i]
    lib.moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_gmm_bwd.argtypes = [p, p, p, p, p, i, i, i, i, ll, ll, i, i, i,
                                i, p, p, p]
    lib.moe_gmm_bwd.restype = i
    lib.moe_gmm_bwd_error_string.argtypes = [i]
    lib.moe_gmm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _expand(x, w, expanded: bool):
    """The (E, C, d) operand: with ``expanded``, x's (C, d) tokens as a view
    of expert stride 0."""
    if not expanded:
        return x
    if x.dim() != 2:
        raise ValueError(f"expanded: want x (C, d); got {tuple(x.shape)}")
    return x.expand(w.shape[0], *x.shape)


def _check(x, w) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"want x (E,C,d), w (E,d,f); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if min(x.shape) < 1 or w.shape[2] < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"want x and w both f32 or both bf16; got {x.dtype}, "
                        f"{w.dtype}")
    # x may be the tokens expanded over experts (expert stride 0) or any
    # row-strided view with a unit stride along d; w is contiguous
    if x.stride(2) != 1:
        raise ValueError(f"x must have a unit stride along d; strides "
                         f"{x.stride()}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous in the (E,d,f) layout")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def _launch_fwd(x, w):
    """K5 on CUDA tensors, x (E, C, d) of any expert stride."""
    if x.device.type != "cuda":
        raise ValueError(f"no moe_gmm for device {x.device}")
    e, c, d = x.shape
    f = w.shape[2]
    variant = gmm_variant(x.dtype, c, f, x.stride(), x.data_ptr(),
                          w.data_ptr())
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = _lib()
    with _build.on_device(x.device):
        err = lib.moe_gmm(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d,
                          f, x.stride(0), x.stride(1), _DTYPE_CODES[x.dtype],
                          _VARIANT_CODES[variant],
                          _build.raw_stream(x.device))
    if err:
        raise RuntimeError(f"moe_gmm launch failed ({variant}): CUDA error "
                           f"{err} ({lib.moe_gmm_error_string(err).decode()})")
    moe_gmm.launches += 1
    moe_gmm.last_variant = variant
    return out


class MoeGmm(torch.autograd.Function):
    """K5 with its gradient: the forward saves x as given (the (C, d)
    tokens where ``expanded``) and w; the backward is ``moe_gmm_bwd``.  On
    CUDA tensors both are kernels (this is what ``moe_gmm`` records
    there); on CPU tensors both are the plain versions, which the CPU tests
    hold against autograd."""

    @staticmethod
    def forward(ctx, x, w, expanded):
        xe = _expand(x, w, expanded)
        out = moe_gmm_ref(xe, w) if x.device.type in PLAIN_DEVICES \
            else _launch_fwd(xe, w)
        ctx.save_for_backward(x, w)
        ctx.expanded = expanded
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = moe_gmm_bwd(x, w, dy, expanded=ctx.expanded)
        return dx, dw, None


def moe_gmm(x, w, *, expanded: bool = False):
    """Grouped expert matmul: (E,C,d) x (E,d,f) -> (E,C,f) contiguous in x's
    dtype, accumulated in f32 (full f32 for f32 inputs, never TF32).

    x: unit stride along d; its expert stride may be 0 (every expert on the
    same tokens, as ``moe_dense`` computes) and C, d, f need not divide any
    tile.  ``expanded``: x is those (C, d) tokens themselves, read by every
    expert.  Differentiable: on CUDA tensors through ``MoeGmm`` where
    autograd records."""
    xe = _expand(x, w, expanded)
    _check(xe, w)
    if x.device.type in PLAIN_DEVICES:
        return moe_gmm_ref(xe, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmm.apply(x, w, expanded)
    return _launch_fwd(xe, w)


moe_gmm.launches = 0  # kernel launches, counted only where they happen
moe_gmm.last_variant = None  # the variant of the last launch


def moe_gmm_bwd(x, w, dy, *, expanded: bool = False):
    """Gradient of ``moe_gmm``: (dx, dw) in the dtypes of x and w,
    contiguous, accumulated in f32.

    x, w as the forward took them (x (C, d) where ``expanded``, and dx
    then the one (C, d) sum over the experts); dy (E, C, f), copied where
    not contiguous.  On CUDA tensors two launches (``BWD_LAUNCHES_PER_CALL``:
    dx = dy w^T with w read transposed in place, and dw = x^T dy with x
    read through its strides; ``gmm_bwd_variant`` picks the kernel's
    variant, and for wgmma ``gmm_bwd_split`` the parts of dx's K walk, whose
    f32 tiles the kernel sums in a fixed order); on CPU tensors
    ``ref.moe_gmm_bwd_ref``."""
    xe = _expand(x, w, expanded)
    _check(xe, w)
    if tuple(dy.shape) != (*xe.shape[:2], w.shape[2]) or \
            dy.dtype != x.dtype:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match "
                         f"the output of x {tuple(xe.shape)} and w "
                         f"{tuple(w.shape)}")
    if x.device.type in PLAIN_DEVICES:
        return moe_gmm_bwd_ref(x, w, dy, expanded=expanded)
    if x.device.type != "cuda":
        raise ValueError(f"no moe_gmm_bwd for device {x.device}")
    if dy.device != x.device:
        raise ValueError(f"dy on {dy.device}, x on {x.device}")
    dy = dy.contiguous()
    e, c, d = xe.shape
    f = w.shape[2]
    variant = gmm_bwd_variant(x.dtype, d, f, xe.stride(), x.data_ptr(),
                              w.data_ptr(), dy.data_ptr())
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    split, part, count = 1, None, None
    if variant == "wgmma":
        tiles = gmm_bwd_tiles(e, c, d, expanded)
        split = gmm_bwd_split(tiles, gmm_bwd_walk(e, f, expanded),
                              _sm_count(x.device.index or 0))
        if split > 1:
            part = torch.empty(tiles * split * PART_FLOATS,
                               dtype=torch.float32, device=x.device)
            count = torch.zeros(tiles, dtype=torch.int32, device=x.device)
    lib = _bwd_lib()
    with _build.on_device(x.device):
        rc = lib.moe_gmm_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                             dx.data_ptr(), dw.data_ptr(), e, c, d, f,
                             xe.stride(0), xe.stride(1),
                             1 if expanded else 0, _DTYPE_CODES[x.dtype],
                             _BWD_VARIANT_CODES[variant], split,
                             None if part is None else part.data_ptr(),
                             None if count is None else count.data_ptr(),
                             _build.raw_stream(x.device))
    moe_gmm_bwd.launches += rc & 15
    if rc >> 4:
        raise RuntimeError(
            f"moe_gmm_bwd launch failed ({variant}): CUDA error {rc >> 4} "
            f"({lib.moe_gmm_bwd_error_string(rc >> 4).decode()})")
    moe_gmm_bwd.last_variant = variant
    moe_gmm_bwd.last_split = split
    return dx, dw


moe_gmm_bwd.launches = 0  # kernel launches, counted only where they happen
moe_gmm_bwd.last_variant = None  # the variant of the last call
moe_gmm_bwd.last_split = None  # the parts of its dx's K walk
