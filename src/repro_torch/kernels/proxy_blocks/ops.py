"""Wrappers of the proxy-block CUDA kernels (``kernel.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises (no fallback).  Each wrapper counts its launches in
``LAUNCHES`` — one per kernel launch, nowhere else — so a run can show that
the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.proxy_blocks.ref import (
    MM, MXU_SCALE, STREAM_ADD, STREAM_MUL, mxu_ref, stream_ref,
)

SOURCE = Path(__file__).resolve().parent / "kernel.cu"
TILE = 8 * 128      # the TPU kernel's stream tile; n must be a multiple

#: kernel launches since the last :func:`reset_counts`
LAUNCHES = {"mxu_iter": 0, "stream_iter": 0}

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
#: the launchers' C signatures, set when the library is loaded
PROTOTYPES = {"mxu_iter_launch": ([_P, _P, _P, _LL, _LL, _I, _F, _P], _I),
              "stream_iter_launch": ([_P, _P, _LL, _I, _F, _F, _P], _I)}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _stream_handle(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, read anew every call (the
    caller may switch streams), in one C call rather than through the
    Python ``Stream`` object of ``torch.cuda.current_stream``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary: the kernels load
    16-byte vectors, and a misaligned load faults the whole CUDA context.  A
    view that starts elsewhere (``big[1:]``) is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _is_square(t: torch.Tensor) -> bool:
    shape = t.shape
    return len(shape) >= 2 and shape[-1] == MM and shape[-2] == MM


def mxu_iter(a: torch.Tensor, b: torch.Tensor, reps: int,
             scale: float = MXU_SCALE) -> torch.Tensor:
    """``a <- bf16((a @ b) * scale)``, ``reps`` times, a and b on chip.

    ``a``: (..., 128, 128) bf16; ``b``: (128, 128) bf16, or batched with
    the same leading shape as ``a``.  Returns a new tensor."""
    reps = int(reps)
    if not a.is_cuda or b.get_device() != a.get_device():
        if a.device.type == "cpu" and b.device.type == "cpu":
            return mxu_ref(a, b, reps, scale)
        raise ValueError(f"mxu_iter: a on {a.device}, b on {b.device}; "
                         "both must be CPU or on one CUDA device")
    if a.dtype is not torch.bfloat16 or b.dtype is not torch.bfloat16:
        raise TypeError(f"mxu_iter takes bf16, got {a.dtype} and {b.dtype}")
    if not (_is_square(a) and _is_square(b)):
        raise ValueError(f"mxu_iter takes (..., {MM}, {MM}), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.dim() == 2:
        b_stride = 0
    elif b.shape == a.shape:
        b_stride = MM * MM
    else:
        raise ValueError(f"mxu_iter: b {tuple(b.shape)} neither (128, 128) "
                         f"nor a's shape {tuple(a.shape)}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    pa, pb = a.data_ptr(), b.data_ptr()
    if pa % 16 or not a.is_contiguous():
        a = _aligned(a)
        pa = a.data_ptr()
    if pb % 16 or not b.is_contiguous():
        b = _aligned(b)
        pb = b.data_ptr()
    out = torch.empty_like(a)
    batch = a.numel() // (MM * MM)
    if batch == 0:
        return out
    lib = build.load(SOURCE, PROTOTYPES)
    code = lib.mxu_iter_launch(pa, pb, out.data_ptr(), batch, b_stride, reps,
                               scale, _stream_handle(a))
    if code:
        build.check(lib, code, "mxu_iter")
    LAUNCHES["mxu_iter"] += 1
    return out


def stream_iter(v: torch.Tensor, reps: int) -> torch.Tensor:
    """``v <- v * 0.999999 + 1e-6``, ``reps`` times in registers.

    ``v``: (..., n) f32 with ``n % 1024 == 0``.  Returns a new tensor."""
    reps = int(reps)
    if not v.is_cuda:
        if v.device.type == "cpu":
            return stream_ref(v, reps)
        raise ValueError(f"stream_iter: v on {v.device}; must be CPU or CUDA")
    if v.dtype is not torch.float32:
        raise TypeError(f"stream_iter takes float32, got {v.dtype}")
    shape = v.shape
    if not shape or shape[-1] % TILE:
        raise ValueError(f"stream_iter needs a last dim that is a multiple "
                         f"of {TILE}, got {tuple(shape)}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    pv = v.data_ptr()
    if pv % 16 or not v.is_contiguous():
        v = _aligned(v)
        pv = v.data_ptr()
    out = torch.empty_like(v)
    n = v.numel()
    if n == 0:
        return out
    lib = build.load(SOURCE, PROTOTYPES)
    code = lib.stream_iter_launch(pv, out.data_ptr(), n, reps, STREAM_MUL,
                                  STREAM_ADD, _stream_handle(v))
    if code:
        build.check(lib, code, "stream_iter")
    LAUNCHES["stream_iter"] += 1
    return out
