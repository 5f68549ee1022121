"""Wrapper of the flash-attention forward CUDA kernel (``kernel.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises (no fallback).  ``LAUNCHES`` counts kernel launches,
one per launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.proxy_blocks.ops import _aligned, _stream_handle

SOURCE = Path(__file__).resolve().parent / "kernel.cu"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches since the last :func:`reset_counts`
LAUNCHES = {"flash_fwd": 0}


def reset_counts() -> None:
    LAUNCHES["flash_fwd"] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the launcher's C signature, set when the library is loaded
PROTOTYPES = {"flash_fwd_launch": ([_P, _P, _P, _P] + [_I] * 9 + [_F, _P], _I)}


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None
                        ) -> torch.Tensor:
    """q: (b,s,h,d); k/v: (b,t,g,d) -> (b,s,h,d) in q's dtype.

    ``window`` limits a causal row to its last ``window`` keys and is
    ignored without ``causal``, as in the reference's kernel."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all must be CPU or on "
                         "one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes f32 or bf16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or g == 0 or h % g:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (h % g == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        return out
    lib = build.load(SOURCE, PROTOTYPES)
    win = int(window) if (causal and window is not None) else 0
    code = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h,
        g, d, int(q.dtype == torch.bfloat16), int(causal), win,
        1.0 / math.sqrt(d), _stream_handle(q))
    build.check(lib, code, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out
