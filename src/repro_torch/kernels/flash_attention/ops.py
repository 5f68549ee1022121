"""Wrappers of the flash-attention CUDA kernels: the forward
(``kernel.cu``, ``flash_fwd``) and the backward (``backward.cu``,
``flash_bwd``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises (no fallback).  Meta tensors (the cost walker's) take
the reference's blocked XLA flash (``attention_blocked_ref`` and
``attention_blocked_bwd_ref`` with ``q_chunk``/``kv_chunk``): outputs of
the kernels' shapes and dtypes, charged what the reference's walker
charges, and no launch.  ``LAUNCHES`` counts wrapper calls that
launched their kernel, one per call and nowhere else (``flash_bwd`` is
three kernels on one stream: D = rowsum(dO o O), dQ, and dK/dV).
``q_offset`` is the position of q's first row for the causal and window
masks (a context-parallel block of query rows against every key); 0, the
default, is the attention of the whole sequence.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (
    KV_CHUNK, Q_CHUNK, attention_blocked_bwd_ref, attention_blocked_ref,
    attention_bwd_ref, attention_ref,
)
from repro_torch.kernels.proxy_blocks.ops import _aligned, _stream_handle

SOURCE = Path(__file__).resolve().parent / "kernel.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "backward.cu"
HEAD_DIMS = (16, 32, 64, 128)
#: rows of the backward's head-major scratch are padded to this (kPad)
BWD_PAD = 128
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches since the last :func:`reset_counts`
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the launchers' C signatures, set when a library is loaded
PROTOTYPES = {"flash_fwd_launch": ([_P] * 5 + [_I] * 10 + [_F, _P], _I)}
BWD_PROTOTYPES = {"flash_bwd_launch": ([_P] * 10 + [_I] * 10 + [_F, _P],
                                       _I)}


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *same_as_q: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """Raise on what the kernels do not take; return (b, s, t, h, g, d)."""
    ins = (q, k, v) + same_as_q
    if q.device.type != "cuda" or any(x.device != q.device for x in ins):
        raise ValueError(f"{name}: inputs on {[str(x.device) for x in ins]}; "
                         "all must be CPU or on one CUDA device")
    if q.dtype not in DTYPES or any(x.dtype != q.dtype for x in ins):
        raise TypeError(f"{name} takes f32 or bf16 q, k, v (and out, dout) "
                        f"of one dtype, got {[x.dtype for x in ins]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or any(
            x.shape != q.shape for x in same_as_q):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, out/dout "
                         f"{[tuple(x.shape) for x in same_as_q]}")
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or g == 0 or h % g:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (h % g == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    return b, s, t, h, g, d


def _on(kind: str, *xs: torch.Tensor) -> bool:
    return all(x.device.type == kind for x in xs)


def _offset(q_offset) -> int:
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    return q_offset


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        return_lse: bool = False, q_chunk: int = Q_CHUNK,
                        kv_chunk: int = KV_CHUNK, q_offset: int = 0):
    """q: (b,s,h,d); k/v: (b,t,g,d) -> (b,s,h,d) in q's dtype, and with
    ``return_lse`` also each row's log-sum-exp (b,s,h) in f32 (natural log;
    what the backward needs).  Without it the kernel writes no LSE.

    ``window`` limits a causal row to its last ``window`` keys and is
    ignored without ``causal``, as in the reference's kernel.
    ``q_chunk``/``kv_chunk`` are the blocks of the reference's XLA flash
    that meta tensors are costed as; no other device reads them."""
    q_offset = _offset(q_offset)
    if _on("cpu", q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             return_lse=return_lse, q_offset=q_offset)
    if _on("meta", q, k, v):
        return attention_blocked_ref(q, k, v, causal, window, q_chunk,
                                     kv_chunk, return_lse=return_lse,
                                     q_offset=q_offset)
    b, s, t, h, g, d = _check("flash_attention_fwd", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, s, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() and t:
        lib = build.load(SOURCE, PROTOTYPES)
        win = int(window) if (causal and window is not None) else 0
        code = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, t, h, g, d,
            int(q.dtype == torch.bfloat16), int(causal), win, q_offset,
            1.0 / math.sqrt(d), _stream_handle(q))
        build.check(lib, code, "flash_fwd")
        LAUNCHES["flash_fwd"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_chunk: int = Q_CHUNK,
                        kv_chunk: int = KV_CHUNK, q_offset: int = 0):
    """Gradients (dq (b,s,h,d), dk, dv (b,t,g,d)) of the attention whose
    forward gave ``out`` and ``lse`` (:func:`flash_attention_fwd` with
    ``return_lse``), for the output gradient ``dout``; dk and dv sum the
    query heads of each KV group.  Outputs in q's dtype.  ``q_chunk`` and
    ``kv_chunk`` are read only on meta tensors, as in the forward."""
    ins = (q, k, v, out, lse, dout)
    q_offset = _offset(q_offset)
    if _on("cpu", *ins):
        return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                 window=window, q_offset=q_offset)
    if _on("meta", *ins):
        return attention_blocked_bwd_ref(q, k, v, out, lse, dout, causal,
                                         window, q_chunk, kv_chunk,
                                         q_offset=q_offset)
    b, s, t, h, g, d = _check("flash_attention_bwd", q, k, v, out, dout)
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, s, h)):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}; want ({b}, {s}, {h}) "
                         "f32 beside q")
    q, k, v, out, lse, dout = (_aligned(x) for x in (q, k, v, out, lse, dout))
    if not (s and t and b and h):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the kernels' scratch: D = rowsum(dO o O) and the LSE in log2 units,
    # each (b, h, s rounded up to BWD_PAD) (the f32 kernels use (b, s, h))
    s_pad = -(-s // BWD_PAD) * BWD_PAD
    dvec = torch.empty(2 * b * h * s_pad, dtype=torch.float32,
                       device=q.device)
    lib = build.load(BWD_SOURCE, BWD_PROTOTYPES)
    win = int(window) if (causal and window is not None) else 0
    code = lib.flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, t, h, g, d,
        int(q.dtype == torch.bfloat16), int(causal), win, q_offset,
        1.0 / math.sqrt(d), _stream_handle(q))
    build.check(lib, code, "flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv
