"""Wrapper of the SSD diagonal-block CUDA kernel (``kernel.cu``), and its
gradient.

A CPU tensor takes the plain version in ``ref.py``, and so does a meta
tensor (the cost walker's: the walker charges the plain version, and
nothing launches); a CUDA tensor launches the kernel or raises (no
fallback).  ``LAUNCHES`` counts kernel launches,
one per launch and nowhere else.  The reference's wrapper cuts the heads
into slabs of at most 8 (a VMEM limit of the TPU); this one launches once
for all of them.

:func:`ssd_diag` is the differentiable entry: under autograd its forward is
:func:`ssd_diag_block` (the kernel on the card) and its backward recomputes
the plain version under autograd and differentiates it.  That is plain
PyTorch, as the reference's own backward is autodiff of its XLA einsums
(``repro/models/ssm.py``); a hand-written SSD backward is later work.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.proxy_blocks.ops import _aligned, _stream_handle
from repro_torch.kernels.ssd.ref import ssd_diag_ref

SOURCE = Path(__file__).resolve().parent / "kernel.cu"
HEAD_DIMS = (8, 16, 32, 64)
MAX_CHUNK = 256
MAX_STATE = 128
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches since the last :func:`reset_counts`
LAUNCHES = {"ssd_diag": 0}


def reset_counts() -> None:
    LAUNCHES["ssd_diag"] = 0


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: the launcher's C signature, set when the library is loaded
PROTOTYPES = {"ssd_diag_launch": ([_P] * 6 + [_LL] + [_I] * 7 + [_P], _I)}


def ssd_diag_block(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                   bc: torch.Tensor, cc: torch.Tensor, r: int,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Model layout: xc (b,c,q,h,p), dtc/cum (b,c,q,h), bc/cc (b,c,q,g,n)
    with h = g·r.  Returns y_diag (b,c,q,h,p) in ``out_dtype``, by default
    xc's dtype (the TPU kernel's contract)."""
    ins = (xc, dtc, cum, bc, cc)
    if (all(x.device.type == "cpu" for x in ins)
            or all(x.device.type == "meta" for x in ins)):
        return ssd_diag_ref(xc, dtc, cum, bc, cc, r, out_dtype)
    if xc.device.type != "cuda" or any(x.device != xc.device for x in ins):
        raise ValueError("ssd_diag_block: inputs on "
                         f"{[str(x.device) for x in ins]}; all must be CPU "
                         "or on one CUDA device")
    out_dtype = out_dtype or xc.dtype
    if (xc.dtype not in DTYPES or bc.dtype != xc.dtype or cc.dtype != xc.dtype
            or dtc.dtype != torch.float32 or cum.dtype != torch.float32
            or out_dtype not in DTYPES):
        raise TypeError("ssd_diag_block takes f32 or bf16 x, B, C of one "
                        "dtype, f32 dt and cum, and an f32 or bf16 output; "
                        f"got {[x.dtype for x in ins]} -> {out_dtype}")
    if xc.dim() != 5 or bc.dim() != 5 or cc.shape != bc.shape:
        raise ValueError(f"ssd_diag_block: x {tuple(xc.shape)}, B "
                         f"{tuple(bc.shape)}, C {tuple(cc.shape)}")
    b, c, q, h, p = xc.shape
    g, n = bc.shape[3], bc.shape[4]
    if (dtc.shape != (b, c, q, h) or cum.shape != dtc.shape
            or bc.shape[:3] != (b, c, q) or g * r != h):
        raise ValueError(f"ssd_diag_block: shapes x {tuple(xc.shape)}, dt "
                         f"{tuple(dtc.shape)}, cum {tuple(cum.shape)}, B "
                         f"{tuple(bc.shape)} with r={r} do not match")
    if p not in HEAD_DIMS or q > MAX_CHUNK or not 0 < n <= MAX_STATE:
        raise ValueError(f"ssd_diag_block takes head_dim in {HEAD_DIMS}, "
                         f"chunk <= {MAX_CHUNK} and state <= {MAX_STATE}; "
                         f"got p={p}, q={q}, n={n}")
    xc, dtc, cum, bc, cc = (_aligned(x) for x in ins)
    out = torch.empty(xc.shape, dtype=out_dtype, device=xc.device)
    if out.numel() == 0:
        return out
    lib = build.load(SOURCE, PROTOTYPES)
    code = lib.ssd_diag_launch(
        xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(),
        cc.data_ptr(), out.data_ptr(), b * c, q, h, g, n, p,
        int(xc.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _stream_handle(xc))
    build.check(lib, code, "ssd_diag")
    LAUNCHES["ssd_diag"] += 1
    return out


class _SSDDiag(torch.autograd.Function):
    """Forward: the kernel (or, for CPU tensors, the plain version).
    Backward: the plain version recomputed and differentiated.  Saves only
    the inputs."""

    @staticmethod
    def forward(ctx, xc, dtc, cum, bc, cc, r, out_dtype):
        ctx.save_for_backward(xc, dtc, cum, bc, cc)
        ctx.r, ctx.out_dtype = r, out_dtype
        return ssd_diag_block(xc, dtc, cum, bc, cc, r, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        ins = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n) for x, n in zip(ins, need)]
            y = ssd_diag_ref(*leaves, ctx.r, ctx.out_dtype)
            wanted = [x for x, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(y, wanted, gy)) if wanted else None
        return tuple(next(got) if n else None for n in need) + (None, None)


def ssd_diag(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
             bc: torch.Tensor, cc: torch.Tensor, r: int,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """:func:`ssd_diag_block`, differentiable: without autograd (no input
    needs a gradient, or grad mode is off) exactly ``ssd_diag_block``."""
    ins = (xc, dtc, cum, bc, cc)
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        return _SSDDiag.apply(xc, dtc, cum, bc, cc, r, out_dtype)
    return ssd_diag_block(xc, dtc, cum, bc, cc, r, out_dtype)
