"""Wrappers of the SSD diagonal-block CUDA kernels: the forward
(``kernel.cu``) and its gradient (``backward.cu``).

A CPU tensor takes the plain version in ``ref.py``, and so does a meta
tensor (the cost walker's: the walker charges the plain version, and
nothing launches); a CUDA tensor launches the kernel or raises (no
fallback).  ``LAUNCHES`` counts kernel launches,
one per launch and nowhere else.  The reference's wrapper cuts the heads
into slabs of at most 8 (a VMEM limit of the TPU); this one launches once
for all of them.

:func:`ssd_diag` is the differentiable entry: under autograd its forward is
:func:`ssd_diag_block` (the kernel on the card) and its backward is
:func:`ssd_diag_bwd`, one call of the hand-written backward that writes
all five inputs' gradients (its design is in ``backward.cu``'s header: the
scores recomputed per tile in shared memory, no q x q tensor in device
memory, a deterministic sum over a group's heads).  For CPU and meta
tensors the backward recomputes the plain version under autograd and
differentiates it, as the reference's own backward is autodiff of its XLA
einsums (``repro/models/ssm.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.proxy_blocks.ops import _aligned, _stream_handle
from repro_torch.kernels.ssd.ref import ssd_diag_ref

SOURCE = Path(__file__).resolve().parent / "kernel.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "backward.cu"
HEAD_DIMS = (8, 16, 32, 64)
MAX_CHUNK = 256
MAX_STATE = 128
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches since the last :func:`reset_counts`
LAUNCHES = {"ssd_diag": 0, "ssd_diag_bwd": 0}


def reset_counts() -> None:
    LAUNCHES["ssd_diag"] = 0
    LAUNCHES["ssd_diag_bwd"] = 0


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: the launchers' C signatures, set when a library is loaded
PROTOTYPES = {"ssd_diag_launch": ([_P] * 6 + [_LL] + [_I] * 7 + [_P], _I)}
BWD_PROTOTYPES = {
    "ssd_bwd_workspace": ([_LL] + [_I] * 4, _LL),
    "ssd_bwd_launch": ([_P] * 12 + [_LL] + [_I] * 6 + [_P], _I),
}


def _on_cuda(fn: str, ins: tuple) -> bool:
    """False where ``ins`` take the plain version (all on the CPU, or all
    meta tensors); True for one CUDA device; raises otherwise."""
    if (all(x.device.type == "cpu" for x in ins)
            or all(x.device.type == "meta" for x in ins)):
        return False
    if ins[0].device.type != "cuda" or any(x.device != ins[0].device
                                           for x in ins):
        raise ValueError(f"{fn}: inputs on "
                         f"{[str(x.device) for x in ins]}; all must be CPU "
                         "or on one CUDA device")
    return True


def _check(fn: str, xc, dtc, cum, bc, cc, r: int,
           out_dtype: torch.dtype) -> None:
    """Raise on what the kernels do not take."""
    if (xc.dtype not in DTYPES or bc.dtype != xc.dtype or cc.dtype != xc.dtype
            or dtc.dtype != torch.float32 or cum.dtype != torch.float32
            or out_dtype not in DTYPES):
        raise TypeError(f"{fn} takes f32 or bf16 x, B, C of one dtype, f32 "
                        "dt and cum, and an f32 or bf16 output; got "
                        f"{[x.dtype for x in (xc, dtc, cum, bc, cc)]} -> "
                        f"{out_dtype}")
    if xc.dim() != 5 or bc.dim() != 5 or cc.shape != bc.shape:
        raise ValueError(f"{fn}: x {tuple(xc.shape)}, B {tuple(bc.shape)}, "
                         f"C {tuple(cc.shape)}")
    b, c, q, h, p = xc.shape
    g, n = bc.shape[3], bc.shape[4]
    if (dtc.shape != (b, c, q, h) or cum.shape != dtc.shape
            or bc.shape[:3] != (b, c, q) or g * r != h):
        raise ValueError(f"{fn}: shapes x {tuple(xc.shape)}, dt "
                         f"{tuple(dtc.shape)}, cum {tuple(cum.shape)}, B "
                         f"{tuple(bc.shape)} with r={r} do not match")
    if p not in HEAD_DIMS or q > MAX_CHUNK or not 0 < n <= MAX_STATE:
        raise ValueError(f"{fn} takes head_dim in {HEAD_DIMS}, chunk <= "
                         f"{MAX_CHUNK} and state <= {MAX_STATE}; got p={p}, "
                         f"q={q}, n={n}")


def ssd_diag_block(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                   bc: torch.Tensor, cc: torch.Tensor, r: int,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Model layout: xc (b,c,q,h,p), dtc/cum (b,c,q,h), bc/cc (b,c,q,g,n)
    with h = g·r.  Returns y_diag (b,c,q,h,p) in ``out_dtype``, by default
    xc's dtype (the TPU kernel's contract)."""
    ins = (xc, dtc, cum, bc, cc)
    if not _on_cuda("ssd_diag_block", ins):
        return ssd_diag_ref(xc, dtc, cum, bc, cc, r, out_dtype)
    out_dtype = out_dtype or xc.dtype
    _check("ssd_diag_block", *ins, r, out_dtype)
    b, c, q, h, p = xc.shape
    g, n = bc.shape[3], bc.shape[4]
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


def ssd_diag_bwd(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                 bc: torch.Tensor, cc: torch.Tensor, r: int,
                 gy: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The gradients (dx, ddt, dcum, dB, dC) of :func:`ssd_diag_block`'s
    output against the incoming gradient ``gy`` (xc's shape, f32 or bf16:
    a bf16 ``gy`` is widened to f32), each in its input's dtype, from one
    call of the CUDA backward (two kernels, counted once).  CUDA tensors
    only: the plain gradient is autograd of ``ssd_diag_ref``."""
    ins = (xc, dtc, cum, bc, cc)
    _check("ssd_diag_bwd", *ins, r, gy.dtype)
    if gy.shape != xc.shape:
        raise ValueError(f"ssd_diag_bwd: gradient {tuple(gy.shape)} for x "
                         f"{tuple(xc.shape)}")
    if not _on_cuda("ssd_diag_bwd", ins + (gy,)):
        raise ValueError("ssd_diag_bwd runs on a CUDA device; CPU and meta "
                         "tensors differentiate ssd_diag_ref")
    b, c, q, h, p = xc.shape
    g, n = bc.shape[3], bc.shape[4]
    xc, dtc, cum, bc, cc = (_aligned(x) for x in ins)
    gy = _aligned(gy.float())
    grads = tuple(torch.empty_like(x) for x in (xc, dtc, cum, bc, cc))
    if xc.numel() == 0:
        return tuple(t.zero_() for t in grads)
    lib = build.load(BWD_SOURCE, BWD_PROTOTYPES)
    work = torch.empty(lib.ssd_bwd_workspace(b * c, q, h, g, n),
                       dtype=torch.float32, device=xc.device)
    dx, ddt, dcum, db, dc = grads
    code = lib.ssd_bwd_launch(
        xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(),
        cc.data_ptr(), gy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dcum.data_ptr(), db.data_ptr(), dc.data_ptr(), work.data_ptr(),
        b * c, q, h, g, n, p, int(xc.dtype == torch.bfloat16),
        _stream_handle(xc))
    build.check(lib, code, "ssd_diag_bwd")
    LAUNCHES["ssd_diag_bwd"] += 1
    return grads


class _SSDDiag(torch.autograd.Function):
    """Forward: the kernel (or, for CPU tensors, the plain version).
    Backward: :func:`ssd_diag_bwd` for CUDA tensors; for CPU and meta
    tensors the plain version recomputed and differentiated.  Saves only
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
        if _on_cuda("ssd_diag", ins + (gy,)):
            grads = ssd_diag_bwd(*ins, ctx.r, gy)
            return tuple(d if n else None for d, n in zip(grads, need)) + (
                None, None)
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
