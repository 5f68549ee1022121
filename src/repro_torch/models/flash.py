"""Flash attention with a backward: the port of ``src/repro/models/
flash.py::flash_attention`` (its custom VJP).

Forward: the flash kernel (``kernels/flash_attention``: CUDA on the card,
the plain version on the CPU), which also gives each row's log-sum-exp
when a gradient is wanted.  Only (q, k, v, out, lse) survive to the
backward, as in the reference (``flash.py:216``); the backward is the
FlashAttention-2 recomputation, the hand-written ``flash_bwd`` kernel on
the card and ``attention_bwd_ref`` on the CPU.  Without autograd (grad mode
off, or no input that needs a gradient) this is the forward wrapper alone,
which writes no LSE: the serve path launches what it launched before.

The reference's sharding (``attn_mode``, ``_axes``, constraints) waits for
the port's mesh slice, and its ``q_chunk``/``kv_chunk`` arguments are not
needed: the kernels take any s and t.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import (
    flash_attention_bwd, flash_attention_fwd,
)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: (b,s,h,d), k/v: (b,t,g,d) -> (b,s,h,d) in q's dtype."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Flash.apply(q, k, v, causal, window)
    return flash_attention_fwd(q, k, v, causal=causal, window=window)
