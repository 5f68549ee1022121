"""Plain PyTorch version of the flash-attention forward kernel.

The function of the reference's ``repro/kernels/flash_attention/ref.py::
attention_ref`` (scores and softmax in f32, output in q's dtype), in the
model layout the port's wrapper takes: q (b,s,h,d), k/v (b,t,g,d) with
query head ``i`` reading KV head ``i // (h // g)`` (the reference's
``jnp.repeat`` along the head axis).  For bf16 inputs the unnormalised
probabilities P = exp(s - max) are rounded to bf16 before P·V, and the
normaliser sums them in f32: the kernel's precision contract, and that of
the JAX serve path (``repro/models/flash.py::_fwd_block``,
``p.astype(v.dtype)``).  Used for CPU tensors, and by ``chip_smoke.py`` to
hold the CUDA kernel to on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None
                  ) -> torch.Tensor:
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, g, h // g, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) / math.sqrt(d)
    if causal:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(t, device=q.device)[None, :]
        m = j <= i
        if window is not None:
            m = m & (j > i - window)
        scores = torch.where(m, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bgrst,btgd->bgrsd", p, v.float()) / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
