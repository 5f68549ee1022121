"""Plain PyTorch versions of the flash-attention kernels.

``attention_ref`` is the function of the reference's ``repro/kernels/
flash_attention/ref.py::attention_ref`` (scores and softmax in f32, output
in q's dtype), in the model layout the port's wrapper takes: q (b,s,h,d),
k/v (b,t,g,d) with query head ``i`` reading KV head ``i // (h // g)`` (the
reference's ``jnp.repeat`` along the head axis).  For bf16 inputs the
unnormalised probabilities P = exp(s - max) are rounded to bf16 before P·V,
and the normaliser sums them in f32: the kernel's precision contract, and
that of the JAX serve path (``repro/models/flash.py::_fwd_block``,
``p.astype(v.dtype)``).  With ``return_lse`` it also gives each row's
log-sum-exp, m + log l, in f32.

``attention_bwd_ref`` is the backward of ``repro/models/flash.py::
_flash_bwd`` computed directly on the whole (s, t) score matrix, not by
blocks: D = rowsum(dO o O), P = exp(S - lse), dS = P o (dP - D) scale, and
dq, dk, dv with dk and dv summed over the query heads of each KV group.
For bf16 inputs P and dS are rounded to bf16 before the products that take
them (dV = P^T dO, dQ = dS K, dK = dS^T Q): the backward kernel's contract
(the reference keeps them in f32; ROADMAP, port difference 4).

Used for CPU tensors, and by ``chip_smoke.py`` to hold the CUDA kernels to
on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(s: int, t: int, window: int | None, device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m


def _scores(q, k, causal, window):
    """Scaled scores (b,g,r,s,t) in f32, masked to NEG_INF, and the mask."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, g, h // g, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) / math.sqrt(d)
    if not causal:
        return scores, None
    m = _mask(s, t, window, q.device)
    return torch.where(m, scores, NEG_INF), m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  return_lse: bool = False):
    b, s, h, d = q.shape
    scores, _ = _scores(q, k, causal, window)
    mx = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - mx)
    l = p.sum(dim=-1)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bgrst,btgd->bgrsd", p, v.float()) / l[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = mx[..., 0] + torch.log(l.clamp_min(1e-30))        # (b,g,r,s)
    return out, lse.permute(0, 3, 1, 2).reshape(b, s, h)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: int | None = None):
    """(dq, dk, dv) in q's, k's and v's dtypes."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    r = h // g
    scale = 1.0 / math.sqrt(d)
    scores, m = _scores(q, k, causal, window)
    lse_g = lse.float().reshape(b, s, g, r).permute(0, 2, 3, 1)
    p = torch.exp(scores - lse_g[..., None])                 # (b,g,r,s,t)
    if m is not None:
        p = torch.where(m, p, 0.0)
    do = dout.float().reshape(b, s, g, r, d)
    dvec = (do * out.float().reshape(b, s, g, r, d)).sum(-1)  # (b,s,g,r)
    dp = torch.einsum("bsgrd,btgd->bgrst", do, v.float())
    ds = p * (dp - dvec.permute(0, 2, 3, 1)[..., None]) * scale
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    dv = torch.einsum("bgrst,bsgrd->btgd", p, do)
    dk = torch.einsum("bgrst,bsgrd->btgd", ds,
                      q.float().reshape(b, s, g, r, d))
    dq = torch.einsum("bgrst,btgd->bsgrd", ds, k.float()).reshape(b, s, h, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
