"""Plain PyTorch version of the SSD diagonal-block kernel.

The function of the reference's ``repro/kernels/ssd/ref.py::ssd_diag_ref``
(all in f32) in the model layout the port's wrapper takes: xc (b,c,q,h,p),
dtc/cum (b,c,q,h), bc/cc (b,c,q,g,n) with h = g·r.  Used for CPU tensors,
and by ``chip_smoke.py`` to hold the CUDA kernel to on the card.
"""
from __future__ import annotations

import torch


def ssd_diag_ref(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                 bc: torch.Tensor, cc: torch.Tensor, r: int,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y_diag (b,c,q,h,p) in ``out_dtype`` (default: xc's dtype)."""
    b, c, q, h, p = xc.shape
    g = bc.shape[3]
    scores = torch.einsum("bcqgn,bckgn->bcgqk", cc.float(), bc.float())
    cumg = cum.float().reshape(b, c, q, g, r)
    dec = cumg[:, :, :, None] - cumg[:, :, None]           # (b,c,q,k,g,r)
    iq = torch.arange(q, device=xc.device)
    causal = (iq[:, None] >= iq[None, :])[:, :, None, None]
    # masked before exp: for k > q the exponent is positive and can
    # overflow, and 0 * inf would make the gradient NaN
    lmask = torch.exp(torch.where(causal, dec, -torch.inf))
    m = scores.permute(0, 1, 3, 4, 2)[..., None] * lmask    # (b,c,q,k,g,r)
    dx = dtc.float()[..., None] * xc.float()                # (b,c,k,h,p)
    y = torch.einsum("bcqkgr,bckgrp->bcqgrp", m, dx.reshape(b, c, q, g, r, p))
    return y.reshape(b, c, q, h, p).to(out_dtype or xc.dtype)
