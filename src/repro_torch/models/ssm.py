"""Mamba2 (SSD — state-space duality) mixer: chunked prefill form and the
O(1)-state decode step.

The port of ``src/repro/models/ssm.py``.  Shapes follow the Mamba2 paper:
inner width d_in = expand*d, heads h with head dim p (d_in = h*p), B/C
grouped (g groups, state n).  The chunked SSD:

    within chunk c (length q):  Y_diag = (C B^T ∘ L) (dt·X)
    chunk state:                S_c    = Σ_j exp(cum_end-cum_j) dt_j B_j⊗X_j
    across chunks:              H_{c+1} = exp(Σ adt_c) H_c + S_c
    off-diagonal:               Y_off  = (C H_c) ∘ exp(cum)

Y_diag, the quadratic-in-chunk hot spot, goes through the SSD kernel
(``kernels/ssd``: CUDA on the card, its plain version on the CPU) and stays
in f32, as the reference's einsum path keeps it.  The rest is plain torch
with the reference's dtype flow: where the reference mixes bf16 and f32
operands, JAX promotes to f32, so the port casts to f32 explicitly (in a
product through :func:`~repro_torch.core.tracer.einsum`/``matmul``, which
the cost walker charges as jnp's one mixed-dtype ``dot_general``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tracer import einsum, matmul, scan_loop
from repro_torch.kernels.ssd.ops import ssd_diag
from repro_torch.models.layers import Param

CONV_W = 4


def ssm_params(d: int, *, expand: int, head_dim: int, n_state: int,
               n_groups: int, dtype: str) -> dict:
    d_in = expand * d
    h = d_in // head_dim
    conv_dim = d_in + 2 * n_groups * n_state
    return {
        # in_proj → [z (d_in), x (d_in), B (g·n), C (g·n), dt (h)]
        "in_proj": Param((d, 2 * d_in + 2 * n_groups * n_state + h),
                         ("embed", "conv_dim"), dtype=dtype),
        "conv_w": Param((CONV_W, conv_dim), (None, "conv_dim"), dtype=dtype),
        "conv_b": Param((conv_dim,), ("conv_dim",), scale=0.0, dtype=dtype),
        "a_log": Param((h,), ("ssm_heads",), scale=0.0, dtype="float32"),
        "d_skip": Param((h,), ("ssm_heads",), dtype="float32"),
        "dt_bias": Param((h,), ("ssm_heads",), scale=0.0, dtype="float32"),
        "norm_w": Param((d_in,), ("ffn",), scale=0.0, dtype="float32"),
        "out_proj": Param((d_in, d), ("ffn", "embed"), dtype=dtype),
    }


def _split_proj(zxbcdt, d_in: int, gn: int, h: int):
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    bm = zxbcdt[..., 2 * d_in:2 * d_in + gn]
    cm = zxbcdt[..., 2 * d_in + gn:2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    assert dt.shape[-1] == h
    return z, x, bm, cm, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b):
    """Depthwise causal conv width 4 via shifted adds."""
    out = x * w[-1]
    for i in range(1, CONV_W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
        out = out + shifted * w[-1 - i]
    return F.silu(out + b)


def _rms(x, w, eps=1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w)).to(x.dtype)


def ssd_chunked(x, dt, a, bm, cm, chunk: int, return_final: bool = False):
    """x: (b,l,h,p)  dt: (b,l,h)  a: (h,)  bm/cm: (b,l,g,n)  → y: (b,l,h,p).

    ``return_final`` additionally returns the post-sequence SSM state in the
    decode-cache layout (b, h, p, n) — used by prefill.
    """
    b, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, l)
    c = l // q
    if c * q != l:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD "
                         f"chunk {q}")
    r = h // g

    xc = x.reshape(b, c, q, h, p)
    dtc = dt.reshape(b, c, q, h).float()
    bc = bm.reshape(b, c, q, g, n)
    cc = cm.reshape(b, c, q, g, n)

    adt = dtc * a[None, None, None, :]                       # (b,c,q,h) <= 0
    cum = torch.cumsum(adt, dim=2)                           # (b,c,q,h)
    y_diag = ssd_diag(xc, dtc, cum, bc, cc, r, out_dtype=torch.float32)

    # chunk-final states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j ⊗ X_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,c,q,h)
    w = dtc * decay_to_end
    bg = bc.reshape(b, c, q, g, 1, n)
    s_c = torch.einsum("bcqgrn,bcqgrp->bcgrnp",
                       bg.expand(b, c, q, g, r, n).float()
                       * w.reshape(b, c, q, g, r, 1),
                       xc.float().reshape(b, c, q, g, r, p))

    # inter-chunk recurrence: a scan over the chunks, as the reference's
    cdg = torch.exp(torch.sum(adt, dim=2)).reshape(b, c, g, r)

    def scanbody(hstate, inputs):
        dcy, s = inputs                                   # (b,g,r), (b,g,r,n,p)
        return hstate * dcy[..., None, None] + s, hstate

    h0 = torch.zeros((b, g, r, n, p), dtype=torch.float32, device=x.device)
    hstate, hs = scan_loop(c, scanbody, h0,
                           xs=(cdg.transpose(0, 1), s_c.transpose(0, 1)),
                           stack_ys=True)
    hs = hs.transpose(0, 1)                                  # (b,c,g,r,n,p)

    # off-diagonal: Y_off = (C · H_in) * exp(cum)
    y_off = einsum("bcqgn,bcgrnp->bcqgrp", cc, hs)
    y_off = y_off * torch.exp(cum).reshape(b, c, q, g, r, 1)
    y = y_diag.reshape(b, c, q, g, r, p) + y_off
    y = y.reshape(b, l, h, p).to(x.dtype)
    if return_final:
        final = hstate.reshape(b, h, n, p).transpose(-1, -2)  # (b,h,p,n)
        return y, final
    return y


def ssm_apply(p, x, *, head_dim: int, n_state: int, n_groups: int,
              expand: int, chunk: int, return_cache: bool = False):
    """Full Mamba2 mixer on (b, l, d) → (b, l, d) [, decode cache]."""
    b, l, d = x.shape
    d_in = expand * d
    h = d_in // head_dim
    gn = n_groups * n_state

    zxbcdt = x @ p["in_proj"]
    z, xs, bm, cm, dt = _split_proj(zxbcdt, d_in, gn, h)
    conv_in = torch.cat([xs, bm, cm], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xs, bm, cm = (conv_out[..., :d_in],
                  conv_out[..., d_in:d_in + gn],
                  conv_out[..., d_in + gn:])

    dtv = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(b, l, h, head_dim)
    res = ssd_chunked(xh, dtv, a,
                      bm.reshape(b, l, n_groups, n_state),
                      cm.reshape(b, l, n_groups, n_state),
                      chunk, return_final=return_cache)
    y, final = res if return_cache else (res, None)
    y = y + p["d_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(b, l, d_in)
    y = _rms(y, p["norm_w"]) * F.silu(z)
    out = (y @ p["out_proj"]).to(x.dtype)
    if return_cache:
        return out, {"state": final, "conv": conv_in[:, l - (CONV_W - 1):]}
    return out


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------


def init_ssm_cache(batch: int, d: int, *, expand: int, head_dim: int,
                   n_state: int, n_groups: int, dtype: torch.dtype,
                   device) -> dict:
    d_in = expand * d
    h = d_in // head_dim
    conv_dim = d_in + 2 * n_groups * n_state
    return {
        "state": torch.zeros((batch, h, head_dim, n_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_W - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def ssm_decode(p, x, cache: dict, *, head_dim: int, n_state: int,
               n_groups: int, expand: int):
    """One-token decode; x: (b, 1, d) → (out (b,1,d), new cache)."""
    b, _, d = x.shape
    d_in = expand * d
    h = d_in // head_dim
    gn = n_groups * n_state

    zxbcdt = x[:, 0] @ p["in_proj"]                          # (b, proj)
    z, xs, bm, cm, dt = _split_proj(zxbcdt, d_in, gn, h)
    conv_in = torch.cat([xs, bm, cm], dim=-1)                # (b, conv_dim)
    hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    new_conv = hist[:, 1:]
    xs = conv_out[..., :d_in]
    bm = conv_out[..., d_in:d_in + gn].reshape(b, n_groups, n_state)
    cm = conv_out[..., d_in + gn:].reshape(b, n_groups, n_state)

    dtv = _softplus(dt.float() + p["dt_bias"])               # (b,h)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dtv * a)                                   # (b,h)
    xh = xs.reshape(b, h, head_dim).float()
    r = h // n_groups
    bh = bm.repeat_interleave(r, dim=1).float()               # (b,h,n)
    ch = cm.repeat_interleave(r, dim=1).float()
    state = cache["state"] * da[..., None, None] + \
        (dtv[..., None] * xh)[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(b, d_in)
    y = _rms(y, p["norm_w"]) * F.silu(z).float()
    out = matmul(y, p["out_proj"])[:, None].to(x.dtype)
    return out, {"state": state, "conv": new_conv}
