"""Plain f32 reference of the port's Mamba2 configuration (family ``ssm``).

One layer: x + mixer(rmsnorm(x)), the mixer as Mamba2's (Dao and Gu,
arXiv:2405.21060): in_proj to [z, x, B, C, dt]; a depthwise causal conv of
width 4 over [x, B, C], then SiLU; dt = softplus(dt + dt_bias), A =
-exp(a_log); the SSD scan by the paper's chunked algorithm (its minimal
listing: the quadratic form within a chunk, chunk states, the recurrence
across chunks, the off-diagonal read); y + D x; the configuration's gated
norm rmsnorm(y) * silu(z); out_proj.  No decode cache: every position from
the prompt alone.  The layout of the weights is the port's parameter tree
(every layer stacked in ``unit[0]``).  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import Numerics, rms_norm
from bench.weights import Spec

CONV_W = 4


def _dims(sz: dict):
    d = sz["d_model"]
    d_in = sz["ssm_expand"] * d
    h = d_in // sz["ssm_head_dim"]
    gn = sz["ssm_groups"] * sz["ssm_state"]
    return d, d_in, h, gn


def param_specs(sz: dict) -> dict:
    """The inputs' tree, each leaf with the published model's initialisation
    (mamba_ssm's Mamba2 and MambaLMHeadModel): linear weights at PyTorch's
    default (kaiming-uniform) standard deviation 1/sqrt(3 fan_in), drawn
    normal; out_proj divided by sqrt(n_layers) (rescale_prenorm_residual);
    the conv's weight and bias at fan-in 4; A = U[1, 16]; dt log-uniform on
    [0.001, 0.1]; D and the norms' factors 1; the embedding N(0, 0.02)."""
    d, d_in, h, gn = _dims(sz)
    n, dt = sz["n_layers"], sz["dtype"]
    conv_dim = d_in + 2 * gn
    f32 = "float32"
    conv = 1.0 / math.sqrt(3 * CONV_W)
    unit = {
        "ln1": Spec((n, d), "zeros", dtype=f32),
        "mixer": {
            "in_proj": Spec((n, d, 2 * d_in + 2 * gn + h), "normal",
                            1.0 / math.sqrt(3 * d), dtype=dt),
            "conv_w": Spec((n, CONV_W, conv_dim), "normal", conv, dtype=dt),
            "conv_b": Spec((n, conv_dim), "normal", conv, dtype=dt),
            "a_log": Spec((n, h), "log_uniform", 1.0, 16.0, dtype=f32),
            "d_skip": Spec((n, h), "ones", dtype=f32),
            "dt_bias": Spec((n, h), "dt_bias", 1e-3, 1e-1, dtype=f32),
            "norm_w": Spec((n, d_in), "zeros", dtype=f32),
            "out_proj": Spec((n, d_in, d), "normal",
                             1.0 / math.sqrt(3 * d_in * n), dtype=dt),
        },
    }
    return {"embed": Spec((sz["padded_vocab"], d), "normal", 0.02, dtype=dt),
            "final_norm": Spec((d,), "zeros", dtype=f32),
            "unit": (unit,), "rest": ()}


def ssd(x, dt, a, bm, cm, chunk: int, num: Numerics):
    """y (b, l, h, p) of the SSM h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_tᵀ,
    y_t = C_t h_t, from a zero state, by the paper's chunked algorithm.
    x: (b, l, h, p), dt: (b, l, h), a: (h,), bm/cm: (b, l, g, n)."""
    b, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    r, q = h // g, min(chunk, l)
    c = l // q
    xs = (x * dt[..., None]).reshape(b, c, q, g, r, p)
    la = (dt * a).reshape(b, c, q, g, r)                     # log decay a step
    cum = torch.cumsum(la, dim=2)                            # (b, c, q, g, r)
    bc, cc = bm.reshape(b, c, q, g, n), cm.reshape(b, c, q, g, n)
    # within a chunk: y_t = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
    seg = cum[:, :, :, None] - cum[:, :, None]               # (b,c,t,s,g,r)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[:, :, None, None], -torch.inf))
    scores = num.einsum("bctgn,bcsgn->bctsg", cc, bc)
    y = num.einsum("bctsgr,bcsgrp->bctgrp", scores[..., None] * decay, xs)
    # each chunk's final state, and the recurrence across chunks
    to_end = torch.exp(cum[:, :, -1:] - cum)                 # (b, c, q, g, r)
    states = num.einsum("bcsgn,bcsgrp->bcgrpn", bc, xs * to_end[..., None])
    total = torch.exp(cum[:, :, -1])                         # (b, c, g, r)
    hstate = torch.zeros((b, g, r, p, n), dtype=x.dtype, device=x.device)
    entering = []
    for i in range(c):
        entering.append(hstate)
        hstate = hstate * total[:, i, :, :, None, None] + states[:, i]
    hin = torch.stack(entering, dim=1)                       # (b, c, g, r, p, n)
    y_off = num.einsum("bctgn,bcgrpn->bctgrp", cc, hin)
    y = y + y_off * torch.exp(cum)[..., None]
    return y.reshape(b, l, h, p)


def _causal_conv(x, w, bias):
    """Depthwise causal conv: out_t = sum_j w[j] x_{t - (CONV_W - 1) + j}."""
    out = x * w[CONV_W - 1]
    for lag in range(1, CONV_W):
        shifted = torch.cat([torch.zeros_like(x[:, :lag]), x[:, :-lag]], 1)
        out = out + shifted * w[CONV_W - 1 - lag]
    return F.silu(out + bias)


def mixer(sz: dict, w: dict, x, num: Numerics):
    d, d_in, h, gn = _dims(sz)
    b, l, _ = x.shape
    p, g, n = sz["ssm_head_dim"], sz["ssm_groups"], sz["ssm_state"]
    zxbcdt = num.mm(x, w["in_proj"])
    z = zxbcdt[..., :d_in]
    xbc = _causal_conv(zxbcdt[..., d_in:2 * d_in + 2 * gn], w["conv_w"],
                       w["conv_b"])
    dt = F.softplus(zxbcdt[..., 2 * d_in + 2 * gn:] + w["dt_bias"])
    xs = xbc[..., :d_in].reshape(b, l, h, p)
    bm = xbc[..., d_in:d_in + gn].reshape(b, l, g, n)
    cm = xbc[..., d_in + gn:].reshape(b, l, g, n)
    y = ssd(xs, dt, -torch.exp(w["a_log"]), bm, cm, sz["ssm_chunk"], num)
    y = (y + w["d_skip"][:, None] * xs).reshape(b, l, d_in)
    y = rms_norm(y, w["norm_w"]) * F.silu(z)
    return num.mm(y, w["out_proj"])


def layer(sz: dict, w: dict, x, num: Numerics):
    """One layer (b, s, d) -> ((b, s, d), balance loss 0)."""
    return x + mixer(sz, w["mixer"], rms_norm(x, w["ln1"]), num), 0.0
