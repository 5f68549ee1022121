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

On a mesh (an :class:`~repro_torch.sharding.spmd.Spmd` context) each
process runs its heads where the ``model`` axis divides them (B/C groups
that do not line up with them reach each head by an index map), else
every head, as the rules leave the heads whole (Mamba2 2.7B's 80 on 3):
then its span of ``d_in`` goes through ``out_proj``, summed over
``model`` (:class:`_Deal`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.core.tracer import einsum, matmul, scan_loop
from repro_torch.kernels.ssd.ops import ssd_diag
from repro_torch.models.layers import Param
from repro_torch.sharding.spmd import kv_groups, span

CONV_W = 4


def every_head(cfg, tp: int) -> bool:
    """Whether each process of a model axis of ``tp`` runs every SSM head
    of ``cfg`` (the axis does not divide them), its decode cache whole."""
    return bool(cfg.ssm_state) and (
        cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim) % tp != 0


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


def _rms(x, w, eps=1e-6, mesh=None):
    """The gated norm's RMS over the last dim; on a mesh that dim is this
    process's block of ``d_in``, and the sum of squares is all-reduced."""
    xf = x.float()
    if mesh is None:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ms = mesh.reduce_partial((xf * xf).sum(dim=-1, keepdim=True)) \
            / (x.shape[-1] * mesh.tp)
    xf = xf * torch.rsqrt(ms + eps)
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
    with spans.span("ssm.ssd_diag"):
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


class _Deal:
    """A mesh's re-deal of the SSM's columns for this process: the whole
    in_proj and conv weights, the column ranges of its heads and groups
    (every head where ``model`` does not divide them: ``heads``, the
    per-head parameters then through ``Spmd.copy``), the index map of its
    heads' groups where they do not line up (``gidx``), and ``out``: this
    process's span of ``d_in`` into ``out_proj`` where it runs every
    head."""

    def __init__(self, p, d: int, head_dim: int, n_state: int,
                 n_groups: int, expand: int, mesh):
        self.mesh = mesh
        d_in = expand * d
        h = d_in // head_dim
        gn = n_groups * n_state
        self.proj_shape = (d, 2 * d_in + 2 * gn + h)
        self.conv_dim = d_in + 2 * gn
        self.heads = h % mesh.tp == 0
        if self.heads:
            hl, r = h // mesh.tp, mesh.r
            glo, ghi, self.gidx = kv_groups(h, n_groups, mesh.tp, r)
        else:
            hl, r, glo, ghi, self.gidx = h, 0, 0, n_groups, None
        self.hl, self.gl = hl, ghi - glo
        x0 = r * hl * head_dim
        xl = hl * head_dim
        self.z = (x0, x0 + xl)
        self.x = (d_in + x0, d_in + x0 + xl)
        self.b = (2 * d_in + glo * n_state, 2 * d_in + ghi * n_state)
        self.c = (2 * d_in + gn + glo * n_state, 2 * d_in + gn + ghi * n_state)
        dt0 = 2 * d_in + 2 * gn
        self.dt = (dt0 + r * hl, dt0 + (r + 1) * hl)
        # the same columns within conv_dim ([x | B | C])
        self.conv = [(a - d_in, b - d_in) for a, b in (self.x, self.b, self.c)]
        self.in_proj = mesh.unshard(p["in_proj"], self.proj_shape,
                                    ("embed", "conv_dim"))
        self.proj_split = bool(mesh.split(self.proj_shape,
                                          ("embed", "conv_dim"), 1))
        if not self.proj_split:         # every process uses a part of it
            self.in_proj = mesh.copy(self.in_proj)
        cshape = (CONV_W, self.conv_dim)
        # the decode cache's conv history: this process's block of columns
        # where the rules split them and it runs its heads, else whole
        self.conv_split = self.heads and bool(
            mesh.split(cshape, (None, "conv_dim"), 1))
        self.conv_w = mesh.whole(p["conv_w"], cshape, (None, "conv_dim"))
        self.conv_b = mesh.whole(p["conv_b"], cshape[1:], ("conv_dim",))
        self.out_proj = mesh.unshard(p["out_proj"], (d_in, d),
                                     ("ffn", "embed"))
        self.out = None
        per_head = {k: p[k] for k in ("a_log", "d_skip", "dt_bias")}
        self.norm_w = p["norm_w"]
        if not self.heads:
            per_head = {k: mesh.copy(v) for k, v in per_head.items()}
            self.norm_w = mesh.whole(p["norm_w"], (d_in,), ("ffn",))
            self.out = span(d_in, mesh.tp, mesh.r)
            if not mesh.split((d_in, d), ("ffn", "embed"), 0):
                self.out_proj = mesh.copy(self.out_proj)[slice(*self.out)]
        self.a_log, self.d_skip, self.dt_bias = (
            per_head["a_log"], per_head["d_skip"], per_head["dt_bias"])

    def conv_whole(self, t, dim: int):
        """The decode cache's conv history with every column (gathered
        where this process holds its block)."""
        return self.mesh.gather(t, dim) if self.conv_split else t

    def project(self, x):
        """``x @ in_proj`` with every column, from this process's block:
        the weight gathered, or the output where it is the smaller."""
        x = self.mesh.copy(x)
        if not self.proj_split:
            return x @ self.in_proj
        rows = x.numel() // x.shape[-1]
        if rows > self.proj_shape[0]:
            return x @ self.mesh.gather(self.in_proj, 1)
        return self.mesh.gather(x @ self.in_proj, -1)

    @staticmethod
    def cols(t, *ranges):
        return torch.cat([t[..., a:b] for a, b in ranges], dim=-1) \
            if len(ranges) > 1 else t[..., ranges[0][0]:ranges[0][1]]

    def groups(self, t):
        """B or C (..., local groups, n) with one group a local head where
        the groups do not line up with the heads."""
        return t if self.gidx is None else t[..., self.gidx, :]

    def output(self, y):
        """``y`` (..., this process's ``d_in`` columns) through ``out_proj``,
        summed over ``model``."""
        if self.out is not None:
            y = y[..., self.out[0]:self.out[1]]
        return self.mesh.reduce(matmul(y, self.out_proj))

    def conv_block(self, t):
        """This process's ``conv_dim`` block of a whole-column tensor."""
        if not self.conv_split:
            return t
        idx, n = self.mesh.block()
        size = self.conv_dim // n
        return t[..., idx * size:(idx + 1) * size]


def ssm_apply(p, x, *, head_dim: int, n_state: int, n_groups: int,
              expand: int, chunk: int, return_cache: bool = False,
              mesh=None):
    """Full Mamba2 mixer on (b, l, d) → (b, l, d) [, decode cache]."""
    with spans.span("ssm.mixer"):
        if mesh is not None:
            return _ssm_apply_split(p, x, head_dim=head_dim,
                                    n_state=n_state, n_groups=n_groups,
                                    expand=expand, chunk=chunk,
                                    return_cache=return_cache, mesh=mesh)
        return _ssm_apply_whole(p, x, head_dim=head_dim, n_state=n_state,
                                n_groups=n_groups, expand=expand,
                                chunk=chunk, return_cache=return_cache)


def _ssm_apply_whole(p, x, *, head_dim, n_state, n_groups, expand, chunk,
                     return_cache):
    """:func:`ssm_apply` without a mesh."""
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


def _ssm_apply_split(p, x, *, head_dim, n_state, n_groups, expand, chunk,
                     return_cache, mesh):
    """:func:`ssm_apply` on this process's heads (module docstring)."""
    b, l, d = x.shape
    deal = _Deal(p, d, head_dim, n_state, n_groups, expand, mesh)
    zxbcdt = deal.project(x)
    z = deal.cols(zxbcdt, deal.z)
    dt = deal.cols(zxbcdt, deal.dt)
    conv_in = deal.cols(zxbcdt, deal.x, deal.b, deal.c)
    conv_out = _causal_conv(conv_in, deal.cols(deal.conv_w, *deal.conv),
                            deal.cols(deal.conv_b, *deal.conv))
    xl = deal.hl * head_dim
    gn = deal.gl * n_state
    xs, bm, cm = (conv_out[..., :xl], conv_out[..., xl:xl + gn],
                  conv_out[..., xl + gn:])
    dtv = _softplus(dt.float() + deal.dt_bias)
    a = -torch.exp(deal.a_log)
    xh = xs.reshape(b, l, deal.hl, head_dim)
    res = ssd_chunked(xh, dtv, a,
                      deal.groups(bm.reshape(b, l, deal.gl, n_state)),
                      deal.groups(cm.reshape(b, l, deal.gl, n_state)), chunk,
                      return_final=return_cache)
    y, final = res if return_cache else (res, None)
    y = y + deal.d_skip[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(b, l, xl)
    y = _rms(y, deal.norm_w, mesh=mesh if deal.heads else None) * F.silu(z)
    out = deal.output(y).to(x.dtype)
    if return_cache:
        tail = zxbcdt[:, l - (CONV_W - 1):]
        whole = tail[..., expand * d:expand * d + deal.conv_dim]
        return out, {"state": final, "conv": deal.conv_block(whole)}
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


def ssm_cache_axes() -> dict:
    return {"state": ("batch", "ssm_heads", "head_dim", "ssm_state"),
            "conv": ("batch", None, "conv_dim")}


def ssm_decode(p, x, cache: dict, *, head_dim: int, n_state: int,
               n_groups: int, expand: int, mesh=None):
    """One-token decode; x: (b, 1, d) → (out (b,1,d), new cache).  On a
    mesh the cache is this process's block: the state of its heads, the
    conv history of its ``conv_dim`` columns."""
    if mesh is not None:
        return _ssm_decode_split(p, x, cache, head_dim=head_dim,
                                 n_state=n_state, n_groups=n_groups,
                                 expand=expand, mesh=mesh)
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


def _ssm_decode_split(p, x, cache, *, head_dim, n_state, n_groups, expand,
                      mesh):
    b, _, d = x.shape
    d_in = expand * d
    deal = _Deal(p, d, head_dim, n_state, n_groups, expand, mesh)
    zxbcdt = deal.project(x[:, 0])                           # (b, proj)
    conv_in = zxbcdt[..., d_in:d_in + deal.conv_dim]         # every column
    hist = torch.cat([deal.conv_whole(cache["conv"], 2), conv_in[:, None]],
                     dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist, deal.conv_w) + deal.conv_b
    conv_out = F.silu(conv_out)
    new_conv = deal.conv_block(hist[:, 1:])
    xs = deal.cols(conv_out, deal.conv[0])
    bm = deal.groups(deal.cols(conv_out, deal.conv[1]).reshape(
        b, deal.gl, n_state))
    cm = deal.groups(deal.cols(conv_out, deal.conv[2]).reshape(
        b, deal.gl, n_state))
    z = deal.cols(zxbcdt, deal.z)
    dt = deal.cols(zxbcdt, deal.dt)
    dtv = _softplus(dt.float() + deal.dt_bias)               # (b,hl)
    a = -torch.exp(deal.a_log)
    da = torch.exp(dtv * a)
    xh = xs.reshape(b, deal.hl, head_dim).float()
    r = deal.hl // bm.shape[1]
    bh = bm.repeat_interleave(r, dim=1).float()
    ch = cm.repeat_interleave(r, dim=1).float()
    state = cache["state"] * da[..., None, None] + \
        (dtv[..., None] * xh)[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    y = y + deal.d_skip[None, :, None] * xh
    y = y.reshape(b, deal.hl * head_dim)
    y = _rms(y, deal.norm_w, mesh=mesh if deal.heads else None) * \
        F.silu(z).float()
    out = deal.output(y)[:, None].to(x.dtype)
    return out, {"state": state, "conv": new_conv}
