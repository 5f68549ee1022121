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

Every function takes ``q_offset``: q's row ``i`` is position
``q_offset + i`` for the causal and window masks (a context-parallel block
of query rows against every key); at 0 each computes what it computed
before the argument.

Used for CPU tensors, and by ``chip_smoke.py`` to hold the CUDA kernels to
on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _at(positions: torch.Tensor, q_offset: int) -> torch.Tensor:
    """``positions`` moved by ``q_offset`` (untouched at 0: no operation
    for the cost walker to charge)."""
    return positions + q_offset if q_offset else positions


def _mask(s: int, t: int, window: int | None, device,
          q_offset: int = 0) -> torch.Tensor:
    i = _at(torch.arange(s, device=device)[:, None], q_offset)
    j = torch.arange(t, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m


def _scores(q, k, causal, window, q_offset=0):
    """Scaled scores (b,g,r,s,t) in f32, masked to NEG_INF, and the mask."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, g, h // g, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) / math.sqrt(d)
    if not causal:
        return scores, None
    m = _mask(s, t, window, q.device, q_offset)
    return torch.where(m, scores, NEG_INF), m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  return_lse: bool = False, q_offset: int = 0):
    b, s, h, d = q.shape
    scores, _ = _scores(q, k, causal, window, q_offset)
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
                      window: int | None = None, q_offset: int = 0):
    """(dq, dk, dv) in q's, k's and v's dtypes."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    r = h // g
    scale = 1.0 / math.sqrt(d)
    scores, m = _scores(q, k, causal, window, q_offset)
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


# ---------------------------------------------------------------------------
# the reference's blocked XLA flash (what its walker charges)
# ---------------------------------------------------------------------------

#: ``src/repro/models/flash.py``'s block sizes and mask value
Q_CHUNK = 256
KV_CHUNK = 1024
BLOCK_NEG_INF = -2.0 ** 30


def _pad_seq(x: torch.Tensor, c: int):
    s = x.shape[1]
    sp = ((s + c - 1) // c) * c
    if sp != s:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, sp - s))
    return x, sp


def _block_mask(qpos, kpos, causal: bool, window, limit):
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
    if limit is not None:
        lm = kpos < limit
        mask = lm[None, :] if mask is None else (mask & lm[None, :])
    return mask


def _cond(needed: torch.Tensor, live, skip, carry):
    """``lax.cond(needed, live, skip, carry)``.  A meta tensor has no value:
    take ``live``, the costlier branch, which is what the reference's walker
    charges for a cond (the larger branch's cost, column by column)."""
    needed = needed.to(torch.int32)        # cond's index (convert_element_type)
    if needed.device.type == "meta" or bool(needed):
        return live(carry)
    return skip(carry)


def _strip(causal, window, cq, ck, t_pad):
    use = causal and window is not None and \
        ((window + cq + ck - 1) // ck) * ck < t_pad
    return use, (min(((window + cq + ck - 1) // ck) * ck, t_pad) if use
                 else t_pad)


def _kv_strip(kp, vp, qi, cq, strip, t_pad, use_strip, q_offset=0):
    """The K/V strip a q chunk reads, its positions and its start."""
    b, _, g, d = kp.shape
    if not use_strip:
        return kp, vp, torch.arange(t_pad, dtype=torch.int32,
                                    device=kp.device), 0
    from repro_torch.core.tracer import dynamic_slice
    start = torch.clamp(_at(qi * cq, q_offset) + cq - strip, 0,
                        t_pad - strip)
    ks = dynamic_slice(kp, 1, start, strip)
    vs = dynamic_slice(vp, 1, start, strip)
    return ks, vs, start + torch.arange(strip, dtype=torch.int32,
                                        device=kp.device), start


def _chunk_kv(k: torch.Tensor, ck: int) -> torch.Tensor:
    b, t, g, d = k.shape
    return k.reshape(b, t // ck, ck, g, d).transpose(0, 1)


def _needed(kpj, qpos, window):
    needed = kpj[0] <= qpos[-1]
    if window is not None:
        needed = needed & (kpj[-1] > qpos[0] - window)
    return needed


def attention_blocked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK,
                          return_lse: bool = False, q_offset: int = 0):
    """The reference's ``_flash_fwd`` (``src/repro/models/flash.py:154-216``)
    without its sharding: an online softmax over ``kv_chunk`` key blocks in
    a scan over ``q_chunk`` query chunks, with the causal block skip as a
    cond, written with :func:`~repro_torch.core.tracer.scan_loop` so the
    walker charges what the reference's walker charges for it.  The same
    function as :func:`attention_ref` (the blocks are summed in f32 and
    each block's P is rounded to v's dtype before P·V)."""
    from repro_torch.core.tracer import scan_loop
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    cq = min(q_chunk, max(s, 1))
    ck = min(kv_chunk, t)
    r = h // g
    scale = 1.0 / float(math.sqrt(d))
    qp, s_pad = _pad_seq(q, cq)
    kp, t_pad = _pad_seq(k, ck)
    vp, _ = _pad_seq(v, ck)
    nq = s_pad // cq
    limit = t if (causal or t_pad != t) else None
    qr = qp.reshape(b, nq, cq, h, d).permute(1, 0, 3, 2, 4)
    use_strip, strip = _strip(causal, window, cq, ck, t_pad)
    dev = q.device

    def block(qc, qpos, carry, xs):
        kcj, vcj, kpj = xs
        m, l, acc = carry
        if r > 1:
            kcj = torch.repeat_interleave(kcj, r, dim=2)
            vcj = torch.repeat_interleave(vcj, r, dim=2)
        sc = torch.einsum("bhqd,bkhd->bhqk", qc, kcj).float() * scale
        mask = _block_mask(qpos, kpj, causal, window, limit)
        if mask is not None:
            sc = torch.where(mask.reshape((1, 1) + mask.shape), sc,
                             BLOCK_NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vcj.dtype), vcj).float()
        return m_new, l, acc

    def per_q(c, xs):
        qi, qc = xs
        qpos = _at(qi * cq, q_offset) + torch.arange(cq, dtype=torch.int32,
                                                     device=dev)
        ks, vs, kpos_all, _ = _kv_strip(kp, vp, qi, cq, strip, t_pad,
                                        use_strip, q_offset)
        kc, vc = _chunk_kv(ks, ck), _chunk_kv(vs, ck)
        kpos = kpos_all.reshape(strip // ck, ck)

        def body(carry, xs2):
            live = lambda cr: block(qc, qpos, cr, xs2)  # noqa: E731
            if causal:
                return _cond(_needed(xs2[2], qpos, window), live,
                             lambda cr: cr, carry)
            return live(carry)

        m0 = torch.full((b, h, cq), BLOCK_NEG_INF, dtype=torch.float32,
                        device=dev)
        l0 = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        a0 = torch.zeros((b, h, cq, d), dtype=torch.float32, device=dev)
        m, l, acc = scan_loop(strip // ck, body, (m0, l0, a0),
                              xs=(kc, vc, kpos))
        o = acc / torch.clamp_min(l[..., None], 1e-30)
        lse = m + torch.log(torch.clamp_min(l, 1e-30))
        return c, (o, lse)

    _, (out_c, lse_c) = scan_loop(
        nq, per_q, 0, xs=(torch.arange(nq, dtype=torch.int32, device=dev),
                          qr), stack_ys=True)
    out = out_c.permute(1, 0, 3, 2, 4).reshape(b, s_pad, h, d)
    lse = lse_c.permute(1, 0, 3, 2).reshape(b, s_pad, h)
    if s_pad != s:
        out, lse = out[:, :s], lse[:, :s]
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def attention_blocked_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True, window: int | None = None,
                              q_chunk: int = Q_CHUNK,
                              kv_chunk: int = KV_CHUNK, q_offset: int = 0):
    """The reference's ``_flash_bwd`` (``src/repro/models/flash.py:219-
    326``) without its sharding: per q chunk, a scan over the key blocks
    that recomputes P from the LSE and accumulates dq, with dk and dv summed
    in f32 across q chunks (the FlashAttention-2 scheme), written with
    :func:`~repro_torch.core.tracer.scan_loop` so the walker charges what
    the reference's walker charges for it.  The same function as
    :func:`attention_bwd_ref` with P and dS kept in f32."""
    from repro_torch.core.tracer import (
        dynamic_slice, dynamic_update_slice, einsum, scan_loop,
    )
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    cq = min(q_chunk, max(s, 1))
    ck = min(kv_chunk, t)
    r = h // g
    scale = 1.0 / float(math.sqrt(d))
    qp, s_pad = _pad_seq(q, cq)
    kp, t_pad = _pad_seq(k, ck)
    vp, _ = _pad_seq(v, ck)
    dop, _ = _pad_seq(dout.float(), cq)
    outp, _ = _pad_seq(out.float(), cq)
    lsep, _ = _pad_seq(lse, cq)
    nq = s_pad // cq
    limit = t if (causal or t_pad != t) else None
    dvec = torch.sum(dop * outp, dim=-1)                     # (b,s_pad,h)
    qr = qp.reshape(b, nq, cq, h, d).permute(1, 0, 3, 2, 4)
    dor = dop.reshape(b, nq, cq, h, d).permute(1, 0, 3, 2, 4)
    lser = lsep.reshape(b, nq, cq, h).permute(1, 0, 3, 2)   # (nq,b,h,cq)
    dvr = dvec.reshape(b, nq, cq, h).permute(1, 0, 3, 2)
    use_strip, strip = _strip(causal, window, cq, ck, t_pad)
    dev = q.device

    def per_q(carry, xs):
        dk_acc, dv_acc = carry
        qi, qc, doc, lsec, dvc = xs
        qpos = _at(qi * cq, q_offset) + torch.arange(cq, dtype=torch.int32,
                                                     device=dev)
        ks, vs, kpos_all, start = _kv_strip(kp, vp, qi, cq, strip, t_pad,
                                            use_strip, q_offset)
        kc, vc = _chunk_kv(ks, ck), _chunk_kv(vs, ck)
        kposc = kpos_all.reshape(strip // ck, ck)

        def inner(dq_c, xs2):
            kcj, vcj, kpj = xs2

            def live(dq_c):
                kj, vj = kcj, vcj
                if r > 1:
                    kj = torch.repeat_interleave(kj, r, dim=2)
                    vj = torch.repeat_interleave(vj, r, dim=2)
                sblk = torch.einsum("bhqd,bkhd->bhqk", qc,
                                    kj).float() * scale
                mask = _block_mask(qpos, kpj, causal, window, limit)
                if mask is not None:
                    sblk = torch.where(mask.reshape((1, 1) + mask.shape),
                                       sblk, BLOCK_NEG_INF)
                p = torch.exp(sblk - lsec[..., None])          # (b,h,cq,ck)
                dv_blk = einsum("bhqk,bhqd->bkhd", p, doc)
                dp = einsum("bhqd,bkhd->bhqk", doc, vj)
                ds = p * (dp - dvc[..., None]) * scale
                dq_c = dq_c + einsum("bhqk,bkhd->bhqd", ds, kj)
                dk_blk = einsum("bhqk,bhqd->bkhd", ds, qc)
                if r > 1:                                      # fold to g
                    dk_blk = dk_blk.reshape(b, ck, g, r, d).sum(dim=3)
                    dv_blk = dv_blk.reshape(b, ck, g, r, d).sum(dim=3)
                return dq_c, (dk_blk, dv_blk)

            def skip(dq_c):
                z = torch.zeros((b, ck, g, d), dtype=torch.float32,
                                device=dev)
                return dq_c, (z, z)

            if causal:
                return _cond(_needed(kpj, qpos, window), live, skip, dq_c)
            return live(dq_c)

        dq0 = torch.zeros((b, h, cq, d), dtype=torch.float32, device=dev)
        dq_c, (dk_blks, dv_blks) = scan_loop(
            strip // ck, inner, dq0, xs=(kc, vc, kposc), stack_ys=True)
        dk_strip = dk_blks.transpose(0, 1).reshape(b, strip, g, d)
        dv_strip = dv_blks.transpose(0, 1).reshape(b, strip, g, d)
        if use_strip:
            cur_k = dynamic_slice(dk_acc, 1, start, strip)
            cur_v = dynamic_slice(dv_acc, 1, start, strip)
            dk_acc = dynamic_update_slice(dk_acc, cur_k + dk_strip, 1, start)
            dv_acc = dynamic_update_slice(dv_acc, cur_v + dv_strip, 1, start)
        else:
            dk_acc = dk_acc + dk_strip
            dv_acc = dv_acc + dv_strip
        return (dk_acc, dv_acc), dq_c

    dk0 = torch.zeros((b, t_pad, g, d), dtype=torch.float32, device=dev)
    dv0 = torch.zeros((b, t_pad, g, d), dtype=torch.float32, device=dev)
    (dk_acc, dv_acc), dq_c = scan_loop(
        nq, per_q, (dk0, dv0),
        xs=(torch.arange(nq, dtype=torch.int32, device=dev), qr, dor, lser,
            dvr), stack_ys=True)
    dq = dq_c.permute(1, 0, 3, 2, 4).reshape(b, s_pad, h, d)
    if s_pad != s:
        dq = dq[:, :s]
    dq = dq.to(q.dtype)
    if t_pad != t:
        dk_acc, dv_acc = dk_acc[:, :t], dv_acc[:, :t]
    return dq, dk_acc.to(k.dtype), dv_acc.to(v.dtype)
