"""Operations and bytes of the kernels' calls, counted from the shapes a
traced call was given, for the work the call must do: each input byte read
once, each output byte written once, products over the causal pairs only.
Any implementation of a call is read against the same count."""
from __future__ import annotations

from bench.yardstick import DTYPE_BYTES, bound_s, causal_pairs


def _t(arg) -> tuple[list, str]:
    return arg["shape"], arg["dtype"]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _bytes(arg) -> int:
    shape, dt = _t(arg)
    return _numel(shape) * DTYPE_BYTES[dt]


def ssd_diag(call: dict, backward: bool = False) -> float:
    """The bound (s) of ``ssd_diag(x, dt, cum, B, C, r, out_dtype)``: within
    each chunk the C·Bᵀ scores and their product with dt·x over the causal
    pairs.  Its gradient (``backward``) is the published algorithm's: the
    scores' and the product's transposes, twice the forward's products,
    reading the incoming gradient and the forward's inputs and writing the
    five inputs' gradients."""
    x, dt, cum, bm, cm = call["args"][:5]
    b, c, q, h, p = x["shape"]
    g, n = bm["shape"][3], bm["shape"][4]
    out_dt = call["args"][6] if len(call["args"]) > 6 else \
        call["kwargs"].get("out_dtype")
    out_dt = out_dt or x["dtype"]
    pairs = causal_pairs(q)
    flops = 2.0 * b * c * pairs * (g * n + h * p)
    ins = sum(_bytes(a) for a in (x, dt, cum, bm, cm))
    out = _numel(x["shape"]) * DTYPE_BYTES[out_dt]
    if backward:
        return bound_s(2 * flops, ins + out + ins, x["dtype"])
    return bound_s(flops, ins + out, x["dtype"])


def flash(call: dict, backward: bool = False) -> float:
    """The bound (s) of ``flash_attention(q, k, v, causal=...)``: the score
    and value products (4 b h d a pair) over the pairs the mask keeps.  Its
    backward is FlashAttention-2's five products (10 b h d a pair: the
    scores again, dV, dP, dQ, dK), reading q, k, v, the output, its
    gradient and the rows' log-sum-exp and writing dq, dk, dv."""
    q, k, v = call["args"][:3]
    b, s, h, d = q["shape"]
    t = k["shape"][1]
    causal = call["kwargs"].get("causal", True)
    pairs = causal_pairs(s) if causal and s == t else s * t
    qb, kb, vb = _bytes(q), _bytes(k), _bytes(v)
    if backward:
        lse = b * h * s * 4
        return bound_s(10.0 * b * h * d * pairs,
                       2 * (qb + kb + vb) + 2 * qb + lse, q["dtype"])
    return bound_s(4.0 * b * h * d * pairs, qb + kb + vb + qb, q["dtype"])


def roofline(r, attr: str, count, backward: bool = False):
    """A call's share (%) of its roofline over the traced window: the sum
    of its calls' bounds over the sum of their device times (between the
    CUDA events the traced run takes around each call, or around its
    backward node for ``backward``), or None where it has no such call."""
    if r.hooks is None:
        return None
    calls = r.hooks.calls.get(attr, [])
    ms = r.hooks.event_ms(attr, backward)
    if not calls or not ms or sum(ms) <= 0:
        return None
    if not backward and len(ms) != len(calls):
        return None
    # a backward node runs once for each call that had one: every call of a
    # cell has the same shapes, so the first call's count stands for each
    bounds = [count(c) for c in calls] if not backward else \
        [count(calls[0], True)] * len(ms)
    return 100.0 * sum(bounds) / (sum(ms) / 1e3)
