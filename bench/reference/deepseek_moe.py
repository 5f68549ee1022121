"""Plain f32 reference of the port's DeepSeek-MoE configuration (family
``moe``).

One layer: x + attention(rmsnorm(x)), then + moe(rmsnorm(x)).  Attention is
causal multi-head attention with rotary embeddings on q and k (halves
rotated) and no biases.  The MoE block is the configuration's (Dai et al.,
arXiv:2401.06066, with the port's routing): a softmax router over the
routed experts, the top k by probability (the lower index first among
equals), gates renormalised to sum to 1; every token of the batch routes in
one group with ``round(tokens * k / experts * capacity_factor)`` slots an
expert, its picks taken in token order and those past the capacity
dropped, and an expert with more picks than slots serves one fewer (its
last slot ends empty, the configuration's semantics); each kept pick adds
its gate times the expert's SwiGLU of the token; the shared experts, one
SwiGLU of their summed width, add for every token; the balance loss is
experts * sum(mean probability * share of first picks).  The layout of the
weights is the port's parameter tree.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import Numerics, causal_attention, rms_norm, rope
from bench.weights import Spec


def param_specs(sz: dict) -> dict:
    """The inputs' tree, each leaf with the published model's initialisation
    (transformers' DeepSeek ``_init_weights``, initializer_range 0.02):
    every linear weight and the embedding N(0, 0.02); the router at
    PyTorch's kaiming-uniform standard deviation 1/sqrt(3 d), drawn normal;
    the norms' factors 1."""
    d, n, dt = sz["d_model"], sz["n_layers"], sz["dtype"]
    hq = sz["n_heads"] * sz["head_dim"]
    hk = sz["n_kv_heads"] * sz["head_dim"]
    e, f = sz["n_experts"], sz["d_ff_expert"]
    fs = f * sz["n_shared_experts"]

    def w(*shape):
        return Spec((n,) + shape, "normal", 0.02, dtype=dt)

    unit = {
        "ln1": Spec((n, d), "zeros", dtype="float32"),
        "attn": {"wq": w(d, hq), "wk": w(d, hk), "wv": w(d, hk),
                 "wo": w(hq, d)},
        "ln2": Spec((n, d), "zeros", dtype="float32"),
        "moe": {"router": Spec((n, d, e), "normal",
                               1.0 / math.sqrt(3 * d), dtype="float32"),
                "wi": w(e, d, f), "wg": w(e, d, f), "wo": w(e, f, d),
                "shared": {"wi": w(d, fs), "wg": w(d, fs), "wo": w(fs, d)}},
    }
    return {"embed": Spec((sz["padded_vocab"], d), "normal", 0.02, dtype=dt),
            "final_norm": Spec((d,), "zeros", dtype="float32"),
            "unit": (unit,), "rest": ()}


def attention(sz: dict, w: dict, x, num: Numerics):
    b, s, _ = x.shape
    hd = sz["head_dim"]
    pos = torch.arange(s, device=x.device)
    q = num.mm(x, w["wq"]).reshape(b, s, sz["n_heads"], hd)
    k = num.mm(x, w["wk"]).reshape(b, s, sz["n_kv_heads"], hd)
    v = num.mm(x, w["wv"]).reshape(b, s, sz["n_kv_heads"], hd)
    theta = sz["rope_theta"]
    out = causal_attention(rope(q, pos, theta), rope(k, pos, theta), v, num)
    return num.mm(out.reshape(b, s, -1), w["wo"])


def swiglu(x, wi, wg, wo, num: Numerics):
    return num.mm(F.silu(num.mm(x, wg)) * num.mm(x, wi), wo)


def moe(sz: dict, w: dict, x, num: Numerics):
    """(y (b, s, d), balance loss) of one MoE block over the batch's tokens."""
    b, s, d = x.shape
    e, k = sz["n_experts"], sz["top_k"]
    xf = x.reshape(b * s, d)
    t = xf.shape[0]
    probs = torch.softmax(num.mm(xf, w["router"]), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    gates = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    first = F.one_hot(idx[:, 0], e).float()
    aux = e * (probs.mean(0) * first.mean(0)).sum()

    cap = int(max(1, round(t * k / e * sz["capacity_factor"])))
    pick_e = idx.reshape(-1)                                 # token-major
    onehot = F.one_hot(pick_e, e)
    pos = (torch.cumsum(onehot, 0) - 1).gather(1, pick_e[:, None])[:, 0]
    count = onehot.sum(0)
    served = (pos < cap) & ~((count[pick_e] > cap) & (pos == cap - 1))
    # slot table: each served pick's token in its expert's slot, an empty
    # slot pointing at a zero row past the end
    slot = pick_e * cap + pos.clamp(max=cap - 1)
    table = torch.full((e * cap,), t, dtype=torch.long, device=x.device)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    table[slot[served]] = tok[served]
    xe = torch.cat([xf, xf.new_zeros(1, d)])[table].reshape(e, cap, d)
    he = F.silu(num.einsum("ecd,edf->ecf", xe, w["wg"])) \
        * num.einsum("ecd,edf->ecf", xe, w["wi"])
    ye = num.einsum("ecf,efd->ecd", he, w["wo"]).reshape(e * cap, d)
    picked = ye[slot] * (gates.reshape(-1) * served)[:, None]
    y = picked.reshape(t, k, d).sum(1)
    sh = w["shared"]
    y = y + swiglu(xf, sh["wi"], sh["wg"], sh["wo"], num)
    return y.reshape(b, s, d), aux


def layer(sz: dict, w: dict, x, num: Numerics):
    """One layer (b, s, d) -> ((b, s, d), balance loss)."""
    x = x + attention(sz, w["attn"], rms_norm(x, w["ln1"]), num)
    y, aux = moe(sz, w["moe"], rms_norm(x, w["ln2"]), num)
    return x + y, aux
