"""The yardstick: the card's published peaks, interval arithmetic over a
trace, and the model FLOPs of a step, counted from the configuration's sizes.

Peaks are one NVIDIA H100 SXM's, from its data sheet (dense rates, no
sparsity, at the 700 W limit): 989 TFLOP/s in bf16 and fp16, 495 in TF32, 67
in f32 outside the tensor cores, 3.35 TB/s of HBM3.  A roofline share is
the least time the work could take on them, the larger of operations over
the peak of the inputs' dtype and bytes over the bandwidth, divided by the
measured time.

Model FLOPs count what the model needs, not what the port launches: two
FLOPs a multiply-add of every weight a token uses (an MoE layer's top-k and
shared experts and its router; the tied LM head once; the embedding lookup
none), causal attention's two products over the s(s+1)/2 pairs of each
sequence, and the SSD's chunked products by the published algorithm (Dao
and Gu, arXiv:2405.21060, section 6) at the configuration's chunk.  They
are counted layer by layer over the configuration's layer list
(:func:`layer_kind`, :func:`is_moe_layer`), by the rules of
:func:`layer_weights` and :func:`layer_flops`; a family module whose layers
count otherwise (another expert or mixer) gives functions of those names
and signatures, which then count each of its layers.  A training step is
three forwards (the backward twice the forward); remat's recompute, the
capacity drop and padding are not counted.
"""
from __future__ import annotations

from bench import core

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
#: the peak an MFU is a share of: the bf16 dense tensor-core rate
MFU_PEAK = PEAK_FLOPS["bfloat16"]

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4,
               "int64": 8}


def dtype_name(dt) -> str:
    """``torch.bfloat16`` or ``"bfloat16"`` as ``"bfloat16"``."""
    return str(dt).replace("torch.", "")


def bound_s(flops: float, nbytes: float, dtype) -> float:
    """The least time a call could take: its operations at the peak of its
    input dtype or its bytes at the HBM bandwidth, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype_name(dtype)], nbytes / HBM_BYTES_PER_S)


def union_length(intervals) -> float:
    """The length covered by ``(start, end)`` intervals (overlaps once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def _ssd_flops_per_token(sz: dict) -> float:
    """The SSD mixer's chunked products, per token, forward: within a chunk
    the C·Bᵀ scores and their product with dt·x (causal pairs), then the
    chunk state (B ⊗ x) and the off-diagonal read C·H."""
    d_in = sz["ssm_expand"] * sz["d_model"]
    h = d_in // sz["ssm_head_dim"]
    p, n, g, q = sz["ssm_head_dim"], sz["ssm_state"], sz["ssm_groups"], \
        sz["ssm_chunk"]
    pairs_per_token = causal_pairs(q) / q
    diag = 2 * pairs_per_token * (g * n + h * p)
    states = 2 * h * p * n
    off = 2 * h * p * n
    return diag + states + off


def layer_kind(sz: dict, i: int) -> str:
    """Layer ``i``'s kind: ``layer_pattern`` repeated over the layers, as
    the port's ``layer_kinds`` (a sizes dict with no pattern: ``m`` for the
    ``ssm`` family, ``g`` for any other)."""
    pat = sz.get("layer_pattern") or ["m" if sz["family"] == "ssm" else "g"]
    return pat[i % len(pat)]


def is_moe_layer(sz: dict, i: int) -> bool:
    """Whether layer ``i``'s FFN is the experts, as the port's
    ``is_moe_layer``."""
    return bool(sz.get("n_experts")) and \
        i % sz.get("moe_every", 1) == sz.get("moe_offset", 0)


def layer_weights(sz: dict, i: int) -> int:
    """Weights a token multiplies in layer ``i`` (the active ones): the
    mixer's (kind ``m``: the SSM's in and out projections and its conv;
    any other kind: attention's q, k, v and o), then the FFN's (an MoE
    layer: the router and the top-k and shared experts' SwiGLU; else a dense
    SwiGLU of ``d_ff`` where the sizes have one)."""
    d = sz["d_model"]
    if layer_kind(sz, i) == "m":
        d_in = sz["ssm_expand"] * d
        h = d_in // sz["ssm_head_dim"]
        gn = sz["ssm_groups"] * sz["ssm_state"]
        conv_dim = d_in + 2 * gn
        n = d * (2 * d_in + 2 * gn + h) + d_in * d + sz["conv_width"] \
            * conv_dim
    else:
        hd, heads, kv = sz["head_dim"], sz["n_heads"], sz["n_kv_heads"]
        n = d * hd * (2 * heads + 2 * kv)
    if is_moe_layer(sz, i):
        n += d * sz["n_experts"] + 3 * d * sz["d_ff_expert"] * (
            sz["top_k"] + sz["n_shared_experts"])
    elif sz.get("d_ff"):
        n += 3 * d * sz["d_ff"]
    return n


def layer_flops(sz: dict, i: int, batch: int, seq: int) -> float:
    """Layer ``i``'s FLOPs beyond its weights' products, forward, over
    ``batch`` sequences of ``seq``: the SSD's chunked products (kind ``m``)
    or causal attention's two products over each sequence's pairs."""
    if layer_kind(sz, i) == "m":
        return batch * seq * _ssd_flops_per_token(sz)
    return batch * 4.0 * sz["n_heads"] * sz["head_dim"] * causal_pairs(seq)


def _counts(sz: dict):
    """(layer_weights, layer_flops) of the sizes' family: the family
    module's own (``reference/<family>.py``), where it gives them, for its
    layers, else this module's."""
    fam = core.family(sz) if "reference" in sz else None
    return (getattr(fam, "layer_weights", layer_weights),
            getattr(fam, "layer_flops", layer_flops))


def weights_per_token(sz: dict) -> int:
    """Weights each token multiplies in a forward (the active ones): the
    tied LM head and every layer's."""
    per = _counts(sz)[0]
    return sz["padded_vocab"] * sz["d_model"] + sum(
        per(sz, i) for i in range(sz["n_layers"]))


def forward_flops(sz: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one forward over ``batch`` sequences of ``seq``,
    counted layer by layer."""
    per = _counts(sz)[1]
    tokens = batch * seq
    flops = 2.0 * weights_per_token(sz) * tokens
    for i in range(sz["n_layers"]):
        flops += per(sz, i, batch, seq)
    return flops


def train_step_flops(sz: dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(sz, batch, seq)
