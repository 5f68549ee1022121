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
and Gu, arXiv:2405.21060, section 6) at the configuration's chunk.  A
training step is three forwards (the backward twice the forward); remat's
recompute, the capacity drop and padding are not counted.
"""
from __future__ import annotations

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


def weights_per_token(sz: dict) -> float:
    """Weights each token multiplies in a forward (the active ones)."""
    d, layers = sz["d_model"], sz["n_layers"]
    n = sz["padded_vocab"] * d                       # the tied LM head
    if sz["family"] == "ssm":
        d_in = sz["ssm_expand"] * d
        h = d_in // sz["ssm_head_dim"]
        gn = sz["ssm_groups"] * sz["ssm_state"]
        conv_dim = d_in + 2 * gn
        per = d * (2 * d_in + 2 * gn + h) + d_in * d + sz["conv_width"] \
            * conv_dim
        return n + layers * per
    hd, heads, kv = sz["head_dim"], sz["n_heads"], sz["n_kv_heads"]
    attn = d * hd * (2 * heads + 2 * kv)
    f = sz["d_ff_expert"]
    moe = d * sz["n_experts"] + 3 * d * f * (sz["top_k"]
                                            + sz["n_shared_experts"])
    return n + layers * (attn + moe)


def forward_flops(sz: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one forward over ``batch`` sequences of ``seq``."""
    tokens = batch * seq
    flops = 2.0 * weights_per_token(sz) * tokens
    if sz["family"] == "ssm":
        flops += sz["n_layers"] * tokens * _ssd_flops_per_token(sz)
    else:
        flops += sz["n_layers"] * batch * 4.0 * sz["n_heads"] \
            * sz["head_dim"] * causal_pairs(seq)
    return flops


def train_step_flops(sz: dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(sz, batch, seq)
