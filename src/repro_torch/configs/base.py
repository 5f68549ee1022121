"""Architecture + run-shape configuration system.

A copy of ``src/repro/configs/base.py`` (the port imports nothing of
``repro``).  Every assigned architecture is a frozen :class:`ArchConfig`;
run shapes (``train_4k`` …) are :class:`RunShape`s; ``smoke()`` returns a
reduced same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

#: layer kind codes used in ``layer_pattern`` (the repeating unit):
#:   'g' global attention   'l' local (sliding-window) attention
#:   'm' mamba2 mixer       'x' cross-attention (+self for VLM: 's')
#:   's' self attention (VLM unit member, same as 'g')
LAYER_KINDS = ("g", "l", "m", "x", "s")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int = 0                   # sliding window for 'l' layers
    layer_pattern: tuple[str, ...] = ("g",)
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1                # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- SSM ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # --- frontends (stubs provide precomputed embeddings) ---
    n_vision_tokens: int = 0          # VLM patch embeddings
    n_audio_frames: int = 0           # audio frame embeddings (enc input)
    enc_layers: int = 0               # encoder layers (enc-dec only)
    # --- numerics / impl ---
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 512             # LM-head seq chunking (0 = off)
    # the reference's kernel switch (xla | pallas), kept so configs compare
    # equal; the port ignores it: a CUDA tensor runs the CUDA kernels and a
    # CPU tensor their plain versions, whatever this says
    attn_impl: str = "xla"
    rules_overrides: tuple[tuple[str, object], ...] = ()
    # long-context applicability (sub-quadratic decode path exists)
    supports_long_decode: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the LM head/embedding shard
        cleanly on any reasonable TP degree (standard framework practice)."""
        return ((self.vocab + 255) // 256) * 256

    def layer_kinds(self) -> list[str]:
        """Expanded per-layer kind list of length n_layers."""
        pat = self.layer_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_experts > 0 and i % self.moe_every == self.moe_offset)

    def approx_params(self) -> float:
        """Total parameter count (for 6ND model-flops accounting)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d  # embeddings (tied head assumed in count)
        kinds = self.layer_kinds()
        hd = self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        for i, k in enumerate(kinds):
            if k == "m":
                d_in = self.ssm_expand * d
                h = d_in // self.ssm_head_dim
                gn = self.ssm_groups * self.ssm_state
                n += d * (2 * d_in + 2 * gn + h)       # in_proj
                n += d_in * d                           # out_proj
                n += 4 * (d_in + 2 * gn)                # conv
            else:
                n += attn
                if k == "x":
                    n += attn                           # cross-attn weights
            # feed-forward applies to every layer kind (incl. jamba mamba)
            if self.is_moe_layer(i):
                n += self.n_experts * 3 * d * self.d_ff_expert
                n += self.n_shared_experts * 3 * d * self.d_ff_expert
            elif self.d_ff:
                n += 3 * d * self.d_ff
        if self.enc_layers:
            n += self.enc_layers * (attn + 3 * d * self.d_ff)
        return float(n)

    def active_params(self) -> float:
        """Per-token active parameters (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.approx_params()
        d = self.d_model
        total = self.approx_params()
        kinds = self.layer_kinds()
        for i, _ in enumerate(kinds):
            if self.is_moe_layer(i):
                inactive = (self.n_experts - self.top_k) * 3 * d * self.d_ff_expert
                total -= inactive
        return float(total)


@dataclasses.dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, RunShape] = {
    "train_4k":    RunShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": RunShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  RunShape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   RunShape("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """All shapes minus long_500k for pure full-attention archs (per spec)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_decode:
        out.append("long_500k")
    return out


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: tiny widths, few layers, small tables."""
    unit = len(cfg.layer_pattern)
    n_layers = max(unit, 2)
    if cfg.family == "vlm":
        n_layers = unit
    d = 64
    heads = 4
    kv = min(cfg.n_kv_heads, 2) or 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        capacity_factor=8.0,   # no token dropping at smoke batch sizes
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        n_vision_tokens=8 if cfg.n_vision_tokens else 0,
        n_audio_frames=16 if cfg.n_audio_frames else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        dtype="float32",
        remat=False,
        loss_chunk=0,
    )
