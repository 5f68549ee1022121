"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attention 7:1 interleave, MoE 16 experts top-2 on
alternate layers.  [arXiv:2403.19887]

long_500k RUNS: 7/8 of layers are O(1)-state SSM; the 4 attention layers'
KV caches are seq-sharded over the model axis.  (Jamba uses Mamba-1 state
16; we keep the SSD mixer with that state size — DESIGN.md §Arch notes.)"""
# copy of src/repro/configs/jamba_v01_52b.py (the port imports nothing of repro)
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    rope_theta=10_000.0,
    layer_pattern=("m", "m", "m", "g", "m", "m", "m", "m"),
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    ssm_chunk=256,
    supports_long_decode=True,
    rules_overrides=(("embed", "data"),),
)
