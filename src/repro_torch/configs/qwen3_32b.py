"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B family]"""
# copy of src/repro/configs/qwen3_32b.py (the port imports nothing of repro)
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    # ZeRO-style: params/opt 2-D sharded (embed rows over data) — 32B dense
    # params + f32 moments do not fit at TP-16 alone
    rules_overrides=(("embed", "data"),),
)
