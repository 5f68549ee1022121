"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16, MHA) d_ff=1408
vocab=102400, 2 shared + 64 routed experts top-6 (fine-grained).
[arXiv:2401.06066]"""
# copy of src/repro/configs/deepseek_moe_16b.py (the port imports nothing of repro)
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    rope_theta=10_000.0,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    rules_overrides=(("embed", "data"),),
)
