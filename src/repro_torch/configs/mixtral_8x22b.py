"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]

8 experts cannot shard a 16-way model axis, so TP goes *inside* the expert
(expert_ffn → model); long_500k RUNS via the 4096-token SWA ring cache."""
# copy of src/repro/configs/mixtral_8x22b.py (the port imports nothing of repro)
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    window=4096,
    layer_pattern=("l",),
    n_experts=8,
    top_k=2,
    d_ff_expert=16384,
    rules_overrides=(("experts", None), ("expert_ffn", "model"),
                     ("embed", "data")),
    supports_long_decode=True,
)
