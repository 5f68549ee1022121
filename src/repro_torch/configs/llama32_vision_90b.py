"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision family]

The vision frontend is a stub: ``input_specs`` provides precomputed patch
embeddings (b, 1601, d_model); cross-attn K/V are cached at prefill."""
# copy of src/repro/configs/llama32_vision_90b.py (the port imports nothing of repro)
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    rope_theta=500_000.0,
    layer_pattern=("s", "s", "s", "s", "x"),
    n_vision_tokens=1601,
    rules_overrides=(("embed", "data"),),
)
