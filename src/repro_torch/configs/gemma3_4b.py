"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global interleave, 128k context.  [hf:google/gemma-3-1b-pt]

long_500k RUNS: 5/6 of layers are 1024-token sliding window (ring caches);
the global layers decode against the full 500k cache (seq-sharded)."""
# copy of src/repro/configs/gemma3_4b.py (the port imports nothing of repro)
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1_000_000.0,
    window=1024,
    layer_pattern=("l", "l", "l", "l", "l", "g"),
    supports_long_decode=True,
)
