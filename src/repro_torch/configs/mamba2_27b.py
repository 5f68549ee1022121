"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280.  [arXiv:2405.21060]

long_500k RUNS: decode is O(1) in context (fixed-size SSM state)."""
# copy of src/repro/configs/mamba2_27b.py (the port imports nothing of repro)
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,            # attention-free; placeholders
    n_kv_heads=1,
    d_ff=0,               # the SSD mixer is the whole block
    vocab=50280,
    layer_pattern=("m",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    ssm_chunk=256,
    supports_long_decode=True,
)
