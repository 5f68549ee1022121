"""whisper-large-v3 [audio]: enc-dec, 32+32L d_model=1280 20H d_ff=5120
vocab=51866.  [arXiv:2212.04356]

The conv/mel frontend is a stub: ``input_specs`` provides precomputed frame
embeddings (b, 1500, d_model).  Decode shapes exercise the decoder backbone
at the assigned KV lengths (performance cells — the real model caps at 448
positions; noted in DESIGN.md)."""
# copy of src/repro/configs/whisper_large_v3.py (the port imports nothing of repro)
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,           # decoder
    enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    rope_theta=10_000.0,
    n_audio_frames=1500,
)
