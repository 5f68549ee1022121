"""Plain PyTorch versions of the proxy-block kernels.

The same arithmetic as the CUDA kernels in ``kernel.cu`` and as the
reference's ``repro/kernels/proxy_blocks/ref.py``, written as a loop of
``reps`` turns.  Used for CPU tensors, and by ``chip_smoke.py`` to hold
the kernels to on the card.
"""
from __future__ import annotations

import torch

MM = 128
#: the TPU kernel's contraction normalisation (``kernel.py:_mxu_iter_kernel``)
MXU_SCALE = 1.0 / MM
STREAM_MUL = 0.999999
STREAM_ADD = 1e-6


def mxu_ref(a: torch.Tensor, b: torch.Tensor, reps: int,
            scale: float = MXU_SCALE) -> torch.Tensor:
    """``a <- bf16((a @ b) in f32 * scale)``, ``reps`` times.

    ``a``: (..., 128, 128) bf16; ``b``: (128, 128) or batched like ``a``.
    Products of two bf16 values are exact in f32, so the f32 matmul is the
    kernel's f32 accumulation up to summation order."""
    bf = b.float()
    for _ in range(int(reps)):
        a = ((a.float() @ bf) * scale).to(a.dtype)
    return a


def stream_ref(v: torch.Tensor, reps: int) -> torch.Tensor:
    """``v <- v * 0.999999 + 1e-6``, ``reps`` times; a multiply then an add,
    each rounded to f32 (no fused multiply-add)."""
    for _ in range(int(reps)):
        v = v * STREAM_MUL + STREAM_ADD
    return v
