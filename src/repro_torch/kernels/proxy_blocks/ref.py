"""Plain PyTorch versions of the proxy-block kernels.

The same arithmetic as the CUDA kernels in ``kernel.cu`` and as the
reference's ``repro/kernels/proxy_blocks/ref.py``, written as a loop of
``reps`` turns.  Used for CPU tensors, and by ``chip_smoke.py`` to hold
the kernels to on the card.
"""
from __future__ import annotations

import numpy as np
import torch

MM = 128
#: the TPU kernel's contraction normalisation (``kernel.py:_mxu_iter_kernel``)
MXU_SCALE = 1.0 / MM
#: the stream update's constants as f32 values (the reference's jnp literals
#: are weakly typed and round to f32 against an f32 ``v``)
STREAM_MUL = float(np.float32(0.999999))
STREAM_ADD = float(np.float32(1e-6))


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
    """``v <- v * 0.999999 + 1e-6``, ``reps`` times, each turn rounded to
    f32 once, as a fused multiply-add rounds it.

    The reference's XLA program contracts the update into an FMA.  The
    product of two f32 values is exact in f64 (48 significant bits), and for
    2^-25 <= |v| < 2 the sum with the f32 constant 1e-6 spans at most 53
    bits, so it is exact in f64 too: the one rounding to f32 is the FMA's,
    and this is the reference bit for bit (the CPU tests pin it)."""
    dt = v.dtype
    w = v.double()
    for _ in range(int(reps)):
        w = (w * STREAM_MUL + STREAM_ADD).to(dt).double()
    return w.to(dt)
