"""How far a CUDA kernel's output may lie from its plain version's.

Each element of ``got`` is held to its own limit,

    |got - want| <= ulps * ulp(want) + floor * rms(want's row),

where ``ulp`` is the spacing of the output dtype at |want| and a row is the
last dim (a head's d values for flash attention, a head's p values for the
SSD block).  The ulp term covers the rounding of the output itself; the
floor covers sums taken in another order and, for bf16 flash attention,
P rounded to bf16 at the running maximum of its tile rather than at the
row's final maximum.  Tying the floor to the row and not to max|want| keeps
the limit tight on rows whose outputs are small: a causal attention row i
averages i values, so its outputs shrink like 1/sqrt(i), and a limit taken
from row 0 would pass a kernel that drops a whole tile of keys for late rows.

``KERNEL_TOL`` gives (ulps, floor) per kernel and output dtype; the reasons
are beside each entry.  ``tests/test_torch_kernels_zoo.py`` shows that a
kernel which drops one key tile, or which does not rescale its accumulator
when the running maximum grows, exceeds these limits by orders of magnitude
at the Llama 3.2 3B prefill shape.
"""
from __future__ import annotations

import torch

#: bits after the binary point of each output dtype's significand
_MANTISSA = {torch.float32: 23, torch.bfloat16: 7}

KERNEL_TOL = {
    # f32: the same f32 terms summed in another order, and expf against
    # torch.exp; measured (an emulation of the kernel's tile order on the
    # CPU) at most 4.7e-6 of a row's RMS at b 1, s 2048, h 8, d 128
    ("flash_fwd", torch.float32): (4, 2.0 ** -14),
    # bf16: the output rounded once (up to one ulp apart where the two f32
    # values straddle a rounding boundary), and P rounded to bf16 at the
    # tile's running maximum in the kernel and at the row's final maximum
    # in the plain version: each term differs by up to 2^-8 of itself,
    # independently, so the sum moves by about 2^-9 of the row's RMS;
    # measured at most 0.0099 of the row's RMS (same emulation)
    ("flash_fwd", torch.bfloat16): (2, 2.0 ** -5),
    # f32 out: the same f32 terms, summed in the same or another order
    ("ssd_diag", torch.float32): (4, 2.0 ** -14),
    # bf16 out: the same f32 sums, rounded once
    ("ssd_diag", torch.bfloat16): (1, 2.0 ** -14),
}


def limit(want: torch.Tensor, ulps: float, floor: float) -> torch.Tensor:
    """The per-element limit of the module docstring, in f32."""
    w = want.float()
    tiny = torch.finfo(torch.float32).tiny
    binade = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(tiny))))
    ulp = binade * 2.0 ** -_MANTISSA[want.dtype]
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    return (ulps * ulp + floor * rms).clamp_min(tiny)


def excess(got: torch.Tensor, want: torch.Tensor, ulps: float,
           floor: float) -> float:
    """max over elements of |got - want| / limit: at most 1 passes."""
    err = (got.float() - want.float()).abs()
    return float((err / limit(want, ulps, floor)).max())


def kernel_excess(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """:func:`excess` with ``KERNEL_TOL[(name, got.dtype)]``."""
    return excess(got, want, *KERNEL_TOL[(name, got.dtype)])
