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

The backward's outputs need a third term.  A gradient row can cancel to
almost nothing while its terms do not: dq of causal row 0 is
P (dP - D) K with P = 1 and dP = D, so its exact value is 0 and both
versions give the rounding of dP - D, about 1e-5 of the tensor's RMS in
f32.  So for ``flash_bwd`` the limit adds ``tensor_floor * rms(want)``
over the whole tensor, small enough that the planted faults still fail it
by far (``tests/test_torch_kernels_zoo.py``).  The SSD block's f32 output
needs one too: a row scales by the scores C_t . B_s, and where that dot
product cancels (|C_t . B_s| far below sum |c b|) the row is small while
the product's rounding is set by its terms, in the plain version's f32
sum as in the kernel's 3xTF32.

``KERNEL_TOL`` gives (ulps, floor[, tensor_floor]) per kernel and output
dtype; the reasons are beside each entry.  ``tests/test_torch_kernels_zoo.py`` shows that a
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
    # f32 out: the same f32 terms, summed in the same or another order;
    # with f32 inputs the kernel's C B^T is 3xTF32, each product to about
    # 2^-22 of itself.  Where C_t . B_s cancels, that error is of sum |c b|
    # and the row of y it scales is small: at b 2, c 4, q 8, h 8, p 16,
    # n 16 a row of RMS 6.5e-4 (|C.B| 0.0096 of sum |c b| 13.8) put the
    # plain f32 version itself 1.06 times the row limit from the exact
    # value, the kernel 3.07 times (H100).  The tensor floor of 2^-20 of
    # the output's RMS holds them at 0.12 and 0.23; a single TF32 rounding
    # still misses the limit by more than 10 times
    ("ssd_diag", torch.float32): (4, 2.0 ** -14, 2.0 ** -20),
    # bf16 out: the same f32 sums, rounded once
    ("ssd_diag", torch.bfloat16): (1, 2.0 ** -14),
    # the SSD backward (``ssd/backward.cu``), each of its five gradients
    # against plain autograd through ``ssd_diag_ref``.  f32 (d(dt) and
    # d(cum) always, every gradient with f32 inputs): the same f32 terms
    # summed in another order, each f32 product in split TF32 to about
    # 2^-22 of its terms.  An emulation of the kernel's arithmetic and tile
    # order (tests/test_torch_kernels_zoo.py) stays within 0.04 of the limit
    # with bf16 inputs at q 256 and 80 heads, and within 0.09 with f32
    # inputs at the smoke shapes; the kernel on an H100 within 0.10 and
    # 0.15.  The tensor floor is the forward's, for a score C . B that
    # cancels where a dX row of the chunk's last keys has few terms.  One
    # TF32 rounding of each f32 operand misses the limit by 20 times or more
    ("ssd_diag_bwd", torch.float32): (4, 2.0 ** -14, 2.0 ** -20),
    # bf16 (dX, dB, dC of bf16 inputs): the same f32 sums rounded once; two
    # f32 values a rounding apart can round to neighbouring bf16 values, as
    # the plain version's own f32 sums against f64 already do (0.99 of a
    # one-ulp limit); the emulation and the kernel reach 0.50 of two ulps
    ("ssd_diag_bwd", torch.bfloat16): (2, 2.0 ** -14),
    # f32: sums over s (dk, dv) or t (dq) terms in another order; the plain
    # version's own error against f64 reaches 0.09 of the row floor and, on
    # the cancelling rows, 0.18 of the tensor floor (s 2048, d 128, causal)
    ("flash_bwd", torch.float32): (4, 2.0 ** -14, 2.0 ** -14),
    # bf16: P and dS rounded to bf16 in both versions, of f32 values that
    # differ by the order of S's sum and exp2 against exp, so some terms
    # round to the neighbouring bf16 value; the output rounded once.  An
    # emulation of the kernel's arithmetic (tests/test_torch_kernels_zoo.py)
    # stays within 0.36 of a 2^-6 row floor at s 2048, d 128, but the
    # kernel on an H100 reached 0.71 of it (its tensor cores sum S in
    # another order), so the row floor is flash_fwd's 2^-5 (the emulation
    # at 0.28 of it); a skipped key tile or a dropped D term exceed it 40
    # times or more
    ("flash_bwd", torch.bfloat16): (2, 2.0 ** -5, 2.0 ** -12),
}


def limit(want: torch.Tensor, ulps: float, floor: float,
          tensor_floor: float = 0.0) -> torch.Tensor:
    """The per-element limit of the module docstring, in f32."""
    w = want.float()
    tiny = torch.finfo(torch.float32).tiny
    binade = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(tiny))))
    ulp = binade * 2.0 ** -_MANTISSA[want.dtype]
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    lim = ulps * ulp + floor * rms
    if tensor_floor:
        lim = lim + tensor_floor * w.square().mean().sqrt()
    return lim.clamp_min(tiny)


def excess(got: torch.Tensor, want: torch.Tensor, ulps: float,
           floor: float, tensor_floor: float = 0.0) -> float:
    """max over elements of |got - want| / limit: at most 1 passes."""
    err = (got.float() - want.float()).abs()
    return float((err / limit(want, ulps, floor, tensor_floor)).max())


def kernel_excess(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """:func:`excess` with ``KERNEL_TOL[(name, got.dtype)]``."""
    return excess(got, want, *KERNEL_TOL[(name, got.dtype)])
