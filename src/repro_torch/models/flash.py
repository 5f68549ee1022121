"""Flash attention with a backward: the port of ``src/repro/models/
flash.py::flash_attention`` (its custom VJP).

Forward: the flash kernel (``kernels/flash_attention``: CUDA on the card,
the plain version on the CPU), which also gives each row's log-sum-exp
when a gradient is wanted.  Only (q, k, v, out, lse) survive to the
backward, as in the reference (``flash.py:216``); the backward is the
FlashAttention-2 recomputation, the hand-written ``flash_bwd`` kernel on
the card and ``attention_bwd_ref`` on the CPU.  Without autograd (grad mode
off, or no input that needs a gradient) this is the forward wrapper alone,
which writes no LSE: the serve path launches what it launched before.

On a mesh the kernels run on what the mode (:func:`attn_mode`) gives a
process (``models/attention.py``): its heads in ``"heads"`` mode, every
head of its batch rows in ``"batch"`` mode, and in ``"cp"`` mode its block
of query positions against every key, the block's first position passed
as ``q_offset`` to the causal and window masks of both kernels.
The reference's ``q_chunk``/``kv_chunk`` arguments are read
only on meta tensors, which the cost walker runs: there the wrappers
compute the reference's blocked XLA flash at those blocks, so the walker
charges what the reference's does.  The kernels take any s and t and
ignore them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import (
    flash_attention_bwd, flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.ref import KV_CHUNK, Q_CHUNK
from repro_torch.sharding.partition import axis_sizes


def _sizes(mesh) -> dict[str, int]:
    """Axis sizes of a mesh, a geometry or an ``Spmd`` context."""
    if mesh is None:
        return {}
    return axis_sizes(getattr(mesh, "sizes", mesh))


def _tp_size(mesh) -> int:
    return _sizes(mesh).get("model", 1)


def _mesh_size(mesh) -> int:
    n = 1
    for s in _sizes(mesh).values():
        n *= s
    return n


def attn_mode(mesh, n_heads: int, batch: int) -> str:
    """The reference's attention sharding mode: ``"heads"`` (the heads
    divide the model axis: tensor parallel over heads), else ``"batch"``
    (the global batch divides the whole mesh), else ``"cp"`` (context
    parallel over q chunks)."""
    if n_heads % _tp_size(mesh) == 0:
        return "heads"
    if batch % _mesh_size(mesh) == 0:
        return "batch"
    return "cp"


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk, q_offset):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True, q_chunk=q_chunk,
                                       kv_chunk=kv_chunk, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, q_chunk=q_chunk,
                        kv_chunk=kv_chunk, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (b,s,h,d), k/v: (b,t,g,d) -> (b,s,h,d) in q's dtype.

    ``q_chunk``/``kv_chunk``: the reference's blocks, read only on meta
    tensors (what the cost walker charges); the kernels ignore them.
    ``q_offset``: the position of q's first row (a ``"cp"`` block)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Flash.apply(q, k, v, causal, window, q_chunk, kv_chunk,
                            q_offset)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               q_offset=q_offset)
