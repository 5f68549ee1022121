"""int8 error-feedback gradient compression (port of
:mod:`repro.train.compression`).

Each gradient leaf is quantized to int8 with one scale a leaf, and the
error-feedback accumulator carries the rounding error into the next step,
so the *expected* update stays unbiased over steps.  The reference's
module promises 4x fewer collective bytes, but its psum moves the payload
as int32 (an int8 sum over the group would overflow): as many bytes as
f32, twice a bf16 gradient's.  The port keeps the int32 wire.

* :func:`quantize_tree` / :func:`dequantize_tree` with a per-step error
  state: the quantizer alone, bit for bit the reference's (``torch.round``
  and ``jnp.round`` both round half to even).
* :func:`compressed_psum`: the explicit data-parallel building block of
  :func:`repro_torch.train.loop.make_manual_dp_train_step`: quantize, sum
  the payload over a process group with ``torch.distributed.all_reduce``,
  dequantize.

As in the reference, each process dequantizes the summed payload with its
**own** scale.  The processes' scales differ, so their "replicated"
results differ too, and the sum of payloads at different scales is not the
mean of the dequantized gradients either (ROADMAP §3, reference-side
problems).  The port keeps those semantics.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import check_tensor_backend
from repro_torch.models.layers import tree_leaves, tree_map


def _scale(g32: torch.Tensor) -> torch.Tensor:
    """max|g32| / 127 (at least 1e-30 / 127), as an f32 0-d tensor; the
    max of |x| taken as max(-min, max), with no |x| temporary."""
    lo, hi = torch.aminmax(g32)
    return torch.clamp(torch.maximum(-lo, hi), min=1e-30) / 127.0


def _leaf_quant(g: torch.Tensor, err: torch.Tensor):
    """(int8 q, f32 scale, new error) of ``g + err``."""
    g32 = g.float() + err
    scale = _scale(g32)
    t = torch.round(g32 / scale).clamp_(-127, 127)
    q = t.to(torch.int8)
    new_err = g32 - t.mul_(scale)
    return q, scale, new_err


def init_error_state(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def quantize_tree(grads, err_state):
    """-> (int8 tree, scale tree, new error state)."""
    out = {id(g): _leaf_quant(g, e) for g, e in
           zip(tree_leaves(grads), tree_leaves(err_state))}
    return tuple(tree_map(lambda g, i=i: out[id(g)][i], grads)
                 for i in range(3))


def dequantize_tree(qtree, scales):
    return tree_map(lambda q, s: q.to(torch.float32) * s, qtree, scales)


def compressed_psum(x: torch.Tensor, group, err: torch.Tensor):
    """int8 quantize, int32 all-reduce (sum) over ``group``, dequantize
    with this process's scale, divided by the group's size: returns
    ``(reduced x in x's dtype, new error)``.

    ``err`` (f32, x's shape) is updated **in place** and returned; the
    temporaries are one f32 and one int32 copy of the leaf.  ``group`` is
    a process group (``None``: the default group); its backend must run
    ``x``'s device (NCCL CUDA tensors, gloo CPU ones)."""
    check_tensor_backend(dist.get_backend(group), x.device)
    g32 = err.add_(x)                      # g.astype(f32) + err, in err
    scale = _scale(g32)
    t = torch.div(g32, scale).round_().clamp_(-127, 127)
    payload = t.to(torch.int32)            # the int8 values, on an int32 wire
    g32.sub_(t.mul_(scale))                # new error = g32 - q * scale
    del t
    dist.all_reduce(payload, dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    out = payload.to(torch.float32).mul_(scale).div_(n)
    return out.to(x.dtype), g32
