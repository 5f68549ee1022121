"""Per-op cost model: the six-column counter analog, keyed by aten op.

Port of :mod:`repro.core.metrics`.  The reference maps each jaxpr equation
to a 6-metric vector; the port maps each aten op that PyTorch dispatches to
the same vector, with the same rules, so a proxy block costs the same in
both packages:

    mxu_flops, vpu_elems, hbm_bytes, transcendentals, gather_elems, scan_steps

On Hopper the columns read as tensor-core FLOPs, CUDA-core element ops,
DRAM bytes, SFU transcendentals, gathered elements and serial loop steps.
``hbm_bytes`` stays fusion-agnostic (operands + results per op) on both
sides, so the block-combination fit is self-consistent.

Three rules carry the reference's jaxpr conventions over to aten:

* a Python scalar operand is a jaxpr literal and counts one element of the
  first tensor operand's dtype (``v * 0.999999`` on f32 reads 4 bytes);
* a slice is a view in PyTorch but an equation in JAX: view ops are charged
  as data movement, input plus output bytes;
* ``tab[idx]`` lowers in jnp to a gather whose start indices are an
  ``(n, 1)`` column built by ``broadcast_in_dim``: ``aten.index`` charges
  that column's bytes too.  (jnp's negative-index wrap is written out in
  the block itself, see :func:`repro_torch.core.blocks.gather_rand`.)
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.events import N_METRICS, dtype_bytes

# --- metric indices ---------------------------------------------------------
I_MXU, I_VPU, I_BYTES, I_TRANS, I_GATHER, I_SCAN = range(N_METRICS)

#: ops whose elementwise application hits the slow path
TRANSCENDENTAL_OPS = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "tan", "sin",
    "cos", "asin", "acos", "atan", "atan2", "sinh", "cosh", "asinh", "acosh",
    "atanh", "erf", "erfc", "erfinv", "sigmoid", "pow", "rsqrt", "sqrt",
    "digamma", "lgamma",
}

#: irregular-address ops (the L1_DCM analog)
GATHER_OPS = {"gather", "index", "index_select", "take", "take_along_dim",
              "scatter", "scatter_add", "scatter_reduce", "index_put",
              "sort", "argsort", "topk"}

#: ops that move data without arithmetic (count bytes only); view ops are
#: here because the reference's ``slice``/``reshape`` equations are
DATA_MOVEMENT_OPS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "slice", "select", "narrow", "cat", "stack",
    "pad", "constant_pad_nd", "flip", "clone", "copy", "copy_", "_to_copy",
    "alias", "split", "split_with_sizes", "unbind", "repeat", "arange",
}

#: zero-cost bookkeeping ops
FREE_OPS = {"detach", "empty", "empty_like", "zeros_like", "lift_fresh",
            "_local_scalar_dense"}

#: reductions: element ops equal the input size
REDUCE_OPS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
              "prod", "any", "all", "cumsum", "cumprod", "logsumexp"}

MATMUL_OPS = {"mm", "bmm", "matmul", "addmm", "baddbmm"}


def dtype_name(dtype) -> str:
    """Numpy name of a torch dtype (``torch.bfloat16`` -> ``"bfloat16"``),
    the spelling :func:`~repro_torch.core.events.dtype_bytes` reads."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def torch_dtype(name: str) -> torch.dtype:
    """Torch dtype of a numpy dtype name (the inverse of :func:`dtype_name`)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * dtype_bytes(dtype_name(t.dtype))


def _flat_args(args, kwargs) -> list:
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


def matmul_flops(name: str, tensors: list[torch.Tensor]) -> int:
    """2*M*N*K*batch for a matrix product (the bias of addmm is elementwise
    work the reference never emits)."""
    if name in ("addmm", "baddbmm"):
        tensors = tensors[1:]
    lhs, rhs = tensors[0].shape, tensors[1].shape
    batch = math.prod(lhs[:-2]) if len(lhs) > 2 else 1
    m = lhs[-2] if len(lhs) >= 2 else 1
    k = lhs[-1]
    n = rhs[-1] if len(rhs) >= 2 else 1
    return 2 * batch * m * n * k


def op_cost(func, args, kwargs, out) -> np.ndarray:
    """6-metric cost vector of one dispatched aten op."""
    c = np.zeros(N_METRICS, dtype=np.float64)
    name = func.overloadpacket.__name__
    if name in FREE_OPS:
        return c
    flat = _flat_args(args, kwargs)
    ins = [a for a in flat if isinstance(a, torch.Tensor)]
    outs = [o for o in (out if isinstance(out, (list, tuple)) else [out])
            if isinstance(o, torch.Tensor)]
    out_elems = sum(o.numel() for o in outs)
    in_bytes = sum(tensor_bytes(t) for t in ins)
    if ins:
        # Python scalars are jaxpr literals typed like the tensor operand
        n_scalars = sum(1 for a in flat if isinstance(a, (bool, int, float))
                        and not isinstance(a, torch.Tensor))
        if name not in DATA_MOVEMENT_OPS and name not in REDUCE_OPS \
                and name not in GATHER_OPS:
            in_bytes += n_scalars * dtype_bytes(dtype_name(ins[0].dtype))
    c[I_BYTES] = in_bytes + sum(tensor_bytes(o) for o in outs)
    if name in MATMUL_OPS:
        c[I_MXU] = matmul_flops(name, ins)
    elif name in TRANSCENDENTAL_OPS:
        c[I_TRANS] = out_elems
        c[I_VPU] = out_elems
    elif name in GATHER_OPS:
        c[I_GATHER] = out_elems
        c[I_VPU] = out_elems   # address computation
        if name == "index":
            # jnp's (n, 1) start-index column (broadcast_in_dim in and out)
            c[I_BYTES] += 2 * sum(tensor_bytes(t) for t in ins[1:])
    elif name in DATA_MOVEMENT_OPS:
        pass  # bytes only
    elif name in REDUCE_OPS:
        c[I_VPU] = sum(t.numel() for t in ins)
    else:
        # generic elementwise (add/mul/where/compare/min/max/...)
        c[I_VPU] = out_elems
    return c

