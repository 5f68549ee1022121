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

A matrix product is one ``dot_general`` equation in the reference, and
``torch.matmul``/``@``/``torch.einsum`` decompose into views, a GEMM and
more views in aten: the walker charges such a call at the function level
(:func:`dot_cost`: the GEMM's flops, operands plus result bytes, and the
``transpose`` jnp adds when the output's dim order is not dot_general's),
and nothing for the aten ops it decomposes into.  ``reshape`` likewise is
one equation (:func:`reshape_cost`) where aten may copy and view, and
``repeat_interleave`` is jnp.repeat's two (:func:`repeat_cost`); an int
index (``aten.select``) is jnp's slice and squeeze (:func:`select_cost`).  A
filled new tensor (``zeros``, ``full``) is jnp's ``broadcast_in_dim`` of a
literal: bytes only.

A fused aten op that stands for a whole jnp function is charged the
equations that function's jaxpr holds: ``aten._softmax`` and
``aten._log_softmax`` what ``jax.nn.softmax`` and ``jax.nn.log_softmax``
charge on JAX 0.9, and their backward ops what the VJP adds on top of the
forward (:func:`softmax_cost`).
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

#: ops that fill a new tensor with one value: jnp's ``broadcast_in_dim`` of
#: a literal (bytes: the literal and the result)
FILL_OPS = {"full", "zeros", "ones", "new_full", "new_zeros", "new_ones"}

#: zero-cost bookkeeping ops
FREE_OPS = {"detach", "empty", "empty_like", "zeros_like", "lift_fresh",
            "_local_scalar_dense", "scalar_tensor"}

#: reductions: element ops equal the input size
REDUCE_OPS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
              "prod", "any", "all", "cumsum", "cumprod", "logsumexp"}

MATMUL_OPS = {"mm", "bmm", "matmul", "addmm", "baddbmm"}

#: softmax-family ops, charged by :func:`softmax_cost`
SOFTMAX_OPS = {"_softmax", "_softmax_backward_data", "_log_softmax",
               "_log_softmax_backward_data"}


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


def _dot_bytes(ins, out: torch.Tensor) -> int:
    return sum(tensor_bytes(t) for t in ins) + tensor_bytes(out)


def select_cost(x: torch.Tensor, index: int, out: torch.Tensor) -> np.ndarray:
    """``x[i]`` with a Python int: jnp's ``slice`` then ``squeeze`` (a
    negative index: ``dynamic_slice``, a gather of its int32 start, then
    ``squeeze``)."""
    c = np.zeros(N_METRICS, dtype=np.float64)
    ob = tensor_bytes(out)
    c[I_BYTES] = tensor_bytes(x) + 3 * ob
    if index < 0:
        c[I_BYTES] += 4
        c[I_VPU] = c[I_GATHER] = out.numel()
    return c


def reshape_cost(x: torch.Tensor) -> np.ndarray:
    """One ``reshape`` equation: operand plus result (aten: a view, or a
    copy and a view when the operand is not contiguous)."""
    c = np.zeros(N_METRICS, dtype=np.float64)
    c[I_BYTES] = 2 * tensor_bytes(x)
    return c


def repeat_cost(x: torch.Tensor, out: torch.Tensor) -> np.ndarray:
    """``jnp.repeat(x, r, axis)`` with a static ``r``: a ``broadcast_in_dim``
    to a new dim of ``r`` and a ``reshape`` that merges it."""
    c = np.zeros(N_METRICS, dtype=np.float64)
    c[I_BYTES] = tensor_bytes(x) + 3 * tensor_bytes(out)
    return c


def dot_cost(name: str, args, out) -> np.ndarray | None:
    """Cost of ``torch.matmul`` / ``@`` / a two-operand ``torch.einsum`` as
    the reference's one ``dot_general`` (plus jnp's output transpose), or
    None where jnp would emit more (broadcast batch dims, summed-out or
    repeated letters, ellipses): the aten ops are charged then."""
    c = np.zeros(N_METRICS, dtype=np.float64)
    if name == "einsum":
        eq = args[0]
        ops = args[1:]
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = ops[0]
        if (len(ops) != 2 or not isinstance(eq, str) or "..." in eq
                or "->" not in eq):
            return None
        lhs, res = eq.replace(" ", "").split("->")
        la, lb = lhs.split(",")
        sizes: dict[str, int] = {}
        for letters, t in ((la, ops[0]), (lb, ops[1])):
            if len(letters) != t.dim() or len(set(letters)) != len(letters):
                return None
            for ch, n in zip(letters, t.shape):
                sizes[ch] = int(n)
        if any(ch not in res and not (ch in la and ch in lb) for ch in sizes):
            return None
        natural = ([ch for ch in la if ch in lb and ch in res]
                   + [ch for ch in la if ch not in lb]
                   + [ch for ch in lb if ch not in la])
        c[I_MXU] = 2 * math.prod(sizes.values())
        c[I_BYTES] = _dot_bytes(ops, out)
        if natural != list(res):
            c[I_BYTES] += 2 * tensor_bytes(out)
        return c
    a, b = args[0], args[1]
    if a.dim() < 2 or b.dim() < 2 or (b.dim() > 2 and a.shape[:-2] != b.shape[:-2]):
        return None
    c[I_MXU] = matmul_flops("matmul", [a, b])
    c[I_BYTES] = _dot_bytes((a, b), out)
    return c


def _softmax_eqns(e: int, r: int, nb: int, half: bool, vjp: bool,
                  rank: int) -> list:
    """(vpu, bytes, transcendentals) of each equation of ``jax.nn.softmax``
    over ``e`` elements of rank ``rank`` in ``r`` rows of ``nb``-byte
    elements on JAX 0.9
    (``vjp``: of ``jax.vjp(softmax)(g)``, which recomputes the forward with
    the max's tangent mask and guards).  A half dtype sums in f32 between
    two converts."""
    b, a = nb, (4 if half else nb)      # element bytes; the sum's
    out = [(e, (e + r) * b, 0)]                         # reduce_max
    if vjp:
        # a literal guard is broadcast to the rows first, unless they are 0-d
        lit = [(0, b + r * b, 0)] * 2 if rank > 1 else []
        out += [(0, 2 * r * b, 0), (e, (e + r) * b + e, 0),    # reshape, eq
                (0, e + e * b, 0), (e, (e + r) * b, 0),  # convert, reduce_sum
                (r, b + 2 * r * b, 0), (r, 2 * r * b + r, 0)]  # max, eq
        out += lit + [(r, r + 3 * r * b, 0), (r, b + r * b + r, 0)]  # select, eq
        out += lit + [(r, r + 3 * r * b, 0), (r, 3 * r * b, 0)]  # select, div
    else:
        out += [(r, b + 2 * r * b, 0)]                  # max(-inf)
    out += [(0, 2 * r * b, 0), (e, (2 * e + r) * b, 0),   # broadcast, sub
            (e, 2 * e * b, e)]                          # exp
    if half:
        out += [(0, e * b + 4 * e, 0)]                  # convert to f32
    out += [(e, (e + r) * a, 0), (0, 2 * r * a, 0)]     # reduce_sum, bcast
    if half:
        out += [(0, 4 * r + r * b, 0)]                  # convert back
    out += [(e, (2 * e + r) * b, 0)]                    # div
    if vjp:
        out += [(r, 2 * r * b, r), (e, (2 * e + r) * b, 0),  # pow(-2), mul
                (e, 3 * e * b, 0), (e, (e + r) * b, 0),  # mul, reduce_sum
                (0, 2 * r * b, 0), (r, 2 * r * b, 0),    # reshape, neg
                (e, (2 * e + r) * b, 0)]                 # div
        if half:
            out += [(0, r * b + 4 * r, 0)]
        out += [(r, 2 * r * a, 0), (0, (r + e) * a, 0)]  # reduce_sum, bcast
        if half:
            out += [(0, 4 * e + e * b, 0)]
        out += [(e, 3 * e * b, 0), (e, 3 * e * b, 0)]    # add_any, mul
    return out


def softmax_cost(name: str, x: torch.Tensor, dim: int) -> np.ndarray:
    """What the reference's walker charges for the jnp function an aten
    softmax-family op stands for, on ``x`` (the backward ops: the output
    gradient) along ``dim``.

    ``_softmax`` is ``jax.nn.softmax``'s jaxpr; ``_softmax_backward_data``
    what ``jax.vjp`` of it adds to that (the VJP recomputes the forward with
    the max's tangent mask).  On JAX 0.9 ``jax.nn.log_softmax`` is one
    ``jit`` equation, which the reference's walker does not enter: it
    charges it as one elementwise op, operands plus results (forward: x in,
    y out; VJP: two ``jit`` equations with outputs (y, exp, sum) and (dx)),
    and so does the port."""
    e = x.numel()
    r = e // max(x.shape[dim] if x.dim() else 1, 1)
    nb = dtype_bytes(dtype_name(x.dtype))
    c = np.zeros(N_METRICS, dtype=np.float64)
    if name == "_log_softmax":
        c[I_VPU], c[I_BYTES] = e, 2 * e * nb
        return c
    if name == "_log_softmax_backward_data":
        c[I_VPU], c[I_BYTES] = 2 * e + r, (4 * e + 2 * r) * nb
        return c
    half = x.dtype in (torch.bfloat16, torch.float16)
    fwd = np.sum(_softmax_eqns(e, r, nb, half, False, x.dim()), axis=0)
    if name == "_softmax_backward_data":
        fwd = np.sum(_softmax_eqns(e, r, nb, half, True, x.dim()), axis=0) - fwd
    c[I_VPU], c[I_BYTES], c[I_TRANS] = fwd
    return c


def op_cost(func, args, kwargs, out) -> np.ndarray:
    """6-metric cost vector of one dispatched aten op."""
    c = np.zeros(N_METRICS, dtype=np.float64)
    name = func.overloadpacket.__name__
    if name in FREE_OPS:
        return c
    if name in FILL_OPS:
        out_b = sum(tensor_bytes(o) for o in (out if isinstance(
            out, (list, tuple)) else [out]))
        c[I_BYTES] = out_b + dtype_bytes(dtype_name(
            (out[0] if isinstance(out, (list, tuple)) else out).dtype))
        return c
    if name == "select":
        return select_cost(args[0], int(args[2]), out)
    if name in SOFTMAX_OPS:
        # (self, dim, half_to_float) / (grad_output, output, dim, dtype)
        return softmax_cost(name, args[0],
                            int(args[2 if name.endswith("_data") else 1]))
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

