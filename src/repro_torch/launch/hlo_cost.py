"""Loop-aware cost model over post-SPMD HLO text, and the port's
counterpart of that text: the op log of one step.

**The HLO-text half** is a port copy of :mod:`repro.launch.hlo_cost`
(``shape_bytes``, ``shape_elems``, ``parse_module``, ``while_trip_count``,
``analyze``, ``top_sites`` and their helpers), kept line for line: on any
HLO text both packages give the same numbers to the bit.  It parses
``compiled.as_text()`` into computations and a call graph, finds while
trip counts from the loop-condition constant, and aggregates

    flops            (dot/convolution ops, 2·M·N·K from shapes)
    hbm bytes        (operands+results of *top-scope* ops: fusion kernels,
                      dots, copies — ops inside fused computations are
                      register-level and excluded)
    collective bytes (operand sizes of all-reduce / all-gather /
                      reduce-scatter / all-to-all / collective-permute,
                      per-kind, with replica-group sizes)

multiplied along the call graph (fusion/call × 1, while body × trips).
The :class:`HloCost` record and its :meth:`HloCost.from_metric_vector`
(which :mod:`repro_torch.core.portability` reads) are the reference's.

**The op-log half.**  Eager PyTorch compiles no program, so the port has
no HLO text.  :func:`record_step` runs a step on meta tensors under the
cost walker (:class:`~repro_torch.core.tracer.CostWalker`, whose rules are
:func:`repro_torch.core.metrics.op_cost`) and keeps an :class:`OpLog`: one
:class:`OpRecord` per dispatched aten op (its scope, the op, its result's
HLO-style type and its 6-vector cost) and one per c10d collective (its kind
under the reference's name, its operand bytes counted as
``_accumulate_op`` counts them, its group size).  :func:`analyze` and
:func:`top_sites` take an :class:`OpLog` where they take HLO text: flops
are the tensor-FLOP column, bytes the byte column (every eager op reads
and writes HBM, so operands plus results is the port's honest count),
transcendentals the transcendental column, and the collective fields come
from the collective records.  A site's multiplicity is how many times it
ran in the step: the units of a layer stack that the walker walks once
and charges ``n`` times (:func:`~repro_torch.core.tracer.scan_loop`) play
the role of the reference's while trip count, and the units that run one
by one (under autograd) add up.

Where the two legitimately differ:

* *Fusion.*  XLA's bytes are those of fusion boundaries; the op log's are
  every eager op's operands and results, so its bytes exceed the HLO's
  wherever XLA fuses elementwise chains (its flops agree where both count
  the same products).
* *Collectives.*  GSPMD picks its own collectives for a sharding (often
  all-gathers of weights or reduce-scatters where the port's Megatron
  pair all-reduces activations, :mod:`repro_torch.sharding.spmd`), so the
  kinds and bytes follow two different plans of the same model.
* *Scope.*  The port's models are functions over parameter trees, not
  ``nn.Module`` objects: a record's scope is the innermost function of the
  port's model code on the Python stack (``models.attention.attention``),
  where the reference names the HLO computation; an op of the autograd
  backward outside model code is scoped ``backward:<node>``.
* *Loop bookkeeping.*  A counted loop's counter update is a record
  (``loop_counter``); the walker's scan-step column is not a cost here.
"""
from __future__ import annotations

import dataclasses
import re
import sys
import weakref
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core.events import N_METRICS, is_comm
from repro_torch.core.metrics import I_BYTES, I_MXU, I_TRANS, dtype_name
from repro_torch.core.tracer import CostWalker

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s4": 1, "u4": 1,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f32": 4, "s32": 4, "u32": 4,
    "f64": 8, "s64": 8, "u64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0, "s2": 1, "u2": 1,
}

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")


def shape_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) HLO type string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def shape_elems(type_str: str) -> int:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return 1
    dims = m.group(2)
    n = 1
    if dims:
        for d in dims.split(","):
            if d:
                n *= int(d)
    return n


def _shape_dims(type_str: str) -> list[int]:
    m = _SHAPE_RE.search(type_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",") if d]


@dataclasses.dataclass
class Op:
    name: str
    opcode: str
    result_type: str
    operands: list[str]
    attrs: str
    line: str


@dataclasses.dataclass
class Computation:
    name: str
    params: dict[str, str]          # param name -> type
    ops: dict[str, Op]
    order: list[str]


_COMP_HDR = re.compile(
    r"^(?:ENTRY\s+)?%?([\w.\-]+)(?:\.clone)?\s*\((.*?)\)\s*->")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^)]*\)|[\w\[\],{}\s]+?))\s+"
    r"([\w\-]+)\((.*)$")


ENTRY_KEY = "__entry__"


def parse_module(text: str) -> dict[str, Computation]:
    """Parse computations; the ENTRY computation's name is stored under
    the ``ENTRY_KEY`` pseudo-entry (a plain string, not a Computation)."""
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    for raw in text.splitlines():
        line = raw.rstrip()
        s = line.strip()
        if not s or s.startswith("//") or s.startswith("HloModule"):
            continue
        hdr = _COMP_HDR.match(s)
        if hdr and s.endswith("{"):
            if s.startswith("ENTRY"):
                comps[ENTRY_KEY] = hdr.group(1)  # type: ignore[assignment]
            params = {}
            for pm in re.finditer(r"%?([\w.\-]+):\s*((?:\([^)]*\)|[\w\[\],{}]+))",
                                  hdr.group(2)):
                params[pm.group(1)] = pm.group(2)
            cur = Computation(hdr.group(1), params, {}, [])
            comps[cur.name] = cur
            continue
        if s == "}" or s == "})":
            cur = None
            continue
        if cur is None:
            continue
        m = _OP_RE.match(s)
        if not m:
            continue
        name, rtype, opcode, rest = m.groups()
        # split operands (up to the matching close paren) from attributes
        depth = 1
        i = 0
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    break
        operand_str, attrs = rest[:i], rest[i + 1:]
        operands = []
        d2 = 0
        tok = ""
        for ch in operand_str:
            if ch == "," and d2 == 0:
                operands.append(tok.strip())
                tok = ""
            else:
                if ch in "([{":
                    d2 += 1
                elif ch in ")]}":
                    d2 -= 1
                tok += ch
        if tok.strip():
            operands.append(tok.strip())
        operands = [o.lstrip("%") for o in operands]
        op = Op(name, opcode, rtype.strip(), operands, attrs, s)
        cur.ops[name] = op
        cur.order.append(name)
    return comps


def _operand_type(comp: Computation, operand: str) -> str | None:
    operand = operand.split(" ")[-1].lstrip("%")
    if operand in comp.ops:
        return comp.ops[operand].result_type
    if operand in comp.params:
        return comp.params[operand]
    return None


def _dot_flops(comp: Computation, op: Op) -> int:
    out_elems = shape_elems(op.result_type)
    lhs_t = _operand_type(comp, op.operands[0]) if op.operands else None
    if lhs_t is None:
        return 2 * out_elems  # unknown contraction; degrade gracefully
    lhs_dims = _shape_dims(lhs_t)
    cm = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", op.attrs)
    k = 1
    if cm and cm.group(1):
        for d in cm.group(1).split(","):
            if d and int(d) < len(lhs_dims):
                k *= lhs_dims[int(d)]
    return 2 * out_elems * k


def _conv_flops(comp: Computation, op: Op) -> int:
    out_elems = shape_elems(op.result_type)
    rhs_t = _operand_type(comp, op.operands[1]) if len(op.operands) > 1 else None
    if rhs_t is None:
        return 2 * out_elems
    kernel_elems = shape_elems(rhs_t)
    dims = _shape_dims(rhs_t)
    out_ch = dims[-1] if dims else 1   # heuristic: o is usually last in `io`
    return 2 * out_elems * max(kernel_elems // max(out_ch, 1), 1)


_CALL_ATTRS = (
    ("calls=", 1), ("to_apply=", 1), ("body=", None), ("condition=", None),
    ("true_computation=", 1), ("false_computation=", 1),
)


def _callees(op: Op) -> list[tuple[str, str]]:
    """[(kind, computation_name)]; kind in {call, body, condition, branch}."""
    out = []
    for m in re.finditer(r"(calls|to_apply|body|condition|true_computation|"
                         r"false_computation)=%?([\w.\-]+)", op.attrs):
        kind = {"calls": "call", "to_apply": "apply", "body": "body",
                "condition": "condition"}.get(m.group(1), "branch")
        out.append((kind, m.group(2)))
    bm = re.search(r"branch_computations=\{([^}]*)\}", op.attrs)
    if bm:
        for name in bm.group(1).split(","):
            out.append(("branch", name.strip().lstrip("%")))
    return out


def _group_size(op: Op) -> int:
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", op.attrs)
    if m:
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{([0-9, ]*)\}", op.attrs)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip()])
    return 0


def while_trip_count(comps: dict[str, Computation], cond_name: str) -> int:
    """Largest s32 constant in the loop condition ≈ the scan length."""
    cond = comps.get(cond_name)
    if cond is None:
        return 1
    best = 1
    for op in cond.ops.values():
        if op.opcode == "constant" and op.result_type.startswith("s32"):
            m = re.search(r"constant\((-?\d+)\)", op.line)
            if m:
                best = max(best, int(m.group(1)))
        if op.opcode == "fusion":
            for _, callee in _callees(op):
                sub = comps.get(callee)
                if sub:
                    for o2 in sub.ops.values():
                        if o2.opcode == "constant" and o2.result_type.startswith("s32"):
                            m = re.search(r"constant\((-?\d+)\)", o2.line)
                            if m:
                                best = max(best, int(m.group(1)))
    return best


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_count: int = 0
    transcendentals: float = 0.0

    def add(self, other: "HloCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        self.collective_count += int(other.collective_count * mult)
        self.transcendentals += other.transcendentals * mult
        for k, v in other.collective_by_kind.items():
            self.collective_by_kind[k] += v * mult

    #: roofline weights mapping the 6-metric trace vector onto HLO-level
    #: flop/byte totals: a transcendental costs ~8 flop-equivalents on the
    #: VPU's polynomial pipelines, a gathered element moves a 4-byte word
    #: through the (HBM-bound) gather unit.  scan_steps is deliberately
    #: excluded — loop-turn bookkeeping is not hardware work, and keeping
    #: it out makes predicted totals match the walker's measured totals.
    TRANS_FLOP_WEIGHT = 8.0
    GATHER_BYTE_WEIGHT = 4.0

    @classmethod
    def from_metric_vector(cls, vec) -> "HloCost":
        """Project a 6-metric trace vector (``events.METRIC_NAMES`` order:
        mxu_flops, vpu_elems, hbm_bytes, transcendentals, gather_elems,
        scan_steps) onto roofline terms — the bridge between fitted
        terminal costs and :mod:`repro_torch.core.portability`
        predictions."""
        mxu, vpu, hbm, trans, gather, _scan = (float(v) for v in vec)
        return cls(flops=mxu + vpu + cls.TRANS_FLOP_WEIGHT * trans,
                   bytes=hbm + cls.GATHER_BYTE_WEIGHT * gather,
                   transcendentals=trans)


_TRANS_OPS = {"exponential", "log", "tanh", "power", "rsqrt", "sqrt",
              "logistic", "sine", "cosine", "expm1", "log-plus-one"}


def _op_cost(comp: Computation, op: Op, comps, in_fusion: bool) -> HloCost:
    """Cost of one op, resolving operand types within its computation."""
    one = HloCost()
    _accumulate_op(one, comp, op, comps, in_fusion)
    return one


def _comp_own_cost(comp: Computation, comps, fused_names: set[str],
                   in_fusion: bool) -> HloCost:
    c = HloCost()
    for op in comp.ops.values():
        _accumulate_op(c, comp, op, comps, in_fusion)
    return c


def _accumulate_op(c: HloCost, comp: Computation, op: Op, comps,
                   in_fusion: bool) -> None:
    if True:
        oc = op.opcode
        if oc == "dot":
            c.flops += _dot_flops(comp, op)
        elif oc == "convolution":
            c.flops += _conv_flops(comp, op)
        elif oc in _TRANS_OPS:
            c.transcendentals += shape_elems(op.result_type)
        base = oc.replace("-start", "")
        if base in COLLECTIVE_OPS and not oc.endswith("-done"):
            nbytes = sum(shape_bytes(_operand_type(comp, o) or "")
                         for o in op.operands)
            c.collective_bytes += nbytes
            c.collective_by_kind[base] += nbytes
            c.collective_count += 1
        if not in_fusion:
            # HBM traffic: top-scope kernels only (fusion boundaries).
            # reshape/broadcast/iota are layout-aliasing (usually free);
            # gather/dynamic-slice touch only the *result*-sized window of
            # their operand, and scatter/dus update in place.
            if oc in ("gather", "dynamic-slice"):
                c.bytes += 2 * shape_bytes(op.result_type)
                for o in op.operands[1:]:
                    t = _operand_type(comp, o)
                    if t:
                        c.bytes += shape_bytes(t)
            elif oc in ("scatter", "dynamic-update-slice"):
                for o in op.operands[1:]:
                    t = _operand_type(comp, o)
                    if t:
                        c.bytes += 2 * shape_bytes(t)
            elif oc in ("fusion", "dot", "convolution", "copy", "custom-call",
                        "reduce", "sort", "cholesky", "triangular-solve",
                        "concatenate", "transpose", "slice", "pad") or \
                    base in COLLECTIVE_OPS:
                nbytes = shape_bytes(op.result_type)
                sparse_idx = (_gather_param_idxs(comps, op)
                              if oc == "fusion" else frozenset())
                for i, o in enumerate(op.operands):
                    t = _operand_type(comp, o)
                    if not t:
                        continue
                    if i in sparse_idx:
                        # operand is only gathered from: window-sized traffic
                        nbytes += min(shape_bytes(t),
                                      shape_bytes(op.result_type))
                    else:
                        nbytes += shape_bytes(t)
                c.bytes += nbytes
    return c


def _gather_param_idxs(comps, op: Op) -> frozenset:
    """Operand indices of a fusion that are only read through gather/
    dynamic-slice inside the fused computation (embedding tables etc.)."""
    callee = next((n for k, n in _callees(op) if k == "call"), None)
    sub = comps.get(callee) if callee else None
    if sub is None:
        return frozenset()
    param_order = {name: i for i, name in enumerate(sub.params)}
    gathered: set[int] = set()
    direct: set[int] = set()
    for o2 in sub.ops.values():
        for j, operand in enumerate(o2.operands):
            nm = operand.split(" ")[-1].lstrip("%")
            if nm in param_order:
                if o2.opcode in ("gather", "dynamic-slice") and j == 0:
                    gathered.add(param_order[nm])
                else:
                    direct.add(param_order[nm])
    return frozenset(gathered - direct)


def top_sites(text: str, n: int = 20, key: str = "bytes") -> list[tuple]:
    """Largest per-op cost sites with loop multiplicities — the dry-run
    'profile' used in §Perf hillclimbing.  Returns
    [(total, mult, comp, op_name, opcode, result_type), ...] sorted desc.
    (The port: ``text`` may be an :class:`OpLog`, whose sites are (scope,
    op, opcode, result type).)"""
    if isinstance(text, OpLog):
        return _top_sites_log(text, n, key)
    comps = parse_module(text)
    entry = _find_entry(comps)
    fused: set[str] = set()
    applied: set[str] = set()
    for comp in comps.values():
        for op in comp.ops.values():
            for kind, callee in _callees(op):
                if op.opcode == "fusion" and kind == "call":
                    fused.add(callee)
                elif kind == "apply":
                    applied.add(callee)

    mults: dict[str, float] = defaultdict(float)

    def walk(name: str, mult: float, depth: int = 0):
        if depth > 64 or name not in comps:
            return
        mults[name] += mult
        for op in comps[name].ops.values():
            callees = _callees(op)
            if op.opcode == "while":
                cond = next((c for k, c in callees if k == "condition"), None)
                trips = while_trip_count(comps, cond) if cond else 1
                for k, c in callees:
                    walk(c, mult * trips, depth + 1)
            else:
                for k, c in callees:
                    walk(c, mult, depth + 1)

    walk(entry, 1.0)
    sites = []
    for name, comp in comps.items():
        mult = mults.get(name, 0.0)
        if mult == 0:
            continue
        in_fusion = name in fused or name in applied
        for op in comp.ops.values():
            c = _op_cost(comp, op, comps, in_fusion)
            val = {"bytes": c.bytes, "flops": c.flops,
                   "collective": c.collective_bytes}[key]
            if val > 0:
                sites.append((val * mult, mult, name, op.name, op.opcode,
                              op.result_type[:48]))
    sites.sort(reverse=True)
    return sites[:n]


def _find_entry(comps) -> str | None:
    ent = comps.pop(ENTRY_KEY, None)
    if isinstance(ent, str) and ent in comps:
        return ent
    called = {c for comp in comps.values()
              for op in comp.ops.values()
              for _, c in _callees(op)}
    entries = [n for n in comps if n not in called]
    return entries[0] if entries else (next(iter(comps)) if comps else None)


def analyze(text: str, entry: str | None = None) -> HloCost:
    # the port: an OpLog is analyzed from its records
    if isinstance(text, OpLog):
        return _analyze_log(text)
    comps = parse_module(text)
    ent = _find_entry(comps)
    if entry is None:
        entry = ent
    if not comps or entry is None:
        return HloCost()
    # find fusion-called computations (register scope: no byte counting)
    fused: set[str] = set()
    applied: set[str] = set()
    for comp in comps.values():
        for op in comp.ops.values():
            for kind, callee in _callees(op):
                if op.opcode == "fusion" and kind == "call":
                    fused.add(callee)
                elif kind == "apply":
                    applied.add(callee)
    own = {name: _comp_own_cost(comp, comps, fused,
                                in_fusion=name in fused or name in applied)
           for name, comp in comps.items()}

    memo: dict[str, HloCost] = {}

    def total(name: str, depth: int = 0) -> HloCost:
        if name in memo:
            return memo[name]
        if depth > 64 or name not in comps:
            return HloCost()
        memo[name] = HloCost()   # cycle guard
        c = HloCost()
        c.add(own[name])
        comp = comps[name]
        for op in comp.ops.values():
            callees = _callees(op)
            if op.opcode == "while":
                body = next((n for k, n in callees if k == "body"), None)
                cond = next((n for k, n in callees if k == "condition"), None)
                trips = while_trip_count(comps, cond) if cond else 1
                if body:
                    c.add(total(body, depth + 1), trips)
                if cond:
                    c.add(total(cond, depth + 1), trips)
            elif op.opcode == "conditional":
                # expected-value semantics: weight each branch uniformly.
                # Exactly right for the flash causal block-skip (half the
                # (q,kv) blocks take the skip branch); a uniform prior for
                # anything else.
                branches = [n for k, n in callees if k == "branch"]
                for n in branches:
                    c.add(total(n, depth + 1), 1.0 / max(len(branches), 1))
            else:
                for k, n in callees:
                    if k in ("call", "apply"):
                        c.add(total(n, depth + 1), 1.0)
        memo[name] = c
        return c

    return total(entry)


# ---------------------------------------------------------------------------
# the op log: the port's counterpart of a compiled program's text
# ---------------------------------------------------------------------------

#: numpy dtype names as HLO element types
_HLO_TYPES = {
    "bool": "pred", "int8": "s8", "uint8": "u8", "int16": "s16",
    "uint16": "u16", "int32": "s32", "uint32": "u32", "int64": "s64",
    "uint64": "u64", "float16": "f16", "bfloat16": "bf16", "float32": "f32",
    "float64": "f64", "complex64": "c64", "complex128": "c128",
    "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2",
}

#: c10d ops as the reference's collective kinds, with the index of the
#: argument that holds the operands (what a process sends in); a receive
#: is the other half of a send and is not counted again
_C10D_KINDS = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "broadcast_": ("collective-broadcast", 0),
    "send": ("collective-permute", 0),
}

#: never a record's scope: the walker's own machinery, and the collective
#: helpers (their ops are scoped to the model code that called them)
_NOT_SCOPES = ("repro_torch.core.tracer", "repro_torch.core.metrics",
               "repro_torch.launch.", "repro_torch.sharding.")
#: the port's model code: its frames scope an op inside a backward too
#: (remat's recompute, a custom autograd function's backward)
_MODEL_CODE = ("repro_torch.models.", "repro_torch.kernels.")


def _flat(x) -> list:
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    if isinstance(x, dict):
        return [y for v in x.values() for y in _flat(v)]
    return [x]


def _tensors(x) -> list:
    return [t for t in _flat(x) if isinstance(t, torch.Tensor)]


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _hlo_type(out) -> str:
    """A result as an HLO type string (``bf16[4,2048,3072]``; a tuple for
    several tensors)."""
    parts = []
    for t in _tensors(out):
        dt = dtype_name(t.dtype)
        parts.append(f"{_HLO_TYPES.get(dt, dt)}"
                     f"[{','.join(str(int(d)) for d in t.shape)}]")
    return parts[0] if len(parts) == 1 else "(" + ", ".join(parts) + ")"


def _scope() -> str:
    """The innermost function of the port's code on the stack (outside the
    walker), or ``backward:<node>`` for an autograd node's op outside the
    model code."""
    f, name, mod = sys._getframe(2), "<step>", ""
    while f is not None:
        m = f.f_globals.get("__name__", "")
        if m.startswith("repro_torch.") and not m.startswith(_NOT_SCOPES):
            name, mod = f"{m[len('repro_torch.'):]}.{f.f_code.co_name}", m
            break
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is not None and not mod.startswith(_MODEL_CODE):
        return f"backward:{node.name()}"
    return name


def _pg_size(args) -> int:
    """The size of the process group among a c10d op's arguments."""
    for a in _flat(list(args)):
        if isinstance(a, torch.ScriptObject):
            try:
                return int(torch.distributed.ProcessGroup.unbox(a).size())
            except (RuntimeError, TypeError):
                continue
    return 0


@dataclasses.dataclass
class OpRecord:
    """One site of a step: an aten op (or another charge of the walker)
    with the 6-vector ``cost`` of one run, or a collective (``opcode`` one
    of ``COLLECTIVE_OPS``) with its operand bytes and group size.
    ``mult`` is how many times it ran."""
    scope: str
    op: str
    opcode: str
    result_type: str
    cost: np.ndarray
    mult: float = 1.0
    collective_bytes: int = 0
    group_size: int = 0


@dataclasses.dataclass
class OpLog:
    """One step as :func:`record_step` recorded it: the records in dispatch
    order, the walker's own total 6-vector (``total``: the records' costs
    times their multiplicities, plus the scan-step column), the bytes of
    the arguments, and the peak of the bytes live beyond them (every
    storage the step allocated and had not yet freed)."""
    records: list
    total: np.ndarray
    argument_bytes: int = 0
    peak_temp_bytes: int = 0


class _Recorder(CostWalker):
    """The cost walker that keeps the op log and the live storage bytes."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self._args: set[int] = set()
        self._live: dict[int, int] = {}
        self.live = self.peak = 0

    # -- the op log ----------------------------------------------------------

    def charge(self, cost, site, out=None):
        super().charge(cost, site, out)
        if isinstance(site, str):
            op = opcode = site
        elif isinstance(site, torch._ops.OpOverload):
            op, opcode = str(site), site.overloadpacket.__name__
        else:                                   # a torch function
            opcode = getattr(site, "__name__", str(site))
            op = f"torch.{opcode}"
        self.records.append(OpRecord(_scope(), op, opcode, _hlo_type(out),
                                     np.array(cost, dtype=np.float64)))

    def mark(self):
        return len(self.records)

    def repeat_since(self, mark, n):
        for r in self.records[mark:]:
            r.mult *= n

    def drop_since(self, mark):
        del self.records[mark:]

    def _collective(self, func, args, kwargs):
        kind, at = _C10D_KINDS[func._opname]
        nbytes = sum(_tensor_bytes(t) for t in _tensors(args[at]))
        self.records.append(OpRecord(
            _scope(), str(func), kind, _hlo_type(args[at]),
            np.zeros(N_METRICS), collective_bytes=nbytes,
            group_size=_pg_size(list(args) + list(kwargs.values()))))

    # -- live storage bytes --------------------------------------------------

    def hold_arguments(self, tree) -> int:
        """Register the step's arguments; returns their bytes."""
        total = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) not in self._args:
                self._args.add(id(st))
                total += st.nbytes()
        return total

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._args or key in self._live:
                continue
            n = int(st.nbytes())
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            out = func(*args, **kwargs)
            if func._opname in _C10D_KINDS and not self._paused:
                self._collective(func, args, kwargs)
            return out
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self._track(out)
        return out


def record_step(fn, *args) -> tuple:
    """``(fn(*args), OpLog)``: ``fn`` run once under the recording walker,
    its arguments (meta tensors, in any nesting) held as the step's inputs.
    A walker charge of a loop walked once stands for every turn (its
    ``mult``); storages are counted from their allocation to their last
    reference."""
    rec = _Recorder()
    arg_bytes = rec.hold_arguments(args)
    with rec:
        out = fn(*args)
    total = rec.pending + sum((e.vector for e in rec.events
                               if not is_comm(e)), np.zeros(N_METRICS))
    return out, OpLog(rec.records, total, arg_bytes, rec.peak)


def _analyze_log(log: OpLog) -> HloCost:
    c = HloCost()
    for r in log.records:
        if r.opcode in COLLECTIVE_OPS:
            c.collective_bytes += r.collective_bytes * r.mult
            c.collective_by_kind[r.opcode] += r.collective_bytes * r.mult
            c.collective_count += int(r.mult)
        else:
            c.flops += r.cost[I_MXU] * r.mult
            c.bytes += r.cost[I_BYTES] * r.mult
            c.transcendentals += r.cost[I_TRANS] * r.mult
    return c


def _top_sites_log(log: OpLog, n: int, key: str) -> list[tuple]:
    sites: dict[tuple, list] = {}
    for r in log.records:
        if r.opcode in COLLECTIVE_OPS:
            val = {"collective": r.collective_bytes}.get(key, 0)
        else:
            val = {"bytes": r.cost[I_BYTES], "flops": r.cost[I_MXU]}.get(
                key, 0)
        if val > 0:
            s = sites.setdefault((r.scope, r.op, r.opcode, r.result_type),
                                 [0.0, 0.0])
            s[0] += val * r.mult
            s[1] += r.mult
    out = [(total, mult, scope, op, opcode, rtype[:48])
           for (scope, op, opcode, rtype), (total, mult) in sites.items()]
    out.sort(reverse=True)
    return out[:n]
