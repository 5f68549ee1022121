"""The 11 proxy basic blocks (port of :mod:`repro.core.blocks`).

Each block excites about one metric column:

  id  name          excites
  --  ------------  --------------------------------------------
   1  mxu_vmem      mxu_flops at high arithmetic intensity
   2  mxu_small     mxu_flops at low arithmetic intensity
   3  hbm_stream    hbm_bytes (f32 stream)
   4  vpu_chain     vpu_elems (int8: fewest bytes per element)
   5  trans_chain   transcendentals
   6  gather_rand   gather_elems
   7  reduce_long   vpu_elems at 4 bytes per element
   8  scan_seq      scan_steps + vpu
   9  move_shift    hbm_bytes with no element ops
  10  empty_loop    scan_steps only
  11  loop_turn     scan_steps: the combo loop's own turn

Blocks 1-9 run inside block 11's loop: block i runs ``x_i`` loop turns of
``unroll`` applications, then ``x11 - sum(x_1..9)`` padding turns follow,
then block 10's ``x10`` empty turns.  One application of block i therefore
costs ``col_i + col_11`` (see :mod:`repro_torch.core.proxy_search`).

The replay state is a plain dict of tensors on one device; every block
takes a state and returns a new dict.  Blocks accept a leading batch shape
on every leaf (one entry per rank), which is how a signature group replays
per-rank seeds in one pass.

On a CUDA state, :func:`repeat_block` runs blocks 1 and 3 as ONE launch of
their hand-written kernels (``reps = n * unroll``) instead of ``n * unroll``
eager launches.  On a CPU state the same wrappers take their plain
versions.  Under the cost walker (meta tensors) it takes the plain block
bodies, so B and every combo cost are the same whether the kernels engage
or not.

Calibration (matrix B, paper eq. 2) runs the same walker that costs target
programs, so the walker cost of a generated proxy is ``B @ x`` by
construction.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.events import N_METRICS
from repro_torch.core.metrics import torch_dtype
from repro_torch.core.tracer import compute_cost, counted_loop, scan_loop
from repro_torch.device import resolve_device
from repro_torch.kernels.proxy_blocks import ops as kernels

BLOCK_NAMES: tuple[str, ...] = (
    "mxu_vmem", "mxu_small", "hbm_stream", "vpu_chain", "trans_chain",
    "gather_rand", "reduce_long", "scan_seq", "move_shift",
    "empty_loop", "loop_turn",
)
N_BLOCKS = len(BLOCK_NAMES)

# geometry constants (the reference's, blocks.py:56-64)
_MM = 128            # mxu_vmem tile
_MS = 8              # mxu_small M-dim (low arithmetic intensity)
_VEC = 1 << 15       # hbm_stream vector (128 KiB f32)
_TILE = (32, 128)    # element-op tile
_TAB = 1 << 14       # gather table
_NIDX = 4096         # gather indices
_SCAN_LEN = 64       # scan_seq inner length

#: state leaves: name -> (shape, torch dtype)
STATE_SPEC: dict[str, tuple[tuple[int, ...], torch.dtype]] = {
    "a": ((_MM, _MM), torch.bfloat16),
    "b": ((_MM, _MM), torch.bfloat16),
    "w": ((_MM, _MM), torch.float32),
    "v": ((_VEC,), torch.float32),
    "t": (_TILE, torch.float32),
    "t8": (_TILE, torch.int8),
    "tab": ((_TAB,), torch.float32),
    "idx": ((_NIDX,), torch.int32),
    "s": ((), torch.float32),
}


def _leaf(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy -> torch leaf with the reference's rounding: JAX canonicalises
    float64 to float32 before any narrower cast, so bf16 leaves are
    float64 -> float32 -> bfloat16.  numpy bfloat16 (ml_dtypes) widens to
    float32 exactly."""
    x = np.asarray(x)
    if x.dtype == np.float64 or x.dtype.name == "bfloat16":
        x = x.astype(np.float32)
    return torch.from_numpy(np.array(x, order="C")).to(device=device,
                                                        dtype=dtype)


def init_state(seed: int = 0, device=None) -> dict:
    """Fixed-shape state threaded through every block, drawn from
    ``np.random.RandomState(seed)`` in the reference's order.  ``device=None``
    is the CUDA card (see :func:`repro_torch.device.resolve_device`)."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    draws = {
        "a": rng.uniform(-1, 1, (_MM, _MM)),
        # matmul operands carry the 1/128 contraction normalisation, so the
        # MXU blocks emit zero element ops
        "b": rng.uniform(-1, 1, (_MM, _MM)) / _MM,
        "w": rng.uniform(-1, 1, (_MM, _MM)) / _MM,
        "v": rng.uniform(0, 1, (_VEC,)),
        "t": rng.uniform(-1, 1, _TILE),
        "t8": rng.randint(-64, 64, _TILE),
        "tab": rng.uniform(0, 1, (_TAB,)),
        "idx": rng.randint(0, _TAB, (_NIDX,)),
        "s": np.float32(0.0),
    }
    return {k: _leaf(draws[k], STATE_SPEC[k][1], device) for k in STATE_SPEC}


def state_from_numpy(d: dict, device=None) -> dict:
    """The port's state from numpy leaves (e.g. the reference's
    ``init_replay_state`` leaves read back with ``np.asarray``); keys the
    block state does not know (comm buffers) keep their numpy dtype.
    ``device=None`` is the CUDA card."""
    device = resolve_device(device)
    out = {}
    for k, x in d.items():
        x = np.asarray(x)
        if k in STATE_SPEC:
            out[k] = _leaf(x, STATE_SPEC[k][1], device)
        elif x.dtype.name == "bfloat16":
            out[k] = _leaf(x, torch.bfloat16, device)
        else:
            out[k] = _leaf(x, torch_dtype(x.dtype.name), device)
    return out


def state_to_numpy(st: dict) -> dict:
    """numpy copy of a state (bf16 leaves as float32)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in st.items()}


# -- the block bodies (one "application" each) --------------------------------


def mxu_vmem(st: dict) -> dict:
    """128x128x128 bf16 matmul, kept on chip: high-AI tensor-core pressure."""
    st = dict(st)
    st["a"] = st["a"] @ st["b"]
    return st


def mxu_small(st: dict) -> dict:
    """8x128x128 f32 matmul: tensor-core FLOPs at low arithmetic intensity."""
    st = dict(st)
    t = st["t"]
    out = t[..., :_MS, :] @ st["w"]
    st["t"] = torch.cat([out, t[..., _MS:, :]], dim=-2)
    return st


def hbm_stream(st: dict) -> dict:
    """Streaming f32 vector update: bytes per element op ~ 8."""
    st = dict(st)
    st["v"] = st["v"] * 0.999999 + 1e-6
    return st


def vpu_chain(st: dict) -> dict:
    """int8 ALU chain: the fewest bytes per element op (ratio ~2)."""
    st = dict(st)
    t = st["t8"]
    for _ in range(4):
        t = (t + 3) ^ 21
    st["t8"] = t
    return st


def trans_chain(st: dict) -> dict:
    """tanh chain: transcendental slow-path pressure."""
    st = dict(st)
    t = st["t"]
    for _ in range(2):
        t = torch.tanh(t)
    st["t"] = t * 1.0009765625   # escape the tanh fixed point at 0
    return st


def gather_rand(st: dict) -> dict:
    """Random-index gather from a table: irregular-address pressure."""
    st = dict(st)
    idx = st["idx"]
    idx = torch.where(idx < 0, idx + _TAB, idx)   # jnp's negative-index wrap
    tab = st["tab"]
    if tab.dim() == 1:
        g = tab[idx]
    else:   # a batch of states: one gather per row
        g = torch.gather(tab, -1, idx.long())
    st["s"] = st["s"] * 0.5 + torch.sum(g, dim=-1) * 1e-6
    return st


def reduce_long(st: dict) -> dict:
    """Long reduction: element ops at 4 bytes per element."""
    st = dict(st)
    st["s"] = st["s"] * 0.5 + torch.sum(st["v"], dim=-1) * 1e-9
    return st


def scan_seq(st: dict) -> dict:
    """Sequential scalar scan: serialisation (scan_steps)."""
    st = dict(st)
    st["s"] = scan_loop(_SCAN_LEN, lambda c: c * 0.9999 + 1e-7, st["s"])
    return st


def move_shift(st: dict) -> dict:
    """Pure data movement (slice + concat roll): bytes, zero element ops."""
    st = dict(st)
    v = st["v"]
    st["v"] = torch.cat([v[..., _VEC // 2:], v[..., :_VEC // 2]], dim=-1)
    return st


BLOCK_FNS: dict[str, Callable[[dict], dict]] = {
    "mxu_vmem": mxu_vmem, "mxu_small": mxu_small, "hbm_stream": hbm_stream,
    "vpu_chain": vpu_chain, "trans_chain": trans_chain,
    "gather_rand": gather_rand, "reduce_long": reduce_long,
    "scan_seq": scan_seq, "move_shift": move_shift,
}


def _kernel_mxu(st: dict, reps: int) -> dict:
    st = dict(st)
    # b carries the 1/128 already (init_state), so the block is scale 1
    st["a"] = kernels.mxu_iter(st["a"], st["b"], reps, scale=1.0)
    return st


def _kernel_stream(st: dict, reps: int) -> dict:
    st = dict(st)
    st["v"] = kernels.stream_iter(st["v"], reps)
    return st


#: blocks replayed by one kernel launch of ``reps`` applications
KERNEL_BLOCKS = {"mxu_vmem": _kernel_mxu, "hbm_stream": _kernel_stream}


def repeat_block(name: str, n, st: dict, unroll: int = 1) -> dict:
    """Run block ``name`` for ``n`` loop turns of ``unroll`` applications
    each (the paper's x_i block instances inside the block-11 loop)."""
    n, unroll = int(n), int(unroll)
    kern = KERNEL_BLOCKS.get(name)
    if kern is not None and st["a"].device.type != "meta":
        return kern(st, n * unroll)
    fn = BLOCK_FNS[name]

    def body(s):
        for _ in range(unroll):
            s = fn(s)
        return s

    return counted_loop(n, body, st)


def empty_turns(n, st: dict) -> dict:
    """n empty loop turns (block 10 / block-11 padding)."""
    return counted_loop(int(n), lambda s: s, st)


def run_combo(st: dict, x, unroll: int = 1) -> dict:
    """Execute the block combination for count vector ``x`` (len 11)."""
    x = [int(v) for v in x]
    body = int(sum(x[:9]))
    if x[10] < body:
        raise ValueError(f"x11={x[10]} < sum(x1..9)={body}")
    for i, name in enumerate(BLOCK_NAMES[:9]):
        if x[i] > 0:
            st = repeat_block(name, x[i], st, unroll)
    pad = x[10] - body
    if pad > 0:
        st = empty_turns(pad, st)
    if x[9] > 0:
        st = empty_turns(x[9], st)
    return st


def run_combo_dyn(st: dict, x, unroll: int = 1) -> dict:
    """Count-vector variant of :func:`run_combo`: ``x`` is an int tensor
    (or array) of 11 counts, and the block-11 padding is clamped at 0
    rather than checked.

    The reference traces ``x`` into the compiled replay as a device value
    whose trip counts the loops read on the device.  Eager PyTorch has no
    traced trip count: a loop's turns are host integers.  So the counts are
    read to the host once, in one transfer, before any block runs."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.int64).tolist()
    x = [int(v) for v in np.asarray(x, dtype=np.int64).reshape(-1)]
    if len(x) != N_BLOCKS:
        raise ValueError(f"need {N_BLOCKS} counts, got {len(x)}")
    for i, name in enumerate(BLOCK_NAMES[:9]):
        if x[i] > 0:
            st = repeat_block(name, x[i], st, unroll)
    pad = max(x[10] - sum(x[:9]), 0)
    if pad > 0:
        st = empty_turns(pad, st)
    if x[9] > 0:
        st = empty_turns(x[9], st)
    return st


# -- calibration: build matrix B (paper eq. 2) --------------------------------


@functools.lru_cache(maxsize=1)
def calibration_matrix() -> np.ndarray:
    """B[i, j]: metric i per single application of block j (walker-measured
    on meta tensors).  Columns 10 and 11 are one empty loop turn each."""
    st = _meta_state()
    b = np.zeros((N_METRICS, N_BLOCKS))
    for j, name in enumerate(BLOCK_NAMES[:9]):
        b[:, j] = compute_cost(BLOCK_FNS[name], st)
    k = 1024
    turn = compute_cost(lambda s: empty_turns(k, s), st) / k
    b[:, 9] = turn
    b[:, 10] = turn
    return b


def _meta_state() -> dict:
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in STATE_SPEC.items()}


def combo_cost(x, unroll: int = 1) -> np.ndarray:
    """Predicted walker cost of ``run_combo(st, x, unroll)``."""
    b = calibration_matrix()
    x = np.asarray(x, dtype=np.float64)
    scaled = b.copy()
    scaled[:, :9] *= unroll
    return scaled @ x
