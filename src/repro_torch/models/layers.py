"""Shared model layers: norms, RoPE, MLP, embeddings.

The port of ``src/repro/models/layers.py``.  Parameters are plain nested
dicts and tuples of tensors; a :class:`Param` carries (shape, logical axes,
init scale, dtype) and :func:`init_tree` turns a Param tree into tensors by
the reference's ``materialize`` rule.  The sharding constraints of the
reference wait for the port's mesh slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tracer import scan_loop

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A numpy dtype name (the configs' convention) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class Param:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    scale: float = 1.0          # fan-in style init scale
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, tuples and lists (and of the
    trees ``rest`` of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order of ``jax.tree.leaves`` (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init_tree(tree, seed: int, device) -> dict:
    """Concrete init of a Param tree on ``device`` (``materialize``'s rule,
    ``layers.py:46-63`` of the reference): scale 0 gives zeros, a leaf of at
    most one dim ones times the scale, any other leaf normal(0, scale /
    sqrt(shape[-2])).  The draws come from a ``torch.Generator`` on the
    device (seconds for a 3B model on the card), so the values differ from
    the reference's numpy draws; carry those across with
    ``model.params_from_numpy``.  On the meta device nothing is drawn."""
    device = torch.device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(int(seed))

    def one(p: Param) -> torch.Tensor:
        dt = torch_dtype(p.dtype)
        if device.type == "meta":
            return torch.empty(p.shape, dtype=dt, device=device)
        if p.scale == 0.0:
            return torch.zeros(p.shape, dtype=dt, device=device)
        if len(p.shape) <= 1:
            return torch.full(p.shape, float(p.scale), dtype=torch.float32,
                              device=device).to(dt)
        std = p.scale / math.sqrt(max(p.shape[-2], 1))
        x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dt)

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding over the last dim; x: (..., seq, heads, head_dim)."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freq                  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]                          # bcast heads
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], dim=-1).to(x.dtype)


def mlp_params(d: int, ff: int, dtype: str) -> dict:
    return {
        "wi": Param((d, ff), ("embed", "ffn"), dtype=dtype),
        "wg": Param((d, ff), ("embed", "ffn"), dtype=dtype),
        "wo": Param((ff, d), ("ffn", "embed"), dtype=dtype),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]


def embed_params(vocab: int, d: int, dtype: str) -> Param:
    return Param((vocab, d), ("vocab", "embed"), dtype=dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Through ``F.embedding``, whose backward sums each
    row's gradients in token order: the backward of plain indexing is an
    accumulating ``index_put_`` that, on the CPU above its grain size, adds
    in parallel in no fixed order, so two equal steps could differ."""
    return F.embedding(tokens.long(), table)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return x @ table.T.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """Stable CE in f32; logits (..., V), labels int (...)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def _chunk_xent_sum(x: torch.Tensor, table: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    return softmax_xent(unembed(x, table), labels, table.shape[0]).sum()


def chunked_loss(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """LM head + mean CE, taken over sequence chunks when ``chunk`` divides
    the sequence (and is shorter): peak logits memory O(chunk·V) instead of
    O(S·V).  Each chunk is checkpointed, so its logits are not kept for the
    backward either: the backward recomputes one chunk's at a time.  Chunk
    sums are added in order into an f32 total, as the reference's scan."""
    b, s, d = x.shape
    if chunk <= 0 or s % chunk != 0 or s == chunk:
        return softmax_xent(unembed(x, table), labels, table.shape[0]).mean()
    n = s // chunk
    xc = x.reshape(b, n, chunk, d).transpose(0, 1)           # (n, b, chunk, d)
    lc = labels.reshape(b, n, chunk).transpose(0, 1)

    def body(acc, xl):
        xi, li = xl
        return acc + checkpoint(_chunk_xent_sum, xi, table, li,
                                use_reentrant=False)

    total = scan_loop(n, body, torch.zeros((), dtype=torch.float32,
                                           device=x.device), xs=(xc, lc))
    return total / (b * s)
