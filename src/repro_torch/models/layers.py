"""Shared model layers: norms, RoPE, MLP, embeddings.

The port of ``src/repro/models/layers.py``.  Parameters are plain nested
dicts and tuples of tensors; a :class:`Param` carries (shape, logical axes,
init scale, dtype) and :func:`init_tree` turns a Param tree into tensors by
the reference's ``materialize`` rule, and :func:`logical_axes` the tree of
its logical axes, which :mod:`repro_torch.sharding.partition` maps to mesh
axes.

On a mesh the layers take ``mesh``: the :class:`~repro_torch.sharding.
spmd.Spmd` context of a mesh that shards the parameters (None computes
whole), and their parameters as this process's blocks.  The MLP is
column-parallel in ``wi``/``wg`` and row-parallel in ``wo`` on ``ffn``;
the embedding, the LM head and the loss are vocab-parallel (a masked
lookup summed over the ``model`` axis; the log-softmax from all-reduced
maxima and sums, the gold logit from the process that holds it); a weight
whose ``embed`` dim is split over ``data`` is gathered before use (FSDP).
The reference places the same arrays by constraints and lets GSPMD insert
the collectives.
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


def logical_axes(tree):
    """The logical axes tuple of each :class:`Param` of a Param tree, in
    the tree's structure (the reference's ``layers.logical_axes``)."""
    return tree_map(lambda p: p.axes, tree)


def init_tree(tree, seed: int, device, local=None) -> dict:
    """Concrete init of a Param tree on ``device`` (``materialize``'s rule,
    ``layers.py:46-63`` of the reference): scale 0 gives zeros, a leaf of at
    most one dim ones times the scale, any other leaf normal(0, scale /
    sqrt(shape[-2])).  The draws come from a ``torch.Generator`` on the
    device (seconds for a 3B model on the card), so the values differ from
    the reference's numpy draws; carry those across with
    ``model.params_from_numpy``.  On the meta device nothing is drawn.
    ``local(param, tensor)``, where given, keeps a part of each leaf as it
    is drawn (a mesh's block: ``model.init_params(mesh=)``), so the whole
    tree never sits in memory at once."""
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

    if local is None:
        return tree_map(one, tree)
    return tree_map(lambda p: local(p, one(p)), tree)


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


def mlp_apply(p: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    if mesh is None:
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
        return h @ p["wo"]
    d, ff = x.shape[-1], mesh.cfg.d_ff
    wi = mesh.unshard(p["wi"], (d, ff), ("embed", "ffn"))
    wg = mesh.unshard(p["wg"], (d, ff), ("embed", "ffn"))
    wo = mesh.unshard(p["wo"], (ff, d), ("ffn", "embed"))
    if not mesh.split((d, ff), ("embed", "ffn"), 1):
        # columns the model axis does not divide: whole on each process
        return (F.silu(x @ wg) * (x @ wi)) @ wo
    x = mesh.copy(x)
    h = F.silu(x @ wg) * (x @ wi)
    return mesh.reduce(h @ wo)


def embed_params(vocab: int, d: int, dtype: str) -> Param:
    return Param((vocab, d), ("vocab", "embed"), dtype=dtype)


def _vocab(mesh, table: torch.Tensor):
    """(whole-``embed`` table block, first vocab row of the block): the
    table's ``data`` split gathered, its ``model`` split kept."""
    shape = (mesh.cfg.padded_vocab, mesh.cfg.d_model)
    table = mesh.unshard(table, shape, ("vocab", "embed"))
    if not mesh.split(shape, ("vocab", "embed"), 0):
        return table, None
    return table, mesh.block()[0] * table.shape[0]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, mesh=None
                 ) -> torch.Tensor:
    """``table[tokens]``.  Through ``F.embedding``, whose backward sums each
    row's gradients in token order: the backward of plain indexing is an
    accumulating ``index_put_`` that, on the CPU above its grain size, adds
    in parallel in no fixed order, so two equal steps could differ.  On a
    vocab-split table each process looks up the tokens of its rows (zero
    elsewhere) and the rows are summed over ``model`` (exact)."""
    tokens = tokens.long()
    if mesh is not None:
        table, lo = _vocab(mesh, table)
        if lo is not None:
            local = tokens - lo
            inside = (local >= 0) & (local < table.shape[0])
            x = F.embedding(torch.where(inside, local, 0), table)
            return mesh.reduce(torch.where(inside[..., None], x, 0))
    return F.embedding(tokens, table)


def unembed(x: torch.Tensor, table: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    """The LM head; on a mesh, the logits of this process's vocab block."""
    if mesh is not None:
        table, lo = _vocab(mesh, table)
        if lo is not None:
            x = mesh.copy(x)
    return x @ table.T.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """Stable CE in f32; logits (..., V), labels int (...)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def softmax_xent_split(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                       mesh) -> torch.Tensor:
    """:func:`softmax_xent` of logits split over ``model`` by vocab
    (``logits`` this process's block, its first vocab row ``lo``): the max
    and the sum of exponentials all-reduced, the gold logit summed from the
    process that holds it.  The max takes no gradient: it cancels out of
    the log-sum-exp, as it does in the reference's."""
    logits = logits.float()
    m = mesh.max(logits.amax(dim=-1, keepdim=True))
    lse = torch.log(mesh.reduce(torch.exp(logits - m).sum(dim=-1))) + m[..., 0]
    local = labels.long() - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    return lse - mesh.reduce(torch.where(inside, gold[..., 0], 0.0))


def _xent(x, table, labels, mesh):
    if mesh is not None:
        table, lo = _vocab(mesh, table)
        if lo is not None:
            return softmax_xent_split(mesh.copy(x) @ table.T.to(x.dtype),
                                      labels, lo, mesh)
    return softmax_xent(unembed(x, table), labels, table.shape[0])


def _chunk_xent_sum(x: torch.Tensor, table: torch.Tensor,
                    labels: torch.Tensor, mesh=None) -> torch.Tensor:
    return _xent(x, table, labels, mesh).sum()


def chunked_loss(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 chunk: int, mesh=None) -> torch.Tensor:
    """LM head + mean CE, taken over sequence chunks when ``chunk`` divides
    the sequence (and is shorter): peak logits memory O(chunk·V) instead of
    O(S·V).  Each chunk is checkpointed, so its logits are not kept for the
    backward either: the backward recomputes one chunk's at a time (and
    its collectives, on a mesh).  Chunk sums are added in order into an
    f32 total, as the reference's scan."""
    b, s, d = x.shape
    if chunk <= 0 or s % chunk != 0 or s == chunk:
        return _xent(x, table, labels, mesh).mean()
    n = s // chunk
    xc = x.reshape(b, n, chunk, d).transpose(0, 1)           # (n, b, chunk, d)
    lc = labels.reshape(b, n, chunk).transpose(0, 1)

    def body(acc, xl):
        xi, li = xl
        return acc + checkpoint(_chunk_xent_sum, xi, table, li, mesh,
                                use_reentrant=False)

    total = scan_loop(n, body, torch.zeros((), dtype=torch.float32,
                                           device=x.device), xs=(xc, lc))
    return total / (b * s)
