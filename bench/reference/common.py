"""Plain float32 PyTorch that the reference models share, and the layer-by-
layer drivers of their prefill and training step.

A reference is the configuration's mathematics written again with plain
``torch`` operations in f32 (TF32 off inside :func:`exact_f32`), from the
benchmark's own weights: no kernel, no cache, nothing of the program.  A
family module (``reference/<family>.py``) gives the input tree's layout
(``param_specs``, the port's parameter tree) and one layer (``layer``); this
module runs the embedding, the layers one at a time (each layer's weights
upcast to f32 only while it runs, so a 16 B model fits beside its
activations), the final norm and the tied LM head.  :class:`Numerics`
carries the precision: f32, or the control's fp8, where both operands of
every product are rounded to e4m3 with a per-tensor scale first (straight
through in the backward).

The layers are the port's whole list, in its order (:func:`layers`): each
stacked position of ``tree["unit"]`` at each unit index, then the ``rest``
layers.  ``fam.layer(sz, w, x, num)`` gets one layer's weights ``w`` (nested
by their paths inside the position) and tells the layer's kind from the
keys of ``w``, as the port's tree lays them out: ``mixer`` (a state-space
mixer) or ``attn`` (self-attention), each after the norm ``ln1``, and
``moe`` (routed and shared experts) or ``mlp`` (a dense FFN) after ``ln2``
where the layer has one.  So a family whose layers are of several kinds
needs nothing here but its own ``param_specs`` and ``layer``.  A slice (a
layer of a stacked leaf, a rest layer's leaf, or a top-level leaf whole) is
named by :func:`slice_namer`.

The training step is the configuration's: the mean cross-entropy over the
padded vocabulary plus 0.01 times the MoE layers' balance loss, gradients
by autograd one layer at a time from each layer's saved input, and AdamW
with f32 moments, the update clipped by the global gradient norm, bias
correction, weight decay on leaves of two or more dims (a stacked layer
leaf counts its layer dim), and the result cast back to the leaf's dtype.
Where the gradients of every leaf do not fit beside the moments the step
runs the layers' backward twice: once for the global norm, once to update.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from bench.weights import tree_items

FP8_MAX = 448.0
EPS = 1e-6


class Numerics:
    """Where the reference computes: f32, or fp8 e4m3 (the control): every
    product's operands and the residual stream between layers, which the
    configuration holds in bf16, rounded to fp8 first."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as the precision stores it."""
        return self.q(t)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        r = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return t + (r - t).detach()

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, *ops):
        return torch.einsum(eq, *(self.q(o) for o in ops))


F32 = Numerics(False)


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for cuBLAS and cuDNN, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, w, eps: float = EPS):
    """RMS norm with the configuration's ``(1 + w)`` weight."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, positions, theta: float):
    """Rotary embedding, halves rotated (x: b, s, heads, hd)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, None].float() * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, num: Numerics):
    """softmax(q kᵀ / sqrt(hd), causal) v, one sequence at a time; q: (b, s,
    h, hd), k/v: (b, s, g, hd) with g dividing h."""
    b, s, h, hd = q.shape
    r = h // k.shape[2]
    k = k.repeat_interleave(r, dim=2)
    v = v.repeat_interleave(r, dim=2)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = []
    for i in range(b):
        sc = num.einsum("shd,thd->hst", q[i], k[i]) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(~mask, -math.inf), dim=-1)
        out.append(num.einsum("hst,thd->shd", p, v[i]))
    return torch.stack(out)


#: the tree's leaves outside the layers, each one slice
TOP = ("embed", "final_norm")


def layers(tree) -> list[tuple[str, int | None, dict]]:
    """``(position, index, subtree)`` of every layer, in the port's order
    (``models/transformer.py::_layers``): layer ``u·U + j`` is position
    ``j`` of ``tree["unit"]`` at index ``u`` of its stacked leaves, then the
    ``rest`` layers, unstacked (index None).  ``position`` is the
    subtree's path in the tree: ``unit.<j>`` or ``rest.<j>``."""
    unit = tree["unit"]
    n_units = next(tree_items(unit[0]))[1].shape[0]
    out = [(f"unit.{j}", u, sub) for u in range(n_units)
           for j, sub in enumerate(unit)]
    return out + [(f"rest.{j}", None, sub)
                  for j, sub in enumerate(tree["rest"])]


def layer_of(sub, index) -> dict:
    """A layer's tensors by path inside its position (views of the stacked
    leaves at ``index``, or a rest layer's leaves)."""
    return {p: (t if index is None else t[index])
            for p, t in tree_items(sub)}


def leaf_paths(tree) -> list[str]:
    """Every leaf's path in the tree: the top-level leaves, then each
    position's (``unit.0.mixer.in_proj``, ``rest.0.ln1``)."""
    out = list(TOP)
    for pos in ("unit", "rest"):
        for j, sub in enumerate(tree[pos]):
            out += [f"{pos}.{j}.{p}" for p, _ in tree_items(sub)]
    return out


def slice_namer(tree):
    """``(leaf path, layer index or None) -> slice key``.  A tree of one
    stacked position and no rest layers keeps the key of the path inside
    the unit, ``mixer.in_proj[3]``; any other tree names the position too,
    ``unit.1.attn.wq[3]`` or ``rest.0.ln1``."""
    one_kind = len(tree["unit"]) == 1 and not tree["rest"]

    def key(path: str, index) -> str:
        if one_kind and path.startswith("unit.0."):
            path = path[len("unit.0."):]
        return path if index is None else f"{path}[{index}]"

    return key


def nest(flat: dict) -> dict:
    """``{"a.b": t}`` as ``{"a": {"b": t}}``."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def f32(t: torch.Tensor) -> torch.Tensor:
    """An f32 copy (never the tensor itself, which the update writes)."""
    return t.to(torch.float32, copy=True)


def final_hidden(fam, sz: dict, tree, batches, num: Numerics = F32):
    """The final-normed hidden states (b, s, d) f32 of each batch of tokens
    (b, s), the layers run one at a time over all batches."""
    d = sz["d_model"]
    with torch.no_grad():
        table = f32(tree["embed"])
        hs = [num.act(F.embedding(t.long(), table) * math.sqrt(d))
              for t in batches]
        del table
        for _, index, sub in layers(tree):
            w = nest({p: f32(t) for p, t in layer_of(sub, index).items()})
            hs = [num.act(fam.layer(sz, w, h, num)[0]) for h in hs]
            del w
        fw = f32(tree["final_norm"])
        return [rms_norm(h, fw) for h in hs]


def lm_logits(hn, tree, num: Numerics = F32):
    """The tied LM head over the padded vocabulary."""
    return num.mm(hn, tree["embed"].float().T)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def lr_at(step: int, opt: dict) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * frac))


def _grads(fam, sz, tree, tokens, labels, num, sink, chunk: int = 512):
    """One step's loss; ``sink(path, layer, grad)`` gets every gradient
    slice in f32 (the final norm first, then the layers from the top, the
    tied embedding last), each layer's backward recomputing it from its
    saved input; ``path`` is the leaf's path in the tree and ``layer`` its
    index in the stacked leaf (None for a whole leaf)."""
    d = sz["d_model"]
    b, s = tokens.shape
    tokens = tokens.long()
    table = f32(tree["embed"])
    walk = layers(tree)
    xs, aux_total = [], 0.0
    with torch.no_grad():
        x = num.act(F.embedding(tokens, table) * math.sqrt(d))
        for _, index, sub in walk:
            xs.append(x)
            w = nest({p: f32(t) for p, t in layer_of(sub, index).items()})
            x, aux = fam.layer(sz, w, x, num)
            x = num.act(x)
            aux_total += float(aux)
            del w
    h = x.requires_grad_()
    emb = table.requires_grad_()
    fw = f32(tree["final_norm"]).requires_grad_()
    ce_total = 0.0
    step = chunk if 0 < chunk < s else s
    for c in range(0, s, step):
        logits = num.mm(rms_norm(h[:, c:c + step], fw), emb.T)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c:c + step, None].long())
        ce = (lse - gold[..., 0]).sum()
        (ce / (b * s)).backward()
        ce_total += float(ce.detach())
        del logits, lse, gold, ce
    sink("final_norm", None, fw.grad)
    g, emb_grad = h.grad, emb.grad
    del h, x, fw
    emb.requires_grad_(False)
    for i in reversed(range(len(walk))):
        pos, index, sub = walk[i]
        xin = xs[i].requires_grad_()
        flat = {p: f32(t).requires_grad_() for p, t in
                layer_of(sub, index).items()}
        y, aux = fam.layer(sz, nest(flat), xin, num)
        obj = (num.act(y) * g).sum()
        if torch.is_tensor(aux) and aux.requires_grad:
            obj = obj + 0.01 * aux
        got = torch.autograd.grad(obj, [xin] + list(flat.values()))
        g = got[0]
        for path, gr in zip(flat, got[1:]):
            sink(f"{pos}.{path}", index, gr)
        xs[i] = None
        del flat, y, aux, obj, got, xin
    emb_grad.index_add_(0, tokens.reshape(-1), g.reshape(-1, d) * math.sqrt(d))
    sink("embed", None, emb_grad)
    return ce_total / (b * s) + 0.01 * aux_total


def _leaf(tree, path: str):
    """The leaf at a dotted path (``unit.1.attn.wq``, ``embed``)."""
    node = tree
    for k in path.split("."):
        node = node[int(k)] if isinstance(node, (tuple, list)) else node[k]
    return node


def _slices(tree, path: str):
    """A leaf's slices: one a layer of a stacked leaf, else the whole."""
    if path.startswith("unit."):
        return range(_leaf(tree, path).shape[0])
    return (None,)


def train_steps(fam, sz: dict, tree, batches, opt: dict, start_of,
                num: Numerics = F32, two_pass: bool | None = None) -> dict:
    """Steps 1..len(batches) of the configuration's training from ``tree``
    (updated in place): each step's loss and global gradient norm, every
    slice's norm of the first step's gradient after the clip (as AdamW's
    first moment holds it) and of the parameters' change after the last
    step.  ``batches``: (tokens, labels) on the device; ``start_of(path)``
    draws a leaf's starting value again (the seeded weights)."""
    mu = {p: torch.zeros(_leaf(tree, p).shape, dtype=torch.float32,
                         device=tree["embed"].device)
          for p in leaf_paths(tree)}
    nu = {p: torch.zeros_like(m) for p, m in mu.items()}
    if two_pass is None:
        n = sum(m.numel() for m in mu.values())
        free = torch.cuda.mem_get_info()[0] if mu["embed"].is_cuda else 1 << 62
        two_pass = 4 * n + (8 << 30) > free
    out = {"loss": [], "grad_norm": [], "grad1": {}, "change": {}}
    with exact_f32():
        for t, (tokens, labels) in enumerate(batches, start=1):
            sq: dict = {}
            kept: dict = {}

            def norm_sink(path, layer, g):
                sq[(path, layer)] = float((g * g).sum())
                if not two_pass:
                    kept[(path, layer)] = g

            loss = _grads(fam, sz, tree, tokens, labels, num, norm_sink)
            gn = math.sqrt(sum(sq.values()))
            scale = min(1.0, opt["grad_clip"] / max(gn, 1e-12))
            lr = lr_at(t, opt)
            bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t

            @torch.no_grad()
            def update(path, layer, g):
                p = _leaf(tree, path)
                m, v = mu[path], nu[path]
                if layer is not None:
                    p, m, v = p[layer], m[layer], v[layer]
                gf = g * scale
                m.mul_(opt["b1"]).add_(gf * (1 - opt["b1"]))
                v.mul_(opt["b2"]).add_(gf * (1 - opt["b2"]) * gf)
                upd = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
                pf = p.float()
                if _leaf(tree, path).dim() >= 2:
                    pf = pf * (1 - lr * opt["weight_decay"])
                p.copy_(pf - lr * upd)

            if two_pass:
                _grads(fam, sz, tree, tokens, labels, num, update)
            else:
                for (path, layer), g in kept.items():
                    update(path, layer, g)
                kept.clear()
            out["loss"].append(loss)
            out["grad_norm"].append(gn)
            if t == 1:
                key = slice_namer(tree)
                out["grad1"] = {key(*k): math.sqrt(v) * scale
                                for k, v in sq.items()}
    out["change"] = change_norms(tree, start_of)
    return out


def change_norms(tree, start_of) -> dict:
    """Each slice's norm of its leaf less the leaf's start
    (``start_of(path)``, drawn again one leaf at a time)."""
    out, key = {}, slice_namer(tree)
    with torch.no_grad():
        for path in leaf_paths(tree):
            now, was = _leaf(tree, path), start_of(path)
            for i in _slices(tree, path):
                a, b = (now, was) if i is None else (now[i], was[i])
                out[key(path, i)] = float((a.float() - b.float()).norm())
            del was
    return out


def slice_norms(tree, factor: float = 1.0) -> dict:
    """Each slice's norm (times ``factor``) of a tree laid out as the
    inputs (an optimizer moment, a gradient)."""
    out, key = {}, slice_namer(tree)
    with torch.no_grad():
        for path in leaf_paths(tree):
            t = _leaf(tree, path)
            for i in _slices(tree, path):
                out[key(path, i)] = factor * float(
                    (t if i is None else t[i]).float().norm())
    return out
