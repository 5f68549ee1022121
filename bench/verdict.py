"""The numbers that decide ``correct``, each the program's reading against
the plain reference's.

Training (the first steps of the run's own step object, on the first
batches): each step's loss and global gradient norm as relative gaps; the
first step's gradient as AdamW's first moment holds it, and the parameters'
change after the checked steps, each by the worst slice (a layer of a
stacked leaf, or the embedding or final norm whole): the gap between the
program's norm and the reference's, over the larger of the reference's norm
of that slice and of the median slice.  Slices whose first gradient in the
reference is under a thousandth of the median slice's move by round-off
alone and are left out of the change.

Serving: over the checked requests, the widest gap by which a served
token's reference logit lies below the reference's best, the largest
relative L2 error of the program's last-position logits, and the worst over
the prompt lengths of that error's median within a length.
"""
from __future__ import annotations

import math
import statistics

import torch

#: a slice whose reference gradient is under this share of the median
#: slice's is left out of the change (it moves by round-off alone)
NOUGHT = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def worst_slice(prog: dict, ref: dict, keys=None) -> float:
    keys = sorted(ref) if keys is None else keys
    med = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        if k not in prog:
            return math.inf
        den = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / den if den else 0.0
        if not gap <= worst:         # a NaN reading is the worst
            worst = gap
    return worst


def worst_slices(prog: dict, ref: dict, n: int = 4) -> list:
    """The ``n`` slices of largest gap: [key, program, reference]."""
    med = statistics.median(ref.values())
    gap = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}
    return [[k, prog[k], ref[k]] for k in
            sorted(gap, key=lambda k: -gap[k])[:n]]


def train_numbers(prog: dict, ref: dict) -> dict:
    med = statistics.median(ref["grad1"].values())
    moved = [k for k, g in ref["grad1"].items() if g >= NOUGHT * med]
    return {
        "loss": max(rel_gap(a, b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_norm": max(rel_gap(a, b) for a, b in
                         zip(prog["grad_norm"], ref["grad_norm"])),
        "grad_slice": worst_slice(prog["grad1"], ref["grad1"]),
        "change_slice": worst_slice(prog["change"], ref["change"], moved),
    }


def token_gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """ref best - ref logit of each served token; ref_logits (n, V)."""
    tokens = torch.as_tensor(tokens, device=ref_logits.device).long()
    served = ref_logits.gather(1, tokens[:, None])[:, 0]
    return ref_logits.max(dim=1).values - served


def logit_errors(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    prog = prog.float()
    return (prog - ref).norm(dim=1) / ref.norm(dim=1)


def worst(values) -> float:
    """The largest of ``values``; NaN where any is NaN."""
    values = [float(v) for v in values]
    return math.nan if any(v != v for v in values) else max(values)


def median_by_group(values: torch.Tensor, groups: torch.Tensor) -> dict:
    """The median of ``values`` within each group, by group; a NaN reading
    is the group's median."""
    values, groups = values.float().cpu(), groups.cpu()
    out = {}
    for g in groups.unique().tolist():
        v = values[groups == g]
        out[int(g)] = math.nan if v.isnan().any() else float(
            statistics.median(v.tolist()))
    return out
