"""Exact nearest-neighbor search over scenario embeddings (serve tier).

Port copy of :mod:`repro.serve.ann`; ``repro_torch`` imports nothing from
``repro``.

Above a corpus-size threshold the :class:`~repro_torch.serve.proxy_service.
ProxyService` distance stage stops materializing the full query ×
scenario distance matrix and queries a :class:`BallTree` instead.  The
tree is *exact*, not approximate: leaf distances use the same
``sqrt(((pts - q) ** 2).sum(axis=1))`` reduction as the brute-force
path, pruning keeps a slack margin wider than the float error of the
bound, and ties break to the lowest scenario index — so the answer is
pinned equal (index and distance bits) to :func:`brute_force_nearest`,
which stays as the parity oracle per the repo's oracle discipline
(``sequitur_reference``, ``frontend_reference``, ...).

Embeddings here are short unit-normalized vectors (a few dozen dims) and
corpora are 10²–10⁴ scenarios, squarely ball-tree territory; no external
ANN dependency, pure NumPy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_LEAF_SIZE = 8
#: pruning slack — absolute, orders of magnitude above the ~1e-16 float
#: error of the triangle-inequality bound on unit-scale embeddings, so a
#: subtree holding the true nearest (or an equal-distance lower-index
#: tie) is never pruned by rounding
_SLACK = 1e-9


def brute_force_nearest(points: np.ndarray, q: np.ndarray,
                        ) -> tuple[int, float]:
    """``(index, distance)`` of the nearest row of ``points`` to ``q`` —
    first index wins ties.  The parity oracle :class:`BallTree` is pinned
    against."""
    points = np.asarray(points, dtype=np.float64)
    if not len(points):
        raise ValueError("cannot search an empty point set")
    d = np.sqrt(((points - np.asarray(q, dtype=np.float64)) ** 2).sum(axis=1))
    i = int(np.argmin(d))
    return i, float(d[i])


@dataclasses.dataclass
class _Node:
    center: np.ndarray
    radius: float
    idx: np.ndarray | None          # leaf: row indices into the point set
    left: "_Node | None"
    right: "_Node | None"


class BallTree:
    """Exact ball tree over a fixed point set (max-spread median splits,
    stable order), queried one vector at a time for the single nearest
    row."""

    def __init__(self, points: np.ndarray, leaf_size: int = _LEAF_SIZE):
        self._pts = np.ascontiguousarray(points, dtype=np.float64)
        if self._pts.ndim != 2 or not len(self._pts):
            raise ValueError("BallTree needs a non-empty (n, d) point set")
        self._root = self._build(np.arange(len(self._pts), dtype=np.int64),
                                 max(int(leaf_size), 1))

    def __len__(self) -> int:
        return len(self._pts)

    def _build(self, idx: np.ndarray, leaf_size: int) -> _Node:
        pts = self._pts[idx]
        center = pts.mean(axis=0)
        radius = float(np.sqrt(((pts - center) ** 2).sum(axis=1)).max())
        if len(idx) <= leaf_size:
            return _Node(center, radius, idx, None, None)
        spread = pts.max(axis=0) - pts.min(axis=0)
        order = np.argsort(pts[:, int(np.argmax(spread))], kind="stable")
        mid = len(idx) // 2
        return _Node(center, radius, None,
                     self._build(idx[order[:mid]], leaf_size),
                     self._build(idx[order[mid:]], leaf_size))

    def query(self, q: np.ndarray) -> tuple[int, float]:
        """``(index, distance)`` of the exact nearest point — same answer
        (bits included) as :func:`brute_force_nearest`, lowest index on
        ties."""
        q = np.asarray(q, dtype=np.float64)
        best = [np.inf, -1]           # [distance, index]
        self._visit(self._root, q, best)
        return int(best[1]), float(best[0])

    def _visit(self, node: _Node, q: np.ndarray, best: list) -> None:
        bound = float(np.sqrt(((q - node.center) ** 2).sum())) - node.radius
        if bound - _SLACK > best[0]:
            return
        if node.idx is not None:
            d = np.sqrt(((self._pts[node.idx] - q) ** 2).sum(axis=1))
            dmin = d.min()
            cand = int(node.idx[d == dmin].min())
            if dmin < best[0] or (dmin == best[0] and cand < best[1]):
                best[0], best[1] = float(dmin), cand
            return
        # nearer child first: tightens ``best`` before the far subtree
        dl = ((q - node.left.center) ** 2).sum()
        dr = ((q - node.right.center) ** 2).sum()
        first, second = ((node.left, node.right) if dl <= dr
                         else (node.right, node.left))
        self._visit(first, q, best)
        self._visit(second, q, best)
