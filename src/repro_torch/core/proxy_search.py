"""Computation-proxy search (paper §2.4).

Problem (paper eq. 6-7 plus the loop-coupling constraint):

    min_x  f(x) = sum_i (1/t_i^2) (b_i . x - t_i)^2
    s.t.   x >= 0,      x_11 >= sum_{i=1..9} x_i

Exact reduction to NNLS: substitute x_11 = sum_{i=1..9} x_i + s with slack
s >= 0.  In the substituted basis y = (x_1..x_9, x_10, s) the columns become

    col'_i = col_i + col_11   (i = 1..9)     # each block turn also costs a loop turn
    col'_10 = col_10
    col'_s  = col_11

and the problem is a plain weighted non-negative least squares — which is
also the *physical* cost structure of the replay code (see blocks.py), so
the substitution is not merely algebraic convenience.

Two solvers:
  * :func:`fit_combination` — scipy NNLS (exact active-set), then integer
    rounding with constraint repair (paper: "rounded approximation at the end").
  * :func:`fit_batch_pgd` — projected gradient descent batched over many
    target vectors at once: all cluster representatives of a trace are
    fitted in one device program (beyond-paper optimization; the paper fits
    each event separately on host).

Port of :mod:`repro.core.proxy_search`: NNLS, integer refinement and the
unroll grid are the reference's code; the PGD solver is a batched torch
program on ``device`` (``None`` means the CUDA card).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import blocks as B
from repro_torch.device import resolve_device
from repro_torch.core.events import METRIC_NAMES

_EPS = 1e-30


@dataclasses.dataclass
class FitResult:
    x: np.ndarray                 # integer loop-turn counts, len 11
    predicted: np.ndarray         # combo cost at (x, unroll)
    target: np.ndarray
    residual: float               # weighted objective value at the solution
    per_metric_rel_err: np.ndarray
    unroll: int = 1               # block applications per loop turn

    def summary(self) -> str:
        rows = [f"  {n:>16s}: target={t:12.4g} proxy={p:12.4g} err={e:7.2%}"
                for n, t, p, e in zip(METRIC_NAMES, self.target,
                                      self.predicted, self.per_metric_rel_err)]
        return "\n".join(rows)


def _weights(t: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row weights 1/t_i (relative error, paper eq. 6).  A zero target metric
    gets a small finite weight (vs. the mean block magnitude): the solver is
    softly discouraged from exciting metrics the target does not have, but
    unavoidable replay overhead (loop turns) must not crowd out real fits."""
    w = np.zeros_like(t)
    for i in range(len(t)):
        if t[i] > 0:
            w[i] = 1.0 / t[i]
        else:
            scale = float(np.mean(b[i, :9])) if np.any(b[i, :9] > 0) else 1.0
            w[i] = 0.01 / max(scale, _EPS)
    return w


def substituted_matrix(b: np.ndarray, unroll: int = 1) -> np.ndarray:
    """Map the 11-column block matrix to the substituted basis: one loop
    turn of block i = ``unroll`` applications + the turn overhead."""
    bs = b.copy()
    bs[:, :9] = b[:, :9] * unroll + b[:, 10:11]
    # col 9 (block10) unchanged; col 10 becomes the slack (pure loop turn)
    return bs


def _unsubstitute(y: np.ndarray) -> np.ndarray:
    x = y.copy()
    x[10] = float(np.sum(y[:9]) + y[10])
    return x


def _refine_integer(y: np.ndarray, a: np.ndarray, rhs: np.ndarray,
                    max_iter: int = 300) -> np.ndarray:
    """Greedy ±1 coordinate descent on the *integer* substituted solution.

    NNLS is exact over the reals, but block counts are integers (paper:
    "rounded approximation at the end") and naive rounding truncates
    sub-unit counts to zero when an event is smaller than one block
    application.  Steepest-descent unit moves recover the integer optimum
    in practice (objective is convex; the move set is the ±e_j lattice).
    """
    y = np.maximum(np.rint(y), 0).astype(np.int64)

    def obj(v):
        r = a @ v - rhs
        return float(r @ r)

    n = len(y)
    cur = obj(y)
    for _ in range(max_iter):
        best = None
        # single ±1 moves
        for j in range(n):
            for d in (1, -1):
                if y[j] + d < 0:
                    continue
                y[j] += d
                o = obj(y)
                y[j] -= d
                if o < cur - 1e-18 and (best is None or o < best[0]):
                    best = (o, ((j, d),))
        # paired swap moves (+1 on j, -1 on k): escapes block-substitution
        # local minima the axis moves cannot
        for j in range(n):
            for k in range(n):
                if j == k or y[k] < 1:
                    continue
                y[j] += 1
                y[k] -= 1
                o = obj(y)
                y[j] -= 1
                y[k] += 1
                if o < cur - 1e-18 and (best is None or o < best[0]):
                    best = (o, ((j, 1), (k, -1)))
        if best is None:
            break
        cur = best[0]
        for j, d in best[1]:
            y[j] += d
    return y


def _refine_integer_fast(y: np.ndarray, a: np.ndarray, rhs: np.ndarray,
                         max_iter: int = 300) -> np.ndarray:
    """Greedy ±1 / paired-swap descent with analytic objective deltas.

    Same move set as :func:`_refine_integer`, but the objective is
    quadratic, so every candidate move's exact Δobj comes from the
    gradient and Hessian in O(n²) vectorized ops instead of a full
    re-evaluation per move — the per-target polish of the batched-PGD
    path (:func:`fit_batch`), ~100× faster at the same move semantics.
    (:func:`fit_combination` keeps the original evaluator so the exact
    NNLS path stays bit-for-bit stable.)
    """
    y = np.maximum(np.rint(y), 0).astype(np.int64)
    n = len(y)
    h = a.T @ a
    hd = np.diag(h)
    g = a.T @ (a @ y.astype(np.float64) - rhs)
    jj, kk = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    for _ in range(max_iter):
        up = 2.0 * g + hd                       # +1 on j
        dn = np.where(y > 0, -2.0 * g + hd, np.inf)   # -1 on j
        # +1 on j, -1 on k (j != k, y_k >= 1)
        pair = (2.0 * (g[:, None] - g[None, :])
                + hd[:, None] + hd[None, :] - 2.0 * h)
        pair = np.where((jj != kk) & (y[None, :] > 0), pair, np.inf)
        cands = np.concatenate([up, dn, pair.reshape(-1)])
        i = int(np.argmin(cands))
        if not cands[i] < -1e-18:
            break
        if i < n:
            moves = ((i, 1),)
        elif i < 2 * n:
            moves = ((i - n, -1),)
        else:
            i -= 2 * n
            moves = ((i // n, 1), (i % n, -1))
        for j, d in moves:
            y[j] += d
            g = g + d * h[:, j]
    return y


_UNROLLS = (1, 8, 64, 512, 4096)


def _nnls_robust(a: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """NNLS that cannot fail: scipy's active-set solver with a generous
    iteration budget, falling back to bounded least squares when the
    weighted system is ill-conditioned enough to make it cycle (seen on
    tiny sub-block-sized targets).  The integer refinement downstream
    polishes either answer."""
    from scipy.optimize import lsq_linear, nnls

    try:
        try:
            y, _ = nnls(a, rhs, maxiter=max(30 * a.shape[1], 300))
        except TypeError:       # scipy < 1.12: no maxiter kwarg
            y, _ = nnls(a, rhs)
    except (RuntimeError, np.linalg.LinAlgError):
        # active-set cycling (RuntimeError) or a singular normal-equation
        # solve inside newer scipy's nnls (LinAlgError, seen on rank-
        # deficient weighted systems from large traced model steps)
        y = np.maximum(lsq_linear(a, rhs, bounds=(0.0, np.inf)).x, 0.0)
    return y


def fit_combination(t: np.ndarray, b: np.ndarray | None = None,
                    max_count: float = 2 ** 40) -> FitResult:
    """Exact weighted-NNLS fit + integer refinement with constraint repair.

    The loop-body unroll factor is searched over ``_UNROLLS``: large compute
    events need millions of block applications but only thousands of loop
    turns, so the turn count (= serialization metric) stays commensurate
    with the target's scan_steps (paper: multiple block instances share the
    block-11 loop body)."""
    t = np.asarray(t, dtype=np.float64)
    if b is None:
        b = B.calibration_matrix()
    w = _weights(t, b)
    best = None
    for u in _UNROLLS:
        bs = substituted_matrix(b, u)
        a = bs * w[:, None]
        rhs = t * w
        y = _nnls_robust(a, rhs)
        y = np.minimum(y, max_count)
        # integer projection in the substituted basis keeps coupling exact
        yi = _refine_integer(y, a, rhs)
        xi = np.zeros(len(yi), dtype=np.int64)
        xi[:10] = yi[:10]
        xi[10] = int(np.sum(yi[:9]) + yi[10])
        scaled = b.copy()
        scaled[:, :9] *= u
        pred = scaled @ xi
        res = float(np.sum((w * (pred - t)) ** 2))
        if best is None or res < best.residual - 1e-15:
            rel = np.abs(pred - t) / np.maximum(np.abs(t), _EPS)
            rel = np.where(t > 0, rel, np.abs(pred) * w * 10.0)
            best = FitResult(x=xi, predicted=pred, target=t, residual=res,
                             per_metric_rel_err=rel, unroll=u)
    return best


def fit_batch(targets: np.ndarray,
              b: np.ndarray | None = None,
              unrolls: Sequence[int] = _UNROLLS,
              iters: int = 400, device=None) -> list[FitResult]:
    """Fit every target row in **one** batched-PGD device program.

    The single-dispatch path behind ``synthesize(solver="pgd")`` and the
    corpus pipeline.  Like :func:`fit_combination`, the unroll factor is
    searched — but on device: the ``(n_targets × n_unrolls)`` grid solves
    in one batched program, then the best integer solution per
    target is picked by the same weighted objective, so large compute
    events get thousands of loop turns instead of millions (keeping the
    scan_steps metric commensurate with the target's)."""
    targets = np.atleast_2d(np.asarray(targets, dtype=np.float64))
    n = targets.shape[0]
    if n == 0:
        return []
    if b is None:
        b = B.calibration_matrix()
    unrolls = tuple(unrolls)
    bss = np.stack([substituted_matrix(b, u) for u in unrolls])
    grid_t = np.repeat(targets, len(unrolls), axis=0)
    grid_b = np.tile(bss, (n, 1, 1))
    ys = _pgd_grid(grid_t, grid_b, iters, device).reshape(
        n, len(unrolls), -1)

    out = []
    for i, t in enumerate(targets):
        w = _weights(t, b)
        rhs = t * w
        best = None
        for j, u in enumerate(unrolls):
            # same integer projection idea as fit_combination — greedy ±1
            # descent in the substituted basis rescues sub-block-sized
            # targets whose real-valued solution rounds to zero — but with
            # analytic move deltas (one quadratic, exact)
            a = bss[j] * w[:, None]
            yi = _refine_integer_fast(ys[i, j], a, rhs)
            xi = np.zeros(len(yi), dtype=np.int64)
            xi[:10] = yi[:10]
            xi[10] = int(np.sum(yi[:9]) + yi[10])
            scaled = b.copy()
            scaled[:, :9] *= u
            pred = scaled @ xi
            res = float(np.sum((w * (pred - t)) ** 2))
            if best is None or res < best.residual - 1e-15:
                # zero-target metrics get the same soft error treatment as
                # fit_combination (raw rel_error would divide by ~1e-30)
                rel = rel_error(t, pred)
                rel = np.where(t > 0, rel, np.abs(pred) * w * 10.0)
                best = FitResult(x=xi, predicted=pred, target=t,
                                 residual=res, per_metric_rel_err=rel,
                                 unroll=u)
        out.append(best)
    return out


# ---------------------------------------------------------------------------
# solver selection
# ---------------------------------------------------------------------------

#: Above this many distinct compute terminals the batched PGD solver is the
#: default: one batched device program beats that many sequential active-set
#: solves by orders of magnitude, and per-target accuracy differences wash
#: out in δ̄ at that scale.  At or below it, exact NNLS (+ integer
#: refinement + unroll search) wins on per-fit accuracy and is still cheap.
PGD_TERMINAL_THRESHOLD = 32


def choose_solver(n_targets: int, solver: str = "auto") -> str:
    """Resolve the block-combination solver for ``n_targets`` compute
    terminals: ``"auto"`` picks ``"pgd"`` above
    :data:`PGD_TERMINAL_THRESHOLD`, ``"nnls"`` otherwise; explicit names
    pass through unchanged."""
    if solver != "auto":
        return solver
    return "pgd" if n_targets > PGD_TERMINAL_THRESHOLD else "nnls"


# ---------------------------------------------------------------------------
# batched PGD solver: one torch program on the device
# ---------------------------------------------------------------------------


def _pgd_grid(targets: np.ndarray, bss: np.ndarray, iters: int = 400,
              device=None) -> np.ndarray:
    """Batched projected-gradient NNLS over (target, substituted-matrix)
    pairs, in float32 like the reference's jitted solver.

    ``targets`` is ``(n, 6)``, ``bss`` the matching ``(n, 6, 11)``
    substituted block matrices (rows may repeat a matrix, e.g. the unroll
    grid).  Every row solves in the same batched tensor ops on ``device``
    (``None`` means the CUDA card).  Returns the real-valued substituted
    solutions ``(n, 11)``."""
    dev = resolve_device(device)
    t = torch.from_numpy(np.array(targets, dtype=np.float32)).to(dev)
    bs = torch.from_numpy(np.array(bss, dtype=np.float32)).to(dev)
    n_cols = bs.shape[-1]
    w = torch.where(t > 0, 1.0 / torch.clamp(t, min=_EPS),
                    0.1 / torch.clamp(bs[:, :, :9].mean(dim=-1), min=_EPS))
    a = bs * w[:, :, None]
    rhs = t * w
    at = a.transpose(1, 2)
    ata = at @ a                                   # (n, 11, 11)
    atb = (at @ rhs[:, :, None])[..., 0]           # (n, 11)
    # Lipschitz constant via 20 power-iteration steps
    v = torch.full((t.shape[0], n_cols), 1.0 / np.sqrt(n_cols),
                   dtype=torch.float32, device=dev)
    for _ in range(20):
        v = (ata @ v[:, :, None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=_EPS)
    lip = torch.clamp(((v[:, None, :] @ ata)[:, 0, :] * v).sum(dim=-1),
                      min=_EPS)
    eta = (1.0 / lip)[:, None]
    y = torch.zeros_like(atb)
    for _ in range(int(iters)):
        g = (ata @ y[:, :, None])[..., 0] - atb
        y = torch.clamp(y - eta * g, min=0.0)
    return y.cpu().numpy().astype(np.float64)


def fit_batch_pgd(targets: np.ndarray, b: np.ndarray | None = None,
                  iters: int = 400, device=None) -> np.ndarray:
    """Batched projected-gradient NNLS on the device.

    targets: (n, 6) array of metric vectors. Returns (n, 11) integer counts.
    Objective per row matches :func:`fit_combination` at ``unroll=1``."""
    if b is None:
        b = B.calibration_matrix()
    targets = np.atleast_2d(np.asarray(targets, dtype=np.float64))
    bs = substituted_matrix(b)
    ys = _pgd_grid(targets, np.broadcast_to(bs, (len(targets),) + bs.shape),
                   iters, device)
    xs = ys.copy()
    xs[:, 10] = np.sum(ys[:, :9], axis=1) + ys[:, 10]
    xi = np.maximum(np.rint(xs).astype(np.int64), 0)
    xi[:, 10] = np.maximum(xi[:, 10], np.sum(xi[:, :9], axis=1))
    return xi


def rel_error(t: np.ndarray, pred: np.ndarray) -> np.ndarray:
    t = np.asarray(t, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    return np.abs(pred - t) / np.maximum(np.abs(t), _EPS)


def rel_error_matrix(targets: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Batched δ matrix (paper eq. 8 numerator): ``|pred - t| / |t|`` over a
    (n_metrics, n_ranks) stack, with rows-by-column where the target metric
    is absent (t <= 0) defined as 0 — a metric the original never excites
    contributes no error.  Used by the vectorized fidelity path in
    :mod:`repro_torch.core.replay`."""
    targets = np.asarray(targets, dtype=np.float64)
    delta = rel_error(targets, preds)
    delta[targets <= 0] = 0.0
    return delta
