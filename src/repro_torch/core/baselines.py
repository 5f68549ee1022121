"""Baseline proxy synthesizers the paper compares against (§3.4-3.5).

Port of :mod:`repro.core.baselines` (numpy, on the port's
``blocks.combo_cost``/``calibration_matrix`` and ``metrics``' roofline
constants, which are the H100's: see :mod:`repro_torch.core.metrics`), and
the rows of the paper's comparisons that the reference computes in
``benchmarks/minime_compare.py`` (Figs. 5-6: :func:`fig56_rows`) and
``benchmarks/compression_table.py`` (Table 3: :func:`table3_row`).

* :func:`minime_fit` — MINIME-style iterative greedy block matching
  [Deniz et al. 2015].  MINIME targets ratio metrics (IPC, cache-miss rate,
  branch-misprediction rate); the accelerator analogs here are arithmetic
  intensity, gather rate and serialization rate.  Greedy chunked addition,
  no global optimization — the paper's Figs. 5-6 show (and
  :func:`fig56_rows` reproduces) that it fits a single aggregate event
  acceptably but drifts when every inter-collective segment must be
  matched separately.

* :class:`ScalaBenchProxy` — ScalaBench-style lossy compression [Wu et al.
  2012]: communication parameters are approximated by per-kind log2
  histograms (replay draws the bucket mean), computation is recorded as a
  *time interval* and replayed by sleeping — so its replay cannot track
  platform changes (paper §3.5.4, Figs. 9-11).
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Sequence

import numpy as np

from repro_torch.core import blocks as B
from repro_torch.core import metrics
from repro_torch.core.events import CommEvent, Event, is_comm
from repro_torch.core.metrics import (
    I_BYTES, I_GATHER, I_MXU, I_SCAN, I_VPU,
)

# ---------------------------------------------------------------------------
# MINIME-style greedy
# ---------------------------------------------------------------------------


def minime_ratios(vec: np.ndarray) -> np.ndarray:
    """MINIME's 3 ratio metrics, accelerator-adapted: (AI, gather rate,
    scan rate)."""
    ops = vec[I_MXU] + vec[I_VPU]
    return np.array([
        ops / max(vec[I_BYTES], 1.0),            # IPC  -> arithmetic intensity
        vec[I_GATHER] / max(ops, 1.0),           # CMR  -> gather rate
        vec[I_SCAN] / max(ops, 1.0),             # BMR  -> serialization rate
    ])


def _ratio_err(x: np.ndarray, b: np.ndarray, t: np.ndarray) -> float:
    """Symmetric log-ratio error on MINIME's 3 ratios + total-ops size term
    (log form keeps the greedy landscape smooth far from the optimum)."""
    vec = b @ x
    rt, rv = minime_ratios(t), minime_ratios(vec)
    eps = 1e-9
    ratio_err = float(np.mean(np.abs(np.log((rv + eps) / (rt + eps)))))
    ops_t = t[I_MXU] + t[I_VPU]
    ops_v = vec[I_MXU] + vec[I_VPU]
    size_err = abs(np.log((ops_v + 1.0) / (ops_t + 1.0)))
    return ratio_err + size_err


@dataclasses.dataclass
class GreedyFit:
    x: np.ndarray
    predicted: np.ndarray
    target: np.ndarray
    per_metric_rel_err: np.ndarray
    iters: int


def minime_fit(t: np.ndarray, b: np.ndarray | None = None,
               max_iter: int = 4000) -> GreedyFit:
    """Iterative greedy: repeatedly add the chunk of one block that most
    reduces the ratio+size error; halve the chunk when stuck; stop when the
    unit chunk no longer improves (MINIME's iterative code-block addition)."""
    t = np.asarray(t, dtype=np.float64)
    if b is None:
        b = B.calibration_matrix()
    n = b.shape[1]
    x = np.zeros(n)
    chunk = 1 << 16
    err = _ratio_err(x, b, t)
    ops_t = t[I_MXU] + t[I_VPU]
    it = 0
    while it < max_iter and chunk >= 1:
        best_j, best_err = -1, err
        for j in range(n):
            x[j] += chunk
            vec = b @ x
            # additions are irreversible: never overshoot the size budget
            if vec[I_MXU] + vec[I_VPU] > 1.2 * max(ops_t, 1.0):
                x[j] -= chunk
                continue
            e = _ratio_err(x, b, t)
            x[j] -= chunk
            if e < best_err - 1e-15:
                best_err, best_j = e, j
        if best_j < 0:
            chunk //= 2
            continue
        x[best_j] += chunk
        err = best_err
        it += 1
    x = np.rint(x).astype(np.int64)
    x[10] = max(x[10], int(np.sum(x[:9])))  # keep replayable
    pred = b @ x
    rel = np.abs(pred - t) / np.maximum(np.abs(t), 1e-30)
    rel = np.where(t > 0, rel, 0.0)
    return GreedyFit(x=x, predicted=pred, target=t,
                     per_metric_rel_err=rel, iters=it)


# ---------------------------------------------------------------------------
# ScalaBench-style histogram + sleep proxy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScalaBenchProxy:
    """Lossy comm histogram + fixed sleep compute replay."""
    op_sequence: list[tuple[str, int]]       # (kind, histogram bucket) per event
    bucket_means: dict[tuple[str, int], float]  # mean payload bytes per bucket
    sleep_seconds: list[float]               # per compute event, recorded on A
    n_ranks: int

    def replayed_comm_bytes(self) -> float:
        return sum(self.bucket_means[(k, bk)] for k, bk in self.op_sequence)

    def predicted_time(self, flops_rate_scale: float = 1.0,
                       n_devices: int = 2) -> float:
        """Replay wall time on a platform whose compute speed differs by
        ``flops_rate_scale`` from the recording platform: the sleeps do NOT
        scale (that is the point), only communication does."""
        t = sum(self.sleep_seconds)
        t += sum(metrics.comm_seconds(self.bucket_means[(k, bk)], n_devices)
                 for k, bk in self.op_sequence)
        return t


def _bucket(nbytes: int) -> int:
    return int(math.log2(max(nbytes, 1)))


def scalabench_compress(rank_trace: Sequence[Event], n_ranks: int = 1,
                        ) -> ScalaBenchProxy:
    sums: dict[tuple[str, int], float] = defaultdict(float)
    counts: dict[tuple[str, int], int] = defaultdict(int)
    op_seq: list[tuple[str, int]] = []
    sleeps: list[float] = []
    for ev in rank_trace:
        if is_comm(ev):
            key = (ev.kind, _bucket(ev.payload_bytes))
            sums[key] += ev.payload_bytes
            counts[key] += 1
            op_seq.append(key)
        else:
            sleeps.append(metrics.roofline_seconds(ev.vector))
    means = {k: sums[k] / counts[k] for k in sums}
    return ScalaBenchProxy(op_sequence=op_seq, bucket_means=means,
                           sleep_seconds=sleeps, n_ranks=n_ranks)


def siesta_predicted_time(combos: Sequence[tuple],
                          comm_events: Sequence[CommEvent],
                          flops_rate_scale: float = 1.0,
                          n_devices: int = 2) -> float:
    """Siesta replay time on a scaled platform: the block mixes re-execute,
    so compute time scales with the platform (paper §3.5.4 portability).

    ``combos``: (x, unroll) pairs as produced by synthesize."""
    t = 0.0
    for x, unroll in combos:
        vec = B.combo_cost(x, unroll)
        t += metrics.roofline_seconds(vec) / flops_rate_scale
    t += sum(metrics.comm_seconds(ev.payload_bytes, n_devices) for ev in comm_events)
    return t


def original_time(rank_trace: Sequence[Event], flops_rate_scale: float = 1.0,
                  n_devices: int = 2) -> float:
    t = 0.0
    for ev in rank_trace:
        if is_comm(ev):
            t += metrics.comm_seconds(ev.payload_bytes, n_devices)
        else:
            t += metrics.roofline_seconds(ev.vector) / flops_rate_scale
    return t


# ---------------------------------------------------------------------------
# the paper's comparison rows (benchmarks/minime_compare.py and
# benchmarks/compression_table.py of the reference)
# ---------------------------------------------------------------------------


def _mean_err(rel: np.ndarray, t: np.ndarray) -> float:
    return float(np.mean(rel[t > 0]))


def fig56_rows(program: str, vecs: Sequence[np.ndarray]) -> list[dict]:
    """Paper Figs. 5-6 on one program's compute events: Siesta's QP fit
    (``proxy_search.fit_combination``) against :func:`minime_fit`, as one
    aggregate event (Fig. 5, ``single_block``) and as a fit of every event
    summed (Fig. 6, ``per_event_sum``); each error the mean relative error
    over the aggregate's nonzero metrics (unrounded)."""
    from repro_torch.core.proxy_search import fit_combination, rel_error
    agg = np.sum(np.asarray(vecs, dtype=np.float64), axis=0)
    q, g = fit_combination(agg), minime_fit(agg)
    rows = [{"program": program, "mode": "single_block",
             "siesta_err": _mean_err(q.per_metric_rel_err, agg),
             "minime_err": _mean_err(g.per_metric_rel_err, agg)}]
    tq, tg = np.zeros(len(agg)), np.zeros(len(agg))
    for v in vecs:
        tq += fit_combination(v).predicted
        tg += minime_fit(v).predicted
    rows.append({"program": program, "mode": "per_event_sum",
                 "siesta_err": _mean_err(rel_error(agg, tq), agg),
                 "minime_err": _mean_err(rel_error(agg, tg), agg)})
    return rows


def table3_row(program: str, n_ranks: int, res, synth_sec: float) -> dict:
    """Paper Table 3: one program at ``n_ranks`` — events, trace and
    grammar bytes, compression ratio, ``synthesize`` seconds, δ̄ and comm
    losslessness of a :class:`~repro_torch.core.synthesize.SynthesisResult`
    (unrounded)."""
    fid = res.fidelity()
    return {"program": program, "ranks": n_ranks,
            "events": res.stats["n_events"],
            "trace_bytes": res.stats["trace_bytes"],
            "grammar_bytes": res.stats["grammar_bytes"],
            "ratio": res.stats["compression_ratio"],
            "synth_sec": synth_sec, "rel_err": fid.mean,
            "lossless_comm": bool(fid.comm_lossless)}
