"""Event model for proxy-app traces.

Port copy of :mod:`repro.core.events`, kept line for line so both packages build
the same grammars and tables; ``repro_torch`` imports nothing from ``repro``.

The paper (§2.2-2.3) records two event kinds:
  * communication events -- MPI calls with full parameter info (lossless), with
    relative-rank encoding for point-to-point targets and canonicalized handles;
  * computation events   -- everything between two communication events,
    characterized by a 6-metric hardware-counter vector (virtual ``MPI_Compute``).

This module is the TPU/JAX re-founding: communication events are mesh
collectives (psum / all_gather / reduce_scatter / all_to_all / ppermute), and
computation events carry the 6-metric TPU cost vector of
:mod:`repro_torch.core.metrics`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Sequence

import numpy as np

# The 6 TPU performance metrics (the analog of the paper's Table 1).
# INS/CYC/LST/L1_DCM/BR_CN/MSP  ->  see DESIGN.md §2 for the mapping.
METRIC_NAMES: tuple[str, ...] = (
    "mxu_flops",        # MXU (dot/conv) floating point ops
    "vpu_elems",        # VPU elementwise/reduction element ops
    "hbm_bytes",        # fusion-agnostic memory traffic (operands + results)
    "transcendentals",  # exp/log/tanh/erf/... slow-path VPU ops
    "gather_elems",     # irregularly-addressed elements (gather/scatter/take)
    "scan_steps",       # sequential loop iterations (serialization hazard)
)
N_METRICS = len(METRIC_NAMES)

_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "uint64": 8, "complex64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "int4": 1, "uint4": 1,
}


def dtype_bytes(dtype: Any) -> int:
    """Payload bytes per element; unknown dtypes default to 4."""
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return _DTYPE_BYTES.get(name, 4)


# ---------------------------------------------------------------------------
# Communication events
# ---------------------------------------------------------------------------

#: collective kinds we record.  ``ppermute`` is the point-to-point analog
#: (MPI_Send/Recv); the rest are MPI collectives.
COMM_KINDS = (
    "psum", "all_gather", "reduce_scatter", "all_to_all", "ppermute",
    "pmax", "pmin", "broadcast",
)


def encode_relative_perm(perm: Sequence[tuple[int, int]], axis_size: int):
    """Relative-rank encoding of a ppermute permutation (paper §2.2, Fig. 2).

    If every (src, dst) pair satisfies ``dst - src ≡ k (mod axis_size)`` the
    whole permutation compresses to the single offset ``k`` plus the
    participation set (stored as a canonical mask tuple only when not all
    ranks participate).  Otherwise the sorted pair tuple is kept verbatim
    (still lossless).
    """
    if not perm:
        return ("empty",)
    offsets = {(dst - src) % axis_size for src, dst in perm}
    srcs = sorted(src for src, _ in perm)
    full = len(perm) == axis_size and srcs == list(range(axis_size))
    if len(offsets) == 1:
        off = offsets.pop()
        if full:
            return ("shift", off)
        # partial participation: mask of source ranks (boundary effects --
        # the non-periodic stencil case of paper Fig. 2).
        return ("shift", off, tuple(srcs))
    return ("perm", tuple(sorted((s, d) for s, d in perm)))


def decode_relative_perm(detail: tuple, axis_size: int) -> list[tuple[int, int]]:
    """Inverse of :func:`encode_relative_perm` (losslessness guarantee)."""
    tag = detail[0]
    if tag == "empty":
        return []
    if tag == "shift":
        off = detail[1]
        srcs = detail[2] if len(detail) > 2 else range(axis_size)
        return [(s, (s + off) % axis_size) for s in srcs]
    return [tuple(p) for p in detail[1]]


@dataclasses.dataclass(frozen=True)
class CommEvent:
    """A lossless record of one collective (the MPI-call analog)."""
    kind: str                       # one of COMM_KINDS
    shape: tuple[int, ...]          # per-device payload shape
    dtype: str
    axes: tuple[str, ...]           # mesh axes the collective spans
    detail: tuple = ()              # e.g. relative-rank encoding for ppermute

    def __post_init__(self):
        if self.kind not in COMM_KINDS:
            raise ValueError(f"unknown collective kind {self.kind!r}")

    @property
    def payload_bytes(self) -> int:
        n = math.prod(self.shape) if self.shape else 1
        return n * dtype_bytes(self.dtype)

    def key(self) -> str:
        """Canonical string key (terminal-table identity, paper §2.5)."""
        return (f"C|{self.kind}|{'x'.join(map(str, self.shape))}|{self.dtype}"
                f"|{','.join(self.axes)}|{self.detail!r}")


# ---------------------------------------------------------------------------
# Computation events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ComputeEvent:
    """A virtual ``MPI_Compute`` call: the 6-metric cost of one compute span."""
    metrics: tuple[float, ...]      # aligned with METRIC_NAMES
    cluster_id: int = -1            # assigned by cluster_compute_events

    def __post_init__(self):
        if len(self.metrics) != N_METRICS:
            raise ValueError(f"expected {N_METRICS} metrics")

    @property
    def vector(self) -> np.ndarray:
        return np.asarray(self.metrics, dtype=np.float64)

    def key(self) -> str:
        if self.cluster_id >= 0:
            return f"X|{self.cluster_id}"
        return "X|" + "|".join(f"{m:.6g}" for m in self.metrics)


Event = Any  # CommEvent | ComputeEvent


def is_comm(ev: Event) -> bool:
    return isinstance(ev, CommEvent)


def is_compute(ev: Event) -> bool:
    return isinstance(ev, ComputeEvent)


# ---------------------------------------------------------------------------
# Computation-event clustering (paper §2.3: "we set a threshold to cluster
# similar computation events into one event")
# ---------------------------------------------------------------------------


def quantize_metrics(metrics: np.ndarray, rel_tol: float = 0.05,
                     ) -> np.ndarray:
    """Log-space quantization keys, ``(n, N_METRICS)`` int64.

    Each element quantizes to ``floor(log(v + 1) / log1p(rel_tol))``
    (``-1`` for non-positive metrics).  Pass 1 of the clustering; also the
    bucket identity the incremental :class:`repro.core.corpus_store.
    ClusterIndex` matches newly ingested events against.
    """
    metrics = np.asarray(metrics, dtype=np.float64)
    if metrics.ndim != 2 or metrics.shape[1] != N_METRICS:
        raise ValueError(f"expected (n, {N_METRICS}) metrics array")
    width = math.log1p(rel_tol)
    q = np.full(metrics.shape, -1, dtype=np.int64)
    pos = metrics > 0
    # np.log is assumed to agree with the scalar libm log the per-event
    # original used — true on every platform we run, and pinned per
    # platform by the frontend_reference parity tests (a 1-ULP divergence
    # at a bucket boundary would fail them loudly, not silently)
    q[pos] = np.floor(np.log(metrics[pos] + 1.0) / width).astype(np.int64)
    return q


def bucketize_keys(q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Number quantization keys by first appearance in stream order.

    Returns ``(bucket_ids, uniq_keys)`` where ``uniq_keys[b]`` is the key
    of bucket ``b`` (buckets ordered by first appearance — the order the
    greedy merge pass consumes them in).
    """
    uq, first, inv = np.unique(q, axis=0, return_index=True,
                               return_inverse=True)
    inv = inv.reshape(-1)   # some numpy versions return (n, 1) for axis=0
    order = np.argsort(first, kind="stable")   # buckets by first appearance
    bucket_of = np.empty(len(uq), dtype=np.int64)
    bucket_of[order] = np.arange(len(uq))
    return bucket_of[inv], uq[order]


def merge_buckets(sums: np.ndarray, counts: np.ndarray,
                  rel_tol: float = 0.05,
                  ) -> tuple[np.ndarray, dict[int, np.ndarray]]:
    """Greedy merge of buckets whose mean vectors agree within ``rel_tol``
    on every metric, in bucket-id order — so near-identical events
    straddling a bucket boundary still unify (the paper's "threshold to
    cluster similar computation events").

    Pass 2 of the clustering, O(n_buckets²·6) — independent of trace
    length, which is what lets the incremental corpus index re-derive
    cluster representatives from its running bucket table without ever
    re-touching event data.  Returns ``(remap, reps)``: the bucket→cluster
    map and the weighted-mean representative per cluster.
    """
    n_buckets = len(counts)
    remap = np.empty(n_buckets, dtype=np.int64)
    cluster_reps: list[np.ndarray] = []
    cluster_w: list[int] = []
    for b in range(n_buckets):
        v = sums[b] / counts[b]
        placed = False
        for cid, rep in enumerate(cluster_reps):
            denom = np.maximum(np.maximum(np.abs(rep), np.abs(v)), 1e-30)
            if np.all(np.abs(rep - v) / denom <= rel_tol):
                w = cluster_w[cid]
                cluster_reps[cid] = (rep * w + v * counts[b]) / (w + counts[b])
                cluster_w[cid] = w + counts[b]
                remap[b] = cid
                placed = True
                break
        if not placed:
            remap[b] = len(cluster_reps)
            cluster_reps.append(np.array(v, dtype=np.float64, copy=True))
            cluster_w.append(int(counts[b]))
    reps = {cid: rep for cid, rep in enumerate(cluster_reps)}
    return remap, reps


def cluster_vectors(metrics: np.ndarray, rel_tol: float = 0.05,
                    ) -> tuple[np.ndarray, dict[int, np.ndarray]]:
    """Columnar clustering of 6-metric vectors: the vectorized hot path.

    ``metrics`` is ``(n_events, N_METRICS)`` float64.  Two passes, both
    deterministic in stream order:

    1. log-space bucketing (:func:`quantize_metrics` +
       :func:`bucketize_keys`) — buckets are numbered by first appearance,
       and per-bucket sums accumulate in stream order (``np.add.at`` is an
       unbuffered in-order accumulation, so the float64 addition order
       matches the per-event loop it replaced bit for bit);
    2. the greedy bucket merge (:func:`merge_buckets`).

    Returns ``(cluster_ids, reps)``: one cluster id per input row and the
    weighted-mean representative vector per cluster.
    """
    metrics = np.asarray(metrics, dtype=np.float64)
    if metrics.ndim != 2 or metrics.shape[1] != N_METRICS:
        raise ValueError(f"expected (n, {N_METRICS}) metrics array")
    n = metrics.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64), {}

    bucket_ids, uq = bucketize_keys(quantize_metrics(metrics, rel_tol))
    n_buckets = len(uq)
    sums = np.zeros((n_buckets, N_METRICS), dtype=np.float64)
    np.add.at(sums, bucket_ids, metrics)
    counts = np.bincount(bucket_ids, minlength=n_buckets)

    remap, reps = merge_buckets(sums, counts, rel_tol)
    return remap[bucket_ids], reps


def scenario_bucket_table(metrics: np.ndarray, rel_tol: float = 0.05,
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """Pass-1 bucket table of ONE scenario: ``(keys, psums, counts,
    local_ids)``.

    ``keys`` are the scenario's distinct quantization keys in
    first-appearance order, ``psums[b]`` the float64 sum of bucket ``b``'s
    rows accumulated *in the scenario's own event order* (``np.add.at``),
    ``counts[b]`` its row count, and ``local_ids`` the per-row bucket id.

    The partial sums are label-invariant — each bucket's value is the
    in-order sum of its own rows, regardless of how buckets are numbered —
    which is what lets :func:`combine_bucket_tables` renumber and refold
    them under corpus append *and* removal without re-touching event data.
    """
    metrics = np.asarray(metrics, dtype=np.float64)
    if metrics.ndim != 2 or metrics.shape[1] != N_METRICS:
        raise ValueError(f"expected (n, {N_METRICS}) metrics array")
    if metrics.shape[0] == 0:
        return (np.zeros((0, N_METRICS), dtype=np.int64),
                np.zeros((0, N_METRICS), dtype=np.float64),
                np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    local_ids, uniq = bucketize_keys(quantize_metrics(metrics, rel_tol))
    psums = np.zeros((len(uniq), N_METRICS), dtype=np.float64)
    np.add.at(psums, local_ids, metrics)
    counts = np.bincount(local_ids, minlength=len(uniq)).astype(np.int64)
    return uniq, psums, counts, local_ids


def combine_bucket_tables(tables: Sequence[tuple], rel_tol: float = 0.05,
                          return_state: bool = False):
    """Fold per-scenario bucket tables (list order = manifest order) into
    the joint corpus clustering: ``(per-scenario cluster_ids, reps)``.

    Global buckets are numbered by first appearance across the tables —
    identical to the numbering ``bucketize_keys`` would assign over the
    concatenated event stream, because each scenario's local buckets are
    already in first-appearance order.  Each global bucket's float64 sum
    is the **ordered sum of per-scenario partial sums**: for a bucket
    touched by scenarios ``s1 < s2 < …`` the total is
    ``(psum_s1 + psum_s2) + …``, folded left-to-right in list order.

    This is *the* corpus clustering semantics (see
    :class:`repro.core.corpus_store.ClusterIndex`): a pure function of the
    ordered scenario list, exactly incremental under append (a new table
    folds in last), and sublinear under removal (drop a table, renumber,
    refold — no event data touched).  For a single table it is
    bit-identical to :func:`cluster_vectors`; for several it differs from
    event-order accumulation over the concatenation only in the float
    association at scenario boundaries (``(Σa + b1) + b2`` vs
    ``Σa + (b1 + b2)``) — the documented invariant change that bought
    O(remaining) removal.

    ``return_state=True`` additionally returns the derivation internals
    ``{"by_key", "remap", "reps", "n_buckets"}`` (key bytes → global
    bucket id, bucket → cluster remap) so the corpus index can answer
    nearest-cluster lookups without re-deriving.
    """
    by_key: dict[bytes, int] = {}
    gids_per: list[np.ndarray] = []
    for keys, _psums, _counts, _ids in tables:
        g = np.empty(len(keys), dtype=np.int64)
        for j, k in enumerate(np.ascontiguousarray(keys, dtype=np.int64)):
            kb = k.tobytes()
            gid = by_key.get(kb)
            if gid is None:
                gid = len(by_key)
                by_key[kb] = gid
            g[j] = gid
        gids_per.append(g)
    n_buckets = len(by_key)
    sums = np.zeros((n_buckets, N_METRICS), dtype=np.float64)
    counts = np.zeros(n_buckets, dtype=np.int64)
    for (_keys, psums, pcounts, _ids), g in zip(tables, gids_per):
        # one partial per (scenario, bucket): fancy += folds this
        # scenario's partials onto the running sums in list order
        sums[g] += psums
        counts[g] += pcounts
    if n_buckets == 0:
        remap, reps = np.zeros(0, dtype=np.int64), {}
    else:
        remap, reps = merge_buckets(sums, counts, rel_tol)
    ids_list = [remap[g[ids]] if len(ids) else np.zeros(0, dtype=np.int64)
                for (_k, _p, _c, ids), g in zip(tables, gids_per)]
    if return_state:
        return ids_list, reps, {"by_key": by_key, "remap": remap,
                                "reps": reps, "n_buckets": n_buckets}
    return ids_list, reps


def cluster_corpus(metrics_list: Sequence[np.ndarray],
                   rel_tol: float = 0.05,
                   ) -> tuple[list[np.ndarray], dict[int, np.ndarray]]:
    """Joint clustering of several scenarios' metric arrays, in order —
    the batch-path twin of the streaming
    :class:`repro.core.corpus_store.ClusterIndex` (both build on
    :func:`scenario_bucket_table` + :func:`combine_bucket_tables`, so the
    two stay bit-identical by construction)."""
    tables = [scenario_bucket_table(m, rel_tol) for m in metrics_list]
    return combine_bucket_tables(tables, rel_tol)


def cluster_compute_events(
    events: Iterable[ComputeEvent], rel_tol: float = 0.05
) -> tuple[list[ComputeEvent], dict[int, np.ndarray]]:
    """Assign cluster ids; each cluster's representative vector is the mean.

    Event-list front-end over :func:`cluster_vectors` (the columnar trace
    IR path in :mod:`repro_torch.core.trace_ir` calls it directly on the stored
    metrics array and never materializes events).
    """
    events = list(events)
    if not events:
        return [], {}
    metrics = np.stack([ev.vector for ev in events])
    cids, reps = cluster_vectors(metrics, rel_tol)
    out = [dataclasses.replace(ev, cluster_id=int(c))
           for ev, c in zip(events, cids)]
    return out, reps
