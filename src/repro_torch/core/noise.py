"""Calibrated noise models for variability-aware replay.

Port of :mod:`repro.core.noise`.  Calibration (:func:`calibrate`,
:class:`NoiseModel`), the per-terminal lowering (:func:`lower_params`), the
replay-facing config and the distribution summary
(:class:`FidelityDistribution`, :func:`parse_fidelity_csv`) are the
reference's numpy code, copied.  The seeded sampler is the port's own: a
counter-based draw in integer torch ops, where the reference splits
``jax.random`` threefry keys (bitwise equality with threefry is not a goal).

Cornebize & Legrand (arxiv 2102.07674) show that platform variability, not
model error, dominates MPI performance-prediction error.  The reference
answers with per-terminal multiplicative noise calibrated from the variance
already in a :class:`~repro_torch.core.trace_ir.TraceStore`: compute
terminals draw a mean-one lognormal factor whose σ is the log-magnitude
spread of the terminal's cluster; comm terminals draw a lognormal shifted
by the bandwidth floor :data:`COMM_SHIFT`:

    f = shift + (1 - shift) · exp(σ·z - σ²/2),   z ~ N(0, 1)

which has mean 1 and variance :func:`factor_variance`.  Calibrated params
land in generated modules as the ``NOISE_MODELS`` table beside
``TERMINALS`` and are lowered by both codegen flavors through
:func:`lower_params`/:func:`perturb`.

**The draw.**  A replica's stream is keyed by two 32-bit words that
:func:`replica_key` derives from ``(seed, group representative, replica)``
alone, never from placement or the replica count.  Draw ``i`` of a stream
hashes the key with the counter ``i`` (:func:`_mix32`, a 32-bit integer
finaliser, on int64 tensors whose products never overflow) into two
uniform words, and Box-Muller turns them into ``z``.  The key leaf of a
noise-attached state is ``(k0, k1, n)``: its words and the draws taken.

**Program order without a host sync.**  Every terminal occurrence, comm and
compute, consumes exactly one draw, in program order: :func:`perturb`
records the occurrence's lowered params on the state's :class:`NoiseTape`
(a host-side list; no device work and no sync a draw), and :func:`settle`
draws the whole tape at once (counters ``n .. n + len - 1``) and adds
``Σ f·cost`` and ``Σ f·bytes`` to the accumulators :data:`NOISE_COMPUTE` and
:data:`NOISE_COMM` in float64.  The same tape gives the same bits, so both
codegen flavors, whose tapes are equal occurrence for occurrence, give the
same distribution.  ``ProxyProgram`` settles after each noisy replay.

Noise is off by default: with no noise key in the replay state,
:func:`perturb` returns the state as it is, so ``noise=None`` replay runs
exactly the deterministic program (no draw, no launch).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.events import (CommEvent, METRIC_NAMES, N_METRICS,
                                     cluster_vectors)

# State-dict keys for the noise leaves threaded through replay.  Plain
# dict-key presence (not a flag) is the gate: every loop in progtable
# carries the whole state dict, so the key leaf threads through for free.
NOISE_KEY = "_noise_key"
NOISE_COMPUTE = "_noise_compute"
NOISE_COMM = "_noise_comm"

#: σ floor applied to every calibrated terminal.  Cornebize & Legrand
#: measure ≥1-2% run-to-run variability even on quiesced clusters, so a
#: terminal whose cluster happens to be variance-free in the trace still
#: perturbs at this floor instead of degenerating to a point mass.
SIGMA_FLOOR = 0.01

#: Deterministic fraction of a collective's cost (bandwidth floor).
#: Only ``1 - COMM_SHIFT`` of a comm terminal's payload fluctuates.
COMM_SHIFT = 0.8

#: occurrences drawn at once by :func:`settle` (bounds its temporaries)
SETTLE_CHUNK = 1 << 15


# ---------------------------------------------------------------------------
# Sampling + lowering (shared by both codegen flavors)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and ``c`` <
    2^32, with no product above 2^49 (no int64 overflow on any device)."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xorshift-multiply, the "lowbias32"
    constants) on int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(key: torch.Tensor, counter: torch.Tensor, lane: int
             ) -> torch.Tensor:
    """A uniform float64 in (0, 1) from 32 hashed bits of (key words,
    counter, lane)."""
    w = _mix32(_mix32(((2 * counter + lane) & _M32) ^ key[..., 0:1])
               ^ key[..., 1:2])
    return (w.double() + 0.5) * 2.0 ** -32


def sample_factor(key: torch.Tensor, counter: torch.Tensor, sigma, shift
                  ) -> torch.Tensor:
    """Mean-one noise factors ``shift + (1-shift)·exp(σ·z - σ²/2)``, float64.

    ``key`` is a stream key (..., 3) (its first two words are used),
    ``counter`` the draw indices (..., n) (int64, below 2^31); ``sigma``
    and ``shift`` floats or tensors broadcasting against (..., n).  Draw
    ``i`` of a stream depends on its key and ``i`` alone."""
    u1 = _uniform(key, counter, 0)
    u2 = _uniform(key, counter, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    sigma = torch.as_tensor(sigma, dtype=torch.float64, device=z.device)
    shift = torch.as_tensor(shift, dtype=torch.float64, device=z.device)
    return shift + (1.0 - shift) * torch.exp(sigma * z - sigma * sigma * 0.5)


def factor_variance(sigma: float, shift: float) -> float:
    """Closed-form variance of :func:`sample_factor` draws."""
    return (1.0 - shift) ** 2 * (math.exp(sigma * sigma) - 1.0)


@dataclasses.dataclass(frozen=True)
class LoweredNoise:
    """One terminal's noise params bound to its deterministic cost.

    ``cost`` is the terminal's 6-metric compute cost vector (None for
    comm terminals); ``comm_bytes`` its collective payload (0.0 for
    compute terminals).  :func:`perturb` adds ``factor · cost`` /
    ``factor · comm_bytes`` to the state accumulators.
    """
    sigma: float
    shift: float
    cost: tuple | None
    comm_bytes: float


def _desc_cost(desc) -> tuple[tuple | None, float]:
    """(cost_vec, comm_bytes) from one terminal descriptor.

    Accepts both the table flavor's ``TERMINALS`` entries —
    ``('comm', buf, params)`` / ``('compute', x, unroll)`` — and the
    unrolled flavor's compact ``_NOISE_DESCS`` form ``('comm', bytes)``.
    """
    kind = desc[0]
    if kind == "compute":
        # lazy: calibration never lowers costs, so it needs no blocks
        from repro_torch.core import blocks
        _, x, unroll = desc
        vec = blocks.combo_cost(np.asarray(x, dtype=np.float64), int(unroll))
        return tuple(float(v) for v in vec), 0.0
    if kind != "comm":
        raise ValueError(f"unknown terminal descriptor kind {kind!r}")
    if len(desc) == 2:                      # ('comm', payload_bytes)
        return None, float(desc[1])
    _, _buf, params = desc                  # table flavor descriptor
    ev = CommEvent(kind=params["kind"], shape=tuple(params["shape"]),
                   dtype=params["dtype"], axes=tuple(params["axes"]),
                   detail=tuple(params.get("detail", ())))
    return None, float(ev.payload_bytes)


def lower_params(noise_models, descs) -> tuple[LoweredNoise, ...]:
    """Bind per-terminal ``(σ, shift)`` pairs to terminal costs.

    ``noise_models`` is the emitted ``NOISE_MODELS`` table (one pair per
    terminal, aligned with ``TERMINALS``); ``descs`` the matching
    descriptor tuple (either flavor's form — see :func:`_desc_cost`).
    """
    if len(noise_models) != len(descs):
        raise ValueError("NOISE_MODELS/terminal descriptor length mismatch: "
                         f"{len(noise_models)} vs {len(descs)}")
    out = []
    for (sigma, shift), desc in zip(noise_models, descs):
        cost, cbytes = _desc_cost(desc)
        out.append(LoweredNoise(float(sigma), float(shift), cost, cbytes))
    return tuple(out)


class NoiseTape:
    """The noise key leaf of a state in replay: the stream key (..., 3) it
    started from and the lowered params of each occurrence since, in
    program order (host-side; :func:`settle` draws them)."""

    def __init__(self, key: torch.Tensor):
        self.key = key
        self.ids: list[int] = []
        self._index: dict[int, int] = {}
        self.params: list[LoweredNoise] = []

    def record(self, nz: LoweredNoise) -> None:
        i = self._index.get(id(nz))
        if i is None:
            i = self._index[id(nz)] = len(self.params)
            self.params.append(nz)
        self.ids.append(i)


def perturb(st: dict, nz: LoweredNoise | None) -> dict:
    """Consume one draw for a terminal occurrence; no-op without a noise key.

    The gate is dict-key presence, so ``noise=None`` replay runs exactly
    the deterministic program.  Every terminal occurrence — comm *and*
    compute — consumes exactly one draw, in program order: the occurrence
    goes on the state's :class:`NoiseTape` (the first one replaces the key
    tensor by a tape, in a copy of the dict), and :func:`settle` draws the
    factors and accumulates the perturbed costs."""
    if nz is None or NOISE_KEY not in st:
        return st
    tape = st[NOISE_KEY]
    if not isinstance(tape, NoiseTape):
        st = dict(st)
        tape = st[NOISE_KEY] = NoiseTape(tape)
    tape.record(nz)
    return st


def settle(st: dict) -> dict:
    """Draw a replayed state's tape: returns a copy whose accumulators hold
    ``+ Σ_i f_i·cost_i`` (:data:`NOISE_COMPUTE`, (..., 6)) and ``+ Σ_i
    f_i·bytes_i`` (:data:`NOISE_COMM`, (...)), float64, and whose key is
    ``(k0, k1, n + draws)``.  The draws run on the key's device in chunks of
    :data:`SETTLE_CHUNK`, with no host sync.  A state without a tape (no
    noise, or no terminal replayed) is returned as it is."""
    tape = st.get(NOISE_KEY)
    if not isinstance(tape, NoiseTape):
        return st
    key = tape.key
    dev = key.device
    n = len(tape.ids)
    table = np.zeros((len(tape.params), N_METRICS + 3))
    for i, nz in enumerate(tape.params):
        table[i, 0], table[i, 1] = nz.sigma, nz.shift
        if nz.cost is not None:
            table[i, 2:2 + N_METRICS] = nz.cost
        table[i, -1] = nz.comm_bytes
    table = torch.as_tensor(table, dtype=torch.float64, device=dev)
    ids = torch.as_tensor(np.asarray(tape.ids, dtype=np.int64), device=dev)
    acc = torch.zeros(key.shape[:-1] + (N_METRICS + 1,), dtype=torch.float64,
                      device=dev)
    for lo in range(0, n, SETTLE_CHUNK):
        rows = table[ids[lo:lo + SETTLE_CHUNK]]           # (m, 9)
        counter = key[..., 2:3] + torch.arange(
            lo, lo + rows.shape[0], dtype=torch.int64, device=dev)
        f = sample_factor(key, counter, rows[:, 0], rows[:, 1])  # (..., m)
        acc = acc + (f.unsqueeze(-1) * rows[:, 2:]).sum(-2)
    out = dict(st)
    out[NOISE_KEY] = torch.cat([key[..., :2], key[..., 2:3] + n], -1)
    out[NOISE_COMPUTE] = st[NOISE_COMPUTE] + acc[..., :N_METRICS]
    out[NOISE_COMM] = st[NOISE_COMM] + acc[..., N_METRICS]
    return out


def attach(st: dict, key: torch.Tensor) -> dict:
    """Return a copy of a replay state with the noise leaves attached: the
    stream key (3,) int64 (:func:`replica_key`) and zero float64
    accumulators, on the key's device."""
    st = dict(st)
    st[NOISE_KEY] = key
    st[NOISE_COMPUTE] = torch.zeros((N_METRICS,), dtype=torch.float64,
                                    device=key.device)
    st[NOISE_COMM] = torch.zeros((), dtype=torch.float64, device=key.device)
    return st


def replica_key(seed: int, rep_rank: int, replica: int,
                device=None) -> torch.Tensor:
    """Per-(seed, group-representative, replica) stream key ``(k0, k1,
    0)``, int64 on ``device`` (default the CPU).

    Derived only from logical identifiers — never from device placement or
    the replica count — so a replica draws the same stream wherever and
    beside however many others it runs."""
    ids = [int(seed) & _M32, (int(seed) >> 32) & _M32, int(rep_rank) & _M32,
           int(replica) & _M32]
    h = torch.tensor(0x9E3779B9, dtype=torch.int64)
    for v in ids:
        h = _mix32(h ^ v)
    k1 = _mix32(h ^ 0x85EBCA6B)
    return torch.stack([h, k1, torch.tensor(0)]).to(
        torch.device(device or "cpu"))


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Calibrated per-cluster / per-comm-kind noise parameters.

    ``compute_sigmas`` maps cluster id → lognormal σ; ``comm_params``
    maps collective kind → ``(σ, shift)``.  Pure data — JSON
    round-trips exactly (:meth:`to_json`/:meth:`from_json`) and rides
    the corpus-store manifest.
    """
    compute_sigmas: dict[int, float]
    comm_params: dict[str, tuple[float, float]]
    sigma_floor: float = SIGMA_FLOOR

    def terminal_params(self, events) -> tuple[tuple[float, float], ...]:
        """Per-terminal ``(σ, shift)`` aligned with a terminal table.

        ``events`` is the merged terminal table's event list (one
        :class:`CommEvent`/:class:`ComputeEvent` per terminal id).
        """
        out = []
        for ev in events:
            if isinstance(ev, CommEvent):
                out.append(self.comm_params.get(
                    ev.kind, (self.sigma_floor, COMM_SHIFT)))
            else:
                out.append((self.compute_sigmas.get(
                    ev.cluster_id, self.sigma_floor), 0.0))
        return tuple(out)

    def to_json(self) -> dict:
        return {
            "compute_sigmas": {str(k): v
                               for k, v in sorted(self.compute_sigmas.items())},
            "comm_params": {k: list(v)
                            for k, v in sorted(self.comm_params.items())},
            "sigma_floor": self.sigma_floor,
        }

    @classmethod
    def from_json(cls, data: dict) -> "NoiseModel":
        return cls(
            compute_sigmas={int(k): float(v)
                            for k, v in data["compute_sigmas"].items()},
            comm_params={k: (float(v[0]), float(v[1]))
                         for k, v in data["comm_params"].items()},
            sigma_floor=float(data.get("sigma_floor", SIGMA_FLOOR)),
        )


def _log_sigma(mags: np.ndarray, floor: float) -> float:
    """σ of log-magnitudes, floored; degenerate samples collapse to floor."""
    mags = np.asarray(mags, dtype=np.float64)
    mags = mags[mags > 0]
    if mags.size < 2:
        return float(floor)
    return float(max(np.std(np.log(mags)), floor))


def _weighted_log_sigma(mags: np.ndarray, weights: np.ndarray,
                        floor: float) -> float:
    """Occurrence-weighted σ of log payloads for one collective kind."""
    mags = np.asarray(mags, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    good = (mags > 0) & (weights > 0)
    mags, weights = mags[good], weights[good]
    if mags.size == 0 or weights.sum() <= 0:
        return float(floor)
    logs = np.log(mags)
    mean = np.average(logs, weights=weights)
    var = np.average((logs - mean) ** 2, weights=weights)
    return float(max(math.sqrt(var), floor))


def calibrate(store, cluster_ids: np.ndarray | None = None,
              rel_tol: float = 0.05, sigma_floor: float = SIGMA_FLOOR,
              comm_shift: float = COMM_SHIFT) -> NoiseModel:
    """Calibrate a :class:`NoiseModel` from a columnar TraceStore.

    Compute σ per cluster is the spread of log row-magnitudes
    (``metrics.sum(axis=1)``) over the cluster's member events — the
    intra-cluster variance the rel_tol clustering deliberately collapses
    into one representative.  ``cluster_ids`` defaults to the store's
    own :func:`~repro_torch.core.events.cluster_vectors` assignment (matching
    ``compress_store``); corpus synthesis passes the *joint* assignment
    slice instead so batch and incremental paths calibrate identically.

    Comm σ per collective kind is the occurrence-weighted spread of log
    payload bytes across the kind's comm-pool entries (weights from
    :meth:`~repro_torch.core.trace_ir.TraceStore.comm_occurrence_counts`);
    the shift is the constant bandwidth floor ``comm_shift``.
    """
    metrics = np.asarray(store.metrics, dtype=np.float64)
    if cluster_ids is None:
        cluster_ids, _ = cluster_vectors(metrics, rel_tol)
    cluster_ids = np.asarray(cluster_ids)
    if len(cluster_ids) != len(metrics):
        raise ValueError("cluster_ids length does not match compute events: "
                         f"{len(cluster_ids)} vs {len(metrics)}")

    compute_sigmas: dict[int, float] = {}
    mags = metrics.sum(axis=1)
    for cid in np.unique(cluster_ids):
        compute_sigmas[int(cid)] = _log_sigma(mags[cluster_ids == cid],
                                              sigma_floor)

    counts = store.comm_occurrence_counts()
    by_kind: dict[str, list[tuple[float, float]]] = {}
    for ev, cnt in zip(store.comm_pool, counts):
        by_kind.setdefault(ev.kind, []).append(
            (float(ev.payload_bytes), float(cnt)))
    comm_params = {
        kind: (_weighted_log_sigma(np.array([m for m, _ in pairs]),
                                   np.array([w for _, w in pairs]),
                                   sigma_floor), comm_shift)
        for kind, pairs in by_kind.items()
    }
    return NoiseModel(compute_sigmas=compute_sigmas, comm_params=comm_params,
                      sigma_floor=sigma_floor)


def calibrate_trace(trace, rel_tol: float = 0.05,
                    sigma_floor: float = SIGMA_FLOOR,
                    comm_shift: float = COMM_SHIFT) -> NoiseModel:
    """Calibrate directly from one template
    :class:`~repro_torch.core.tracer.Trace` (single-rank convenience
    wrapper; same math as :func:`calibrate`).  Copy of the reference's
    ``noise.calibrate_trace``."""
    metrics = trace.compute_metrics_array()
    cluster_ids, _ = cluster_vectors(metrics, rel_tol)
    compute_sigmas: dict[int, float] = {}
    mags = metrics.sum(axis=1)
    for cid in np.unique(cluster_ids):
        compute_sigmas[int(cid)] = _log_sigma(mags[cluster_ids == cid],
                                              sigma_floor)
    by_kind: dict[str, list[tuple[float, float]]] = {}
    for ev in trace.comm_events():
        by_kind.setdefault(ev.kind, []).append((float(ev.payload_bytes), 1.0))
    comm_params = {
        kind: (_weighted_log_sigma(np.array([m for m, _ in pairs]),
                                   np.array([w for _, w in pairs]),
                                   sigma_floor), comm_shift)
        for kind, pairs in by_kind.items()
    }
    return NoiseModel(compute_sigmas=compute_sigmas, comm_params=comm_params,
                      sigma_floor=sigma_floor)


# ---------------------------------------------------------------------------
# Replay-facing config + distribution summary
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Opt-in switch for noisy replay: ``ProxyProgram.*(noise=NoiseConfig())``.

    ``n_replicas`` seeded replicas run as ONE extra vmapped axis per
    signature group, so the sweep scheduler and compile caches are
    reused; keys derive from ``(seed, group-representative, replica)``
    and are placement-invariant (LocalSim ≡ mesh bit-for-bit).
    """
    seed: int = 0
    n_replicas: int = 8

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")


@dataclasses.dataclass(frozen=True)
class FidelityDistribution:
    """δ̄ as a distribution over seeded noisy replicas (paper eq. 8 +
    Cornebize-style variability bands).

    ``replica_delta`` is the raw ``(n_replicas, n_metrics, n_ranks)``
    per-replica δ matrix; everything else is a deterministic summary of
    it (normal-approximation ``mean ± z·std`` bands — no resampling, so
    the whole object is a pure function of ``(seed, n_replicas)``).
    """
    replica_delta: np.ndarray        # (n_replicas, n_metrics, n_ranks)
    comm_bytes: np.ndarray           # (n_replicas, n_ranks) perturbed totals
    ranks: tuple[int, ...]
    seed: int
    n_replicas: int
    comm_lossless: bool
    mesh_checked: bool = False

    @property
    def delta_mean(self) -> np.ndarray:
        """(n_metrics, n_ranks) mean δ over replicas."""
        return self.replica_delta.mean(axis=0)

    @property
    def delta_std(self) -> np.ndarray:
        """(n_metrics, n_ranks) std of δ over replicas."""
        return self.replica_delta.std(axis=0)

    @property
    def replica_means(self) -> np.ndarray:
        """(n_replicas,) scalar δ̄ per replica."""
        return self.replica_delta.mean(axis=(1, 2))

    @property
    def mean(self) -> float:
        """Mean δ̄ over replicas (the noisy analog of FidelityReport.mean)."""
        return float(self.replica_means.mean())

    @property
    def std(self) -> float:
        return float(self.replica_means.std())

    def ci(self, z: float = 1.96) -> tuple[float, float]:
        """Normal-approx confidence band for the scalar δ̄."""
        return (self.mean - z * self.std, self.mean + z * self.std)

    def metric_bands(self, z: float = 1.96) -> np.ndarray:
        """(n_metrics, 2) per-metric [lo, hi] bands over replicas."""
        per_rep = self.replica_delta.mean(axis=2)      # (n_replicas, n_metrics)
        mean, std = per_rep.mean(axis=0), per_rep.std(axis=0)
        return np.stack([mean - z * std, mean + z * std], axis=1)

    def to_csv(self) -> str:
        """Mean-δ heatmap CSV with seed/replica provenance headers."""
        lines = [f"# seed={self.seed}", f"# n_replicas={self.n_replicas}",
                 "metric," + ",".join(f"rank{p}" for p in self.ranks)]
        mean = self.delta_mean
        for m, mname in enumerate(METRIC_NAMES):
            lines.append(mname + "," +
                         ",".join(f"{v:.4f}" for v in mean[m]))
        return "\n".join(lines)


def parse_fidelity_csv(text: str) -> tuple[dict, np.ndarray]:
    """Parse :meth:`FidelityDistribution.to_csv` /
    ``FidelityReport.to_csv`` output back into ``(meta, delta)`` where
    ``meta`` carries the provenance header fields and ``delta`` is the
    ``(n_metrics, n_ranks)`` float matrix — the round-trip oracle for
    the provenance-header regression test."""
    meta: dict = {}
    rows = []
    for line in text.strip().splitlines():
        if line.startswith("#"):
            k, _, v = line.lstrip("# ").partition("=")
            meta[k.strip()] = int(v)
        elif line.startswith("metric,"):
            meta["ranks"] = tuple(
                int(c[len("rank"):]) for c in line.split(",")[1:])
        else:
            rows.append([float(v) for v in line.split(",")[1:]])
    return meta, np.asarray(rows, dtype=np.float64)
