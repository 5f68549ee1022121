"""Calibrated noise models for variability-aware replay (numpy half).

Port of :mod:`repro.core.noise`: calibration (:func:`calibrate`,
:class:`NoiseModel`), the per-terminal lowering (:func:`lower_params`) and
the replay-facing config and distribution types are the reference's code.
The seeded sampler (``sample_factor``, ``attach``, ``replica_key``) is not
ported yet; :func:`perturb` is the identity on a state without a noise key
and raises on one that has it.

Cornebize & Legrand (arxiv 2102.07674) show that platform variability, not
model error, dominates MPI performance-prediction error.  The reference
answers with per-terminal multiplicative noise calibrated from the variance
already in a :class:`~repro_torch.core.trace_ir.TraceStore`: compute
terminals draw a mean-one lognormal factor whose σ is the log-magnitude
spread of the terminal's cluster; comm terminals draw a lognormal shifted
by the bandwidth floor :data:`COMM_SHIFT`:

    f = shift + (1 - shift) · exp(σ·z - σ²/2),   z ~ N(0, 1)

Calibrated params land in generated modules as the ``NOISE_MODELS`` table
beside ``TERMINALS`` and are lowered by
:class:`~repro_torch.core.progtable.ProgramTable` through
:func:`lower_params`.  Noise is off by default: with no noise key in the
replay state, :func:`perturb` returns the state as it is, so ``noise=None``
replay runs exactly the deterministic program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.events import CommEvent, cluster_vectors

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


# ---------------------------------------------------------------------------
# Sampling + lowering (shared by both codegen flavors)
# ---------------------------------------------------------------------------


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


def perturb(st: dict, nz: LoweredNoise | None) -> dict:
    """Accumulate one perturbed terminal cost; no-op without a noise key.

    The gate is dict-key presence, so ``noise=None`` replay runs exactly
    the deterministic program.  Seeded noisy replay (the key split, the
    factor draw and the accumulators) is not ported yet: a state that
    carries the key raises."""
    if nz is None or NOISE_KEY not in st:
        return st
    raise NotImplementedError("seeded noise replay is not ported to "
                              "repro_torch yet")


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
