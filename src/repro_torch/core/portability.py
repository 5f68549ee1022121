"""Cross-hardware profile prediction for synthesized proxies (paper §5).

Port copy of :mod:`repro.core.portability`; ``repro_torch`` imports nothing from
``repro``.

A proxy fitted on one chip carries everything needed to *predict* its
profile on another: the terminal table pins exact per-occurrence costs
(compute metric vectors, collective payload bytes), and the roofline
model turns those costs into time bounds per chip.  ``predict_profile``
rescales the fitted terminal costs by the target chip's roofline ratios
— peak FLOP/s, HBM bandwidth, link bandwidth — and returns a per-rank
step-time bound with error bars, on hardware the scenario was never
traced on.

Error bars come from the module's ``NOISE_MODELS`` table: each terminal
occurrence's cost is modelled as its fitted value times an independent
mean-one factor with variance :func:`repro_torch.core.noise.factor_variance`,
so the per-rank time variance is the count-weighted sum of squared
terminal times times factor variances (delta method on the bottleneck
roofline term).

Only imports the light ``launch.hlo_cost`` module — the reference-chip
constants are defined here (``CHIPS['h100']``) and mirror
:mod:`repro_torch.core.metrics`; keeping them local avoids pulling the
heavy ``repro_torch.configs`` chain into ``repro_torch.core``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import noise as noise_mod
from repro_torch.launch.hlo_cost import HloCost


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Roofline envelope of one accelerator generation."""

    name: str
    peak_flops: float   # peak matmul FLOP/s (bf16)
    hbm_bw: float       # HBM bytes/s
    ici_bw: float       # per-link interconnect bytes/s (NVLink, one way)

    def terms(self, flops: float, mem_bytes: float,
              coll_bytes: float) -> tuple[float, float, float]:
        """(t_compute, t_memory, t_collective) seconds for one rank."""
        return (flops / self.peak_flops, mem_bytes / self.hbm_bw,
                coll_bytes / self.ici_bw)


#: Known chip envelopes: NVIDIA data-center GPUs, dense (no sparsity)
#: bf16 tensor-core FLOP/s, HBM bytes/s, and one NVLink link's bytes/s in
#: one direction.  ``h100`` is the card the port's block catalog is
#: calibrated on; its numbers match the constants in
#: :mod:`repro_torch.core.metrics`.  The reference's table holds TPU
#: envelopes (``v5e``, ``v5p``, ``v4``) instead; ``predict_profile`` takes a
#: :class:`ChipSpec` as well as a name, so those can still be passed.
CHIPS: Mapping[str, ChipSpec] = {
    # NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column: BF16 Tensor
    # Core 1,979 TFLOPS with sparsity (989 dense); GPU memory bandwidth
    # 3.35 TB/s (HBM3, 80 GB); NVLink 900 GB/s over 18 NVLink 4 links,
    # 50 GB/s a link both ways, 25 GB/s one way
    "h100": ChipSpec("h100", peak_flops=989e12, hbm_bw=3.35e12,
                     ici_bw=25e9),
    # NVIDIA A100 Tensor Core GPU data sheet, A100 80GB SXM column: BF16
    # Tensor Core 312 TFLOPS (624 with sparsity); GPU memory bandwidth
    # 2,039 GB/s (HBM2e); NVLink 600 GB/s over 12 NVLink 3 links, 25 GB/s
    # a link one way
    "a100": ChipSpec("a100", peak_flops=312e12, hbm_bw=2.039e12,
                     ici_bw=25e9),
    # NVIDIA H200 Tensor Core GPU data sheet, H200 SXM column: BF16 Tensor
    # Core 1,979 TFLOPS with sparsity (989 dense); GPU memory bandwidth
    # 4.8 TB/s (HBM3e, 141 GB); NVLink 900 GB/s over 18 NVLink 4 links,
    # 25 GB/s a link one way
    "h200": ChipSpec("h200", peak_flops=989e12, hbm_bw=4.8e12,
                     ici_bw=25e9),
}

REFERENCE_CHIP = "h100"

_TERM_NAMES = ("compute", "memory", "collective")


@dataclasses.dataclass(frozen=True)
class ProfilePrediction:
    """Predicted per-rank roofline profile of a proxy on one chip.

    All arrays are float64 of shape ``(n_ranks,)``; ``t_total`` is the
    max-of-terms step-time bound (same convention as
    ``repro.launch.roofline.step_time_bound``) and ``t_std`` its noise
    standard deviation from the module's ``NOISE_MODELS`` table.
    """

    chip: str
    t_compute: np.ndarray
    t_memory: np.ndarray
    t_collective: np.ndarray
    t_total: np.ndarray
    t_std: np.ndarray
    bottleneck: tuple[str, ...]     # per rank: compute|memory|collective
    speedup_vs_ref: float           # ref-chip step bound / this chip's

    @property
    def step_time(self) -> float:
        """Scalar step-time bound: the slowest rank gates the step."""
        return float(self.t_total.max())

    def band(self, z: float = 1.96) -> tuple[np.ndarray, np.ndarray]:
        """Per-rank ``(lo, hi)`` confidence band, clipped at zero."""
        half = z * self.t_std
        return np.maximum(self.t_total - half, 0.0), self.t_total + half

    def as_dict(self) -> dict:
        """JSON-ready summary row (benchmark artifact schema)."""
        lo, hi = self.band()
        return {
            "chip": self.chip,
            "step_time_s": self.step_time,
            "step_std_s": float(self.t_std[int(self.t_total.argmax())]),
            "band_lo_s": float(lo.max()),
            "band_hi_s": float(hi.max()),
            "speedup_vs_ref": self.speedup_vs_ref,
            "bottleneck": self.bottleneck[int(self.t_total.argmax())],
            "t_compute_s": float(self.t_compute.max()),
            "t_memory_s": float(self.t_memory.max()),
            "t_collective_s": float(self.t_collective.max()),
        }


def _terminal_costs(module) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-terminal ``(flops, mem_bytes, coll_bytes)`` float64 arrays.

    Compute terminals map through :meth:`HloCost.from_metric_vector`
    (the fitted block-combo metric vector); comm terminals contribute
    their exact traced payload bytes to the collective term.
    """
    terms = getattr(module, "TERMINALS", None)
    if terms is None:
        raise ValueError(
            "predict_profile needs a table-flavor module (TERMINALS); "
            "re-synthesize with codegen='table'")
    n = len(terms)
    flops = np.zeros(n)
    mem = np.zeros(n)
    coll = np.zeros(n)
    for gid, desc in enumerate(terms):
        cost_vec, comm_bytes = noise_mod._desc_cost(desc)
        if cost_vec is not None:
            hc = HloCost.from_metric_vector(cost_vec)
            flops[gid] = hc.flops
            mem[gid] = hc.bytes
        else:
            coll[gid] = comm_bytes
    return flops, mem, coll


def _rank_counts(module) -> dict[int, np.ndarray]:
    """rank -> per-terminal occurrence counts (grouped: one expansion per
    signature group, shared by all its ranks)."""
    n = len(module.TERMINALS)
    counts: dict[int, np.ndarray] = {}
    for _sig, ranks, _hint in module.SIGNATURE_GROUPS:
        ct = np.bincount(np.asarray(module.expand_rank_ids(ranks[0]),
                                    dtype=np.int64), minlength=n)
        for r in ranks:
            counts[r] = ct
    return counts


def predict_profile(module, chip: str | ChipSpec,
                    ref_chip: str | ChipSpec = REFERENCE_CHIP,
                    ) -> ProfilePrediction:
    """Predict ``module``'s roofline profile on ``chip``.

    Rescales the proxy's fitted per-terminal costs by the target chip's
    roofline ratios; error bars propagate the module's calibrated
    ``NOISE_MODELS`` variance through the bottleneck term.
    """
    if isinstance(chip, str):
        chip = CHIPS[chip]
    if isinstance(ref_chip, str):
        ref_chip = CHIPS[ref_chip]
    flops, mem, coll = _terminal_costs(module)
    nm = getattr(module, "NOISE_MODELS", None) or ((0.0, 0.0),) * len(flops)
    fvar = np.array([noise_mod.factor_variance(s, sh) for s, sh in nm])
    counts = _rank_counts(module)
    ranks = sorted(counts)

    tc = np.empty(len(ranks))
    tm = np.empty(len(ranks))
    tl = np.empty(len(ranks))
    var = np.empty(len(ranks))
    ref_total = np.empty(len(ranks))
    bottleneck = []
    # Per-terminal seconds on the target chip, one row per roofline term.
    term_secs = np.stack([flops / chip.peak_flops, mem / chip.hbm_bw,
                          coll / chip.ici_bw])
    for i, r in enumerate(ranks):
        ct = counts[r]
        tc[i], tm[i], tl[i] = term_secs @ ct
        which = int(np.argmax((tc[i], tm[i], tl[i])))
        bottleneck.append(_TERM_NAMES[which])
        # Delta method: Var[Σ count·t·f] = Σ count·t²·Var[f] on the
        # bottleneck term (independent mean-one factors per occurrence).
        var[i] = float(ct @ (term_secs[which] ** 2 * fvar))
        ref_total[i] = max(ref_chip.terms(float(flops @ ct), float(mem @ ct),
                                          float(coll @ ct)))
    total = np.maximum(np.maximum(tc, tm), tl)
    speedup = float(ref_total.max() / total.max()) if total.max() > 0 else 1.0
    return ProfilePrediction(chip=chip.name, t_compute=tc, t_memory=tm,
                             t_collective=tl, t_total=total,
                             t_std=np.sqrt(var),
                             bottleneck=tuple(bottleneck),
                             speedup_vs_ref=speedup)


def predict_all(module, chips: Sequence[str | ChipSpec] = tuple(CHIPS),
                ) -> dict[str, ProfilePrediction]:
    """``predict_profile`` over a chip list, keyed by chip name."""
    out = {}
    for c in chips:
        pred = predict_profile(module, c)
        out[pred.chip] = pred
    return out
