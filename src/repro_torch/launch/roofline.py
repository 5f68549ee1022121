"""Roofline terms of a dry-run cell (port of :mod:`repro.launch.roofline`).

Per (arch × shape × mesh):

    compute    = per-device flops / peak FLOP/s
    memory     = per-device bytes / HBM bandwidth
    collective = per-device collective bytes / link bandwidth

The reference reads the terms off a compiled program's HLO (already per
device after SPMD); the port reads them off the op log of rank 0's step
(:func:`repro_torch.launch.hlo_cost.record_step`), which is per process by
construction: the step runs on this process's blocks.  ``report`` takes
that log's :class:`~repro_torch.launch.hlo_cost.HloCost` and the cell's
memory record where the reference takes the compiled program.

MODEL_FLOPS uses 6·N_active·tokens for training and 2·N_active·tokens for
inference; the ratio MODEL_FLOPS / (devices · flops) exposes remat
recompute and padding waste.  The formulas are the reference's; the
constants are one NVIDIA H100 SXM's, from its data sheet: no TPU number is
used.  They are predictions, not measurements.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig, RunShape
# dense bf16 tensor-core peak (989e12 FLOP/s) and HBM3 bandwidth (3.35e12
# B/s) of one H100 SXM, shared with the baselines' roofline
from repro_torch.core.metrics import HBM_BW, PEAK_FLOPS_BF16  # noqa: F401
from repro_torch.sharding.partition import axis_sizes

#: bytes/s a GPU moves to the others of a collective on the production
#: mesh: one 400 Gb/s NDR InfiniBand port per GPU (the DGX H100 layout,
#: eight GPUs a node, one port each), 8 bits a byte.  Every axis of 16
#: spans two 8-GPU nodes, so its collectives cross the network at this
#: rate, not NVLink's.
ICI_BW = 400e9 / 8


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_kind: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (chips * flops)
    memory_per_device: int       # argument + temp bytes of the cell

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["coll_by_kind"] = dict(self.coll_by_kind)
        return d


def model_flops(cfg: ArchConfig, shape: RunShape) -> float:
    n_active = cfg.active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def report(cost, memory: dict, cfg: ArchConfig, shape: RunShape, mesh,
           mesh_name: str) -> RooflineReport:
    """The cell's roofline from its op log's ``cost`` (an ``HloCost``) and
    its ``memory`` record (``argument_bytes``, ``temp_bytes``); ``mesh`` a
    mesh or a dict of axis sizes."""
    n_chips = math.prod(axis_sizes(mesh).values())
    t_c = cost.flops / PEAK_FLOPS_BF16
    t_m = cost.bytes / HBM_BW
    t_n = cost.collective_bytes / ICI_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_n}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / max(cost.flops * n_chips, 1.0)
    mem = int(memory["temp_bytes"] + memory["argument_bytes"])
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        flops_per_chip=cost.flops, bytes_per_chip=cost.bytes,
        coll_bytes_per_chip=cost.collective_bytes,
        coll_by_kind=dict(cost.collective_by_kind),
        t_compute=t_c, t_memory=t_m, t_collective=t_n,
        bottleneck=bottleneck, model_flops=mf, useful_ratio=useful,
        memory_per_device=mem)


def step_time_bound(rep: RooflineReport) -> float:
    """max-of-terms lower bound on step wall time (perfect overlap)."""
    return max(rep.t_compute, rep.t_memory, rep.t_collective)


def roofline_fraction(rep: RooflineReport) -> float:
    """Fraction of the ideal compute roofline this cell achieves, assuming
    step time = max(terms): (MODEL_FLOPS/chips/peak) / max(terms)."""
    ideal = rep.model_flops / rep.n_chips / PEAK_FLOPS_BF16
    return ideal / max(step_time_bound(rep), 1e-30)
