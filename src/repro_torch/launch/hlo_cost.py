"""Roofline cost record of the port: :class:`HloCost`.

Port copy of the :class:`HloCost` record of :mod:`repro.launch.hlo_cost`
(``hlo_cost.py:259-295``) with :meth:`HloCost.from_metric_vector` and its
two weights, which :mod:`repro_torch.core.portability` needs to turn a
6-metric trace vector into roofline terms.  ``repro_torch`` imports nothing
from ``repro``.

The rest of the reference module (``parse_module``, ``analyze``,
``top_sites``) parses XLA's compiled HLO text, which the port never has;
its counterpart waits for the launch substrate (ROADMAP, queue 1, item 12).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_count: int = 0
    transcendentals: float = 0.0

    def add(self, other: "HloCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        self.collective_count += int(other.collective_count * mult)
        self.transcendentals += other.transcendentals * mult
        for k, v in other.collective_by_kind.items():
            self.collective_by_kind[k] += v * mult

    #: roofline weights mapping the 6-metric trace vector onto flop/byte
    #: totals: a transcendental costs ~8 flop-equivalents, a gathered
    #: element moves a 4-byte word.  scan_steps is deliberately excluded —
    #: loop-turn bookkeeping is not hardware work, and keeping it out makes
    #: predicted totals match the walker's measured totals.  The reference's
    #: weights, kept so both packages predict the same profile from the
    #: same terminal table.
    TRANS_FLOP_WEIGHT = 8.0
    GATHER_BYTE_WEIGHT = 4.0

    @classmethod
    def from_metric_vector(cls, vec) -> "HloCost":
        """Project a 6-metric trace vector (``events.METRIC_NAMES`` order)
        onto roofline terms — the bridge between fitted terminal costs and
        :mod:`repro_torch.core.portability` predictions."""
        mxu, vpu, hbm, trans, gather, _scan = (float(v) for v in vec)
        return cls(flops=mxu + vpu + cls.TRANS_FLOP_WEIGHT * trans,
                   bytes=hbm + cls.GATHER_BYTE_WEIGHT * gather,
                   transcendentals=trans)
