"""Deterministic fault injection for the corpus store + serve tier.

Port copy of :mod:`repro.core.faults`; ``repro_torch`` imports nothing from
``repro``.

The fleet-scale store (sharded manifests, concurrent appenders, process-
pool ingest) and the serve tier above it must survive *real* cluster
conditions — torn writes, EIO, held locks, OOM-killed workers — not just
the failure modes the original tests happened to cover.  This module is
the chaos harness those guarantees are pinned against: a **seeded,
deterministic** fault plan threaded through every filesystem touchpoint
the store uses, so a crash schedule that breaks the store is a
reproducible test case, not a flake.

Design constraints (in priority order):

1. **Inert by default.**  With no plan installed, every injection point
   is one module-global load + ``is None`` branch (:func:`arm`).  No
   allocation, no string formatting, no locks; the serve hot path never
   calls into this module at all.
2. **Deterministic.**  A :class:`FaultPlan` is an explicit list of
   :class:`FaultSpec` triggers (point name, fault kind, optional
   substring match, skip count, fire budget).  :meth:`FaultPlan.random`
   derives a schedule from a seed — same seed, same faults, bit for bit.
3. **Registered points.**  Every injection point the store threads is
   declared here (:data:`FAULT_POINTS`) so the chaos sweep
   (``benchmarks/chaos.py``) can *enumerate* them — a new store
   touchpoint that forgets to register fails the sweep's coverage
   check rather than silently escaping chaos testing.

Fault kinds
-----------

``crash_before``   raise :class:`InjectedCrash` before the operation — a
                   SIGKILL just before the write/read started.
``crash_after``    the operation completes durably, then
                   :class:`InjectedCrash` — a SIGKILL between the rename
                   and whatever bookkeeping was next.
``torn_write``     the *target* file is overwritten with a truncated
                   prefix of the intended bytes, then
                   :class:`InjectedCrash` — the non-atomic overwrite /
                   bad-sector case the atomic renamer exists to prevent;
                   injected anyway so ``verify()``/``repair()`` are
                   exercised against genuine on-disk damage.
``io_error``       raise ``OSError(EIO)`` — flaky NFS, dying disk.
``slow_lock``      lock acquisition behaves contended (non-blocking
                   attempts fail) until the spec's budget is exhausted —
                   exercises the bounded retry/backoff and the
                   :class:`~repro_torch.core.corpus_store.LockTimeoutError`
                   diagnostic.
``worker_death``   ``os._exit(1)`` — but **only** inside a forked pool
                   worker (the parent's serial retry of the same item
                   must survive); simulates an OOM-killed ingest worker
                   and produces a real ``BrokenProcessPool``.

:class:`InjectedCrash` subclasses ``BaseException`` deliberately: the
store's self-healing paths catch ``Exception`` (a corrupt cache *should*
heal), and a simulated process death must not be "healed" in-process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno
import os
from pathlib import Path

__all__ = [
    "FAULT_KINDS", "FAULT_POINTS", "FaultPlan", "FaultSpec",
    "InjectedCrash", "active_plan", "arm", "clear_plan", "crash_point",
    "current_plan", "install_plan", "registered_points",
]

#: every injection point threaded through the store, grouped by the
#: operation class each supports.  ``benchmarks/chaos.py`` enumerates
#: this registry; tests assert the store actually fires each one.
FAULT_POINTS: dict[str, tuple[str, ...]] = {
    # atomic-write sites: crash before/after the rename, or a torn
    # non-atomic overwrite of the target
    "write.scenario_npz":  ("crash_before", "crash_after", "torn_write",
                            "io_error"),
    "write.sidecar":       ("crash_before", "crash_after", "torn_write",
                            "io_error"),
    "write.index":         ("crash_before", "crash_after", "torn_write",
                            "io_error"),
    "write.fit_cache":     ("crash_before", "crash_after", "torn_write",
                            "io_error"),
    "write.grammar_cache": ("crash_before", "crash_after", "torn_write",
                            "io_error"),
    "write.shard":         ("crash_before", "crash_after", "torn_write",
                            "io_error"),
    "write.manifest":      ("crash_before", "crash_after", "torn_write",
                            "io_error"),
    # read sites: crash mid-workload or EIO surfaced to the caller
    "read.scenario_npz":   ("crash_before", "io_error"),
    "read.sidecar":        ("crash_before", "io_error"),
    "read.shard":          ("crash_before", "io_error"),
    "read.index":          ("crash_before", "io_error"),
    # cross-process lock acquisition
    "lock.acquire":        ("crash_before", "io_error", "slow_lock"),
    # the process-pool ingest front half
    "worker.ingest":       ("crash_before", "io_error", "worker_death"),
}

FAULT_KINDS = ("crash_before", "crash_after", "torn_write", "io_error",
               "slow_lock", "worker_death")


def registered_points() -> list[str]:
    """All registered injection points, in declaration order."""
    return list(FAULT_POINTS)


class InjectedCrash(BaseException):
    """A simulated process death at a named fault point.

    ``BaseException`` on purpose: self-healing ``except Exception``
    blocks in the store must not swallow a simulated SIGKILL — the test
    harness is the only intended handler."""

    def __init__(self, point: str, detail: str = ""):
        self.point = point
        self.detail = detail
        super().__init__(f"injected crash at {point!r}"
                         + (f" ({detail})" if detail else ""))


@dataclasses.dataclass
class FaultSpec:
    """One deterministic trigger: fire ``kind`` at ``point`` on its
    ``(skip+1)``-th eligible hit (and the ``count-1`` following ones),
    optionally only when ``match`` is a substring of the hit's detail
    (usually the file path)."""

    point: str
    kind: str
    match: str | None = None
    skip: int = 0            # eligible hits to let pass first
    count: int = 1           # firings before the spec burns out

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unregistered fault point {self.point!r} "
                             f"(have {sorted(FAULT_POINTS)})")
        if self.kind not in FAULT_POINTS[self.point]:
            raise ValueError(
                f"fault kind {self.kind!r} is not supported at "
                f"{self.point!r} (supports {FAULT_POINTS[self.point]})")
        self._remaining_skip = self.skip
        self._remaining = self.count


class FaultPlan:
    """A deterministic schedule of :class:`FaultSpec` triggers.

    Install with :func:`install_plan` / the :func:`active_plan` context
    manager; the store's touchpoints consult it via :func:`arm`.
    ``fired`` records every firing as ``(point, kind, detail)`` so tests
    can assert the fault actually triggered (a chaos case that never
    fires is a coverage bug, not a pass)."""

    def __init__(self, specs=(), seed: int | None = None):
        self.specs = list(specs)
        self.seed = seed
        self.fired: list[tuple[str, str, str]] = []
        #: every (point, detail) consulted, fault or not — the sweep's
        #: coverage probe
        self.hits: list[tuple[str, str]] = []

    @classmethod
    def crash_at(cls, point: str, kind: str = "crash_before",
                 match: str | None = None, skip: int = 0) -> "FaultPlan":
        """The chaos-sweep unit: one fault at one point."""
        return cls([FaultSpec(point, kind, match=match, skip=skip)])

    @classmethod
    def random(cls, seed: int, n_faults: int = 1,
               points=None, kinds=None) -> "FaultPlan":
        """A seeded random schedule (the property-test form): same seed,
        same specs.  Uses numpy's Generator so schedules are reproducible
        across platforms."""
        import numpy as np
        rng = np.random.default_rng(seed)
        points = list(points if points is not None else FAULT_POINTS)
        specs = []
        for _ in range(n_faults):
            point = points[int(rng.integers(len(points)))]
            supported = [k for k in FAULT_POINTS[point]
                         if kinds is None or k in kinds]
            if not supported:
                continue
            kind = supported[int(rng.integers(len(supported)))]
            specs.append(FaultSpec(point, kind,
                                   skip=int(rng.integers(0, 3))))
        return cls(specs, seed=seed)

    # -- consultation (the hot side) -------------------------------------------

    def _arm(self, point: str, detail: str) -> FaultSpec | None:
        self.hits.append((point, detail))
        for spec in self.specs:
            if spec.point != point or spec._remaining <= 0:
                continue
            if spec.match is not None and spec.match not in detail:
                continue
            if spec._remaining_skip > 0:
                spec._remaining_skip -= 1
                continue
            spec._remaining -= 1
            self.fired.append((point, spec.kind, detail))
            if spec.kind == "crash_before":
                raise InjectedCrash(point, detail)
            if spec.kind == "io_error":
                raise OSError(errno.EIO, f"injected EIO at {point}", detail)
            if spec.kind == "worker_death":
                # only die inside a forked pool worker: the parent's
                # serial retry of the same item must run to completion
                import multiprocessing as mp
                if mp.parent_process() is not None:
                    os._exit(1)
                continue
            return spec          # crash_after / torn_write / slow_lock:
            # the call site owns the bytes/lock and implements the fault
        return None


#: the installed plan; module-global so the inert check is one load
_PLAN: FaultPlan | None = None


def install_plan(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def clear_plan() -> None:
    global _PLAN
    _PLAN = None


def current_plan() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def active_plan(plan: FaultPlan):
    """Install ``plan`` for the duration of the block (always cleared,
    even when the injected fault propagates out)."""
    install_plan(plan)
    try:
        yield plan
    finally:
        clear_plan()


def arm(point: str, detail="") -> FaultSpec | None:
    """Consult the installed plan at an injection point.

    The inert fast path — no plan installed — is a single global load
    and ``None`` check.  With a plan: raises for ``crash_before`` /
    ``io_error`` / (in a worker) ``worker_death``; returns the matched
    spec for faults the call site must implement (``crash_after``,
    ``torn_write``, ``slow_lock``); returns ``None`` when nothing fires.
    """
    plan = _PLAN
    if plan is None:
        return None
    return plan._arm(point, str(detail))


def crash_point(point: str, detail="") -> None:
    """Fire a point that supports only before-crash semantics (reads):
    :func:`arm` plus the ``crash_after`` check is meaningless there, so
    call sites use this single statement."""
    plan = _PLAN
    if plan is None:
        return
    plan._arm(point, str(detail))


def torn_bytes(data: bytes) -> bytes:
    """The torn prefix written by a ``torn_write`` fault: at least one
    byte, at most half the payload — enough to be nonempty (the file
    "exists") and guaranteed unparseable for any framed format."""
    return data[: max(1, len(data) // 2)]


def apply_torn_write(path: Path, data: bytes, point: str,
                     detail: str) -> None:
    """Implement a ``torn_write`` firing at an atomic-write site: clobber
    the *target* (non-atomically, as a real torn overwrite would) with a
    truncated prefix, then simulate the crash."""
    Path(path).write_bytes(torn_bytes(data))
    raise InjectedCrash(point, f"torn write of {detail}")
