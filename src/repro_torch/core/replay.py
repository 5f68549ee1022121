"""Proxy replay engine + fidelity measurement (paper §3.3).

Port of :mod:`repro.core.replay` (LocalSim replay and seeded noisy
replicas; the mesh sweep is not ported yet).

``rep`` is the run-length replay primitive used by generated code: small
exponents unroll, large ones become a counted loop, so the walker costs a
loop that ran 10^6 times in one walk of its body — the grammar's a^i
symbols.

:class:`ProxyProgram` wraps a generated module:

  * ``run_local(ranks)`` replays ranks one at a time;
  * ``run_all(ranks)`` replays by control-flow signature group (the module
    precomputes ``SIGNATURE_GROUPS``): with the shared seed, every rank of
    a group is the same program on the same state, so the group runs once
    and its ranks share the result; with ``per_rank_seeds`` the group's
    states are stacked on a leading rank axis and replayed in one pass (the
    reference's ``vmap``);
  * ``rank_metrics(rank)`` walks the generated code with the same cost
    walker used on the original program (cached per signature);
  * ``fidelity(original)`` computes δ̄ = mean_{m,p} |A-B|/A (paper eq. 8);
  * ``noise=NoiseConfig(...)`` on ``run_all``, ``time_all`` and
    ``fidelity`` replays ``n_replicas`` seeded noisy replicas of each
    signature group, stacked on a leading replica axis in one pass (see
    :mod:`repro_torch.core.noise`); ``fidelity`` then returns a
    :class:`~repro_torch.core.noise.FidelityDistribution`.

State lives on ``device``: ``None`` means the CUDA card, where blocks 1
and 3 run as the hand-written kernels.  Replay is eager PyTorch, so there
is no compile step; the caches keep one bound program per (signature, comm
backend, state shapes) and one walker measurement per (signature, state
shapes), and ``cache_stats()`` reports them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
import tempfile
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import blocks
from repro_torch.core import noise as noise_mod
from repro_torch.core import proxy_search
from repro_torch.core.events import Event, METRIC_NAMES, N_METRICS, is_comm
from repro_torch.core.noise import (FidelityDistribution,  # noqa: F401
                                    NoiseConfig)
from repro_torch.core.metrics import torch_dtype
from repro_torch.core.tracer import counted_loop, trace_fn
from repro_torch.device import resolve_device
from repro_torch.sharding.collectives import LocalSim

#: Exponents up to this unroll; above it ``rep`` runs a counted loop (one
#: walk of the body regardless of n).  Shared with the program-table
#: lowering in :mod:`repro_torch.core.progtable`.
REP_UNROLL_THRESHOLD = 4


def rep(fn, n: int, st: dict, comm) -> dict:
    """Repeat ``fn`` n times: unrolled when small, a counted loop otherwise."""
    if n <= REP_UNROLL_THRESHOLD:
        for _ in range(n):
            st = fn(st, comm)
        return st
    return counted_loop(n, lambda s: fn(s, comm), st)


def load_saved_module(path, name: str | None = None):
    """Re-import a previously generated proxy module from disk."""
    path = Path(path)
    name = name or path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    mod.__proxy_path__ = str(path)
    return mod


def load_module(source: str, name: str = "generated_proxy",
                out_dir: str | Path | None = None):
    """Write generated source to a file and import it as a module."""
    out_dir = Path(out_dir) if out_dir else Path(tempfile.mkdtemp(prefix="proxy_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.py"
    path.write_text(source)
    return load_saved_module(path, name)


def init_replay_state(module, seed: int = 0, device=None) -> dict:
    """Block state + the generated module's comm buffer pool, on ``device``
    (``None``: the CUDA card)."""
    st = blocks.init_state(seed, device)
    dev = st["a"].device
    for bname, (shape, dtype) in module.COMM_BUFFERS.items():
        st[bname] = torch.full(tuple(shape), 0.5, dtype=torch_dtype(dtype),
                               device=dev)
    return st


def stack_states(states: Sequence[dict]) -> dict:
    """Stack per-rank states on a new leading rank axis."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


@dataclasses.dataclass
class FidelityReport:
    """Per-(metric, rank) relative errors (paper Table 3 / Fig. 4)."""
    delta: np.ndarray          # (n_metrics, n_ranks)
    comm_lossless: bool        # event-id sequences reproduced exactly
    mean: float                # δ̄, paper eq. 8
    seed: int = 0              # replay seed provenance (deterministic: 0)
    n_replicas: int = 1        # deterministic replay is one replica

    def heatmap_csv(self) -> str:
        lines = ["metric," + ",".join(f"rank{p}"
                                      for p in range(self.delta.shape[1]))]
        for m, name in enumerate(METRIC_NAMES):
            lines.append(name + "," + ",".join(f"{v:.4f}"
                                               for v in self.delta[m]))
        return "\n".join(lines)

    def to_csv(self) -> str:
        """Heatmap CSV with seed/replica provenance headers, parseable by
        :func:`repro_torch.core.noise.parse_fidelity_csv` like
        :meth:`FidelityDistribution.to_csv`."""
        return (f"# seed={self.seed}\n# n_replicas={self.n_replicas}\n"
                + self.heatmap_csv())


class ProxyProgram:
    """A synthesized proxy-app: source + module + replay/fidelity methods."""

    def __init__(self, source: str, module, merged, combos,
                 axis_sizes: dict[str, int] | None = None, device=None):
        self.source = source
        self.module = module
        self.merged = merged
        self.combos = combos
        self.axis_sizes = dict(axis_sizes or {})
        self.device = resolve_device(device)
        self._compiled: dict = {}          # (sig, comm, shapes) -> per-rank fn
        self._metrics_cache: dict = {}     # (sig, shapes) -> np.ndarray
        self._sig_by_rank: dict | None = None
        self._shapes_key_cache = None
        self._counters = {"programs_bound": 0, "metric_traces": 0}

    # -- signature grouping ----------------------------------------------------

    def signature_of(self, rank: int):
        """Control-flow signature of ``rank`` (hashable cache key)."""
        if self._sig_by_rank is None:
            self._sig_by_rank = {r: g[0] for g in self.module.SIGNATURE_GROUPS
                                 for r in g[1]}
        return self._sig_by_rank[rank]

    def _validate_ranks(self, ranks: Sequence[int]) -> None:
        bad = [r for r in ranks if not 0 <= r < self.merged.n_ranks]
        if bad:
            raise ValueError(f"ranks out of range: {bad} "
                             f"(proxy has {self.merged.n_ranks} ranks)")

    def signature_groups(self, ranks: Sequence[int] | None = None,
                         ) -> list[tuple[tuple, list[int]]]:
        """(signature, ranks) pairs covering ``ranks`` (default: all), from
        the module's ``SIGNATURE_GROUPS`` (entries ``(sig, ranks, hint)``)."""
        groups = self.module.SIGNATURE_GROUPS
        if ranks is None:
            return [(g[0], list(g[1])) for g in groups]
        want = set(ranks)
        out = [(g[0], [r for r in g[1] if r in want]) for g in groups]
        out = [(sig, rs) for sig, rs in out if rs]
        missing = want - {r for _, rs in out for r in rs}
        if missing:
            raise ValueError(
                f"ranks not in any signature group: {sorted(missing)} "
                f"(proxy has {self.merged.n_ranks} ranks)")
        return out

    def _shapes_key(self) -> tuple:
        """State-shape fingerprint: part of every cache key."""
        if self._shapes_key_cache is None:
            st = init_replay_state(self.module, device="meta")
            self._shapes_key_cache = tuple(
                sorted((k, tuple(v.shape), str(v.dtype)) for k, v in st.items()))
        return self._shapes_key_cache

    def init_state(self, seed: int = 0) -> dict:
        return init_replay_state(self.module, seed, self.device)

    # -- execution -------------------------------------------------------------

    @staticmethod
    def _comm_key(comm):
        """Cache component for the comm backend: plain LocalSims are
        interchangeable; anything else is keyed by identity."""
        return LocalSim if type(comm) is LocalSim else id(comm)

    def _fn_for_rank(self, rank: int, comm):
        sig = self.signature_of(rank)
        key = (sig, self._comm_key(comm), self._shapes_key())
        fn = self._compiled.get(key)
        if fn is None:
            mod = self.module
            self._counters["programs_bound"] += 1

            def fn(st, _rank=rank):
                return mod.run_rank(st, comm, _rank)

            self._compiled[key] = fn
        return fn

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_local(self, ranks: Sequence[int] | None = None, seed: int = 0,
                  comm=None) -> dict:
        """Replay ranks sequentially; returns the final state of the last."""
        comm = comm or LocalSim()
        if ranks is None:
            ranks = range(self.merged.n_ranks)
        else:
            self._validate_ranks(ranks)
        st = self.init_state(seed)
        out = st
        for r in ranks:
            out = self._fn_for_rank(r, comm)(st)
        self._sync()
        return out

    def run_all(self, ranks: Sequence[int] | None = None, seed: int = 0,
                comm=None, batched: bool = True,
                per_rank_seeds: bool = False,
                noise: NoiseConfig | None = None) -> dict[int, dict]:
        """Replay every rank; returns ``{rank: final state}``.

        ``batched=True`` replays one signature group per pass: with the
        shared seed the group's program runs once and every rank of the
        group gets its own dict over the same result tensors (replay never
        writes a tensor in place, so the sharing is not observable as
        cross-rank mutation); with ``per_rank_seeds=True`` each rank starts
        from ``seed + rank``, the group's states are stacked on a leading
        axis and replayed in one pass.  ``batched=False`` is the per-rank
        baseline with identical results.

        ``noise=NoiseConfig(...)`` replays ``n_replicas`` seeded noisy
        replicas of each group, stacked on a leading axis in one pass
        (``noise=None`` runs the deterministic program unchanged).  Every
        leaf of a rank's result then carries the replica axis; ranks of a
        group share the replicas (the noise models run-level platform
        state, not per-rank jitter), and the
        :data:`~repro_torch.core.noise.NOISE_COMPUTE` /
        :data:`~repro_torch.core.noise.NOISE_COMM` leaves hold the
        perturbed cost accumulators :meth:`fidelity` summarizes."""
        if ranks is not None:
            self._validate_ranks(ranks)
        _check_noise(noise, batched, per_rank_seeds)
        comm = comm or LocalSim()
        out: dict[int, dict] = {}
        if not batched:
            st = None if per_rank_seeds else self.init_state(seed)
            for r in (range(self.merged.n_ranks) if ranks is None else ranks):
                out[r] = self._fn_for_rank(r, comm)(
                    self.init_state(seed + r) if per_rank_seeds else st)
            self._sync()
            return out
        for fn, arg, grp in self._group_work(ranks, seed, comm, per_rank_seeds,
                                             noise):
            res = fn(arg)
            if per_rank_seeds:
                for i, r in enumerate(grp):
                    out[r] = {k: v[i] for k, v in res.items()}
            else:   # one result for the group (noisy replicas too)
                for r in grp:
                    out[r] = dict(res)
        self._sync()
        return out

    def _noise_group_state(self, rep_rank: int, cfg: NoiseConfig,
                           seed: int = 0) -> dict:
        """``n_replicas`` noise-attached copies of one group's initial state,
        stacked on a leading replica axis.  Replica keys derive only from
        ``(cfg.seed, group representative, replica index)``."""
        base = self.init_state(seed)
        return stack_states([
            noise_mod.attach(base, noise_mod.replica_key(
                cfg.seed, rep_rank, j, self.device))
            for j in range(cfg.n_replicas)])

    def _group_work(self, ranks, seed: int, comm, per_rank_seeds: bool,
                    noise: NoiseConfig | None = None) -> list[tuple]:
        """One ``(fn, input_state, group_ranks)`` unit per signature group —
        the shared plan of :meth:`run_all` and :meth:`time_all`.  With
        ``noise=``, a unit replays the group's stacked noisy replicas and
        settles their draws (:func:`~repro_torch.core.noise.settle`)."""
        if noise is not None:
            work = []
            for sig, grp in self.signature_groups(ranks):
                fn = self._fn_for_rank(grp[0], comm)
                work.append((lambda st, fn=fn: noise_mod.settle(fn(st)),
                             self._noise_group_state(grp[0], noise, seed),
                             grp))
            return work
        st = None if per_rank_seeds else self.init_state(seed)
        work = []
        for sig, grp in self.signature_groups(ranks):
            fn = self._fn_for_rank(grp[0], comm)
            if per_rank_seeds:
                stacked = stack_states([self.init_state(seed + r) for r in grp])
                work.append((fn, stacked, grp))
            else:
                work.append((fn, st, grp))
        return work

    def time_all(self, ranks: Sequence[int] | None = None, iters: int = 1,
                 seed: int = 0, batched: bool = True,
                 per_rank_seeds: bool = False,
                 noise: NoiseConfig | None = None) -> float:
        """Warm wall-clock seconds of one full multi-rank replay sweep, in
        :meth:`run_all`'s modes, the noisy replicas among them (the states
        are built before the clock)."""
        ranks = list(range(self.merged.n_ranks) if ranks is None else ranks)
        self._validate_ranks(ranks)
        _check_noise(noise, batched, per_rank_seeds)
        comm = LocalSim()
        if batched:
            work = [(fn, arg) for fn, arg, _ in
                    self._group_work(ranks, seed, comm, per_rank_seeds,
                                     noise)]
        else:
            st = None if per_rank_seeds else self.init_state(seed)
            work = [(self._fn_for_rank(r, comm),
                     self.init_state(seed + r) if per_rank_seeds else st)
                    for r in ranks]

        def sweep():
            for fn, arg in work:
                fn(arg)
            self._sync()

        sweep()  # warm-up (first use builds the kernels)
        t0 = time.perf_counter()
        for _ in range(iters):
            sweep()
        return (time.perf_counter() - t0) / iters

    def cache_stats(self) -> dict[str, int]:
        """Bound-program and walker-measurement counters."""
        return dict(self._counters,
                    compiled_per_rank=len(self._compiled),
                    cached_metric_groups=len(self._metrics_cache))

    # -- measurement -------------------------------------------------------------

    def rank_metrics(self, rank: int, use_cache: bool = True) -> np.ndarray:
        """Walker-measured 6-metric total of this rank's generated program
        (cached per signature: ranks of a group run the same program)."""
        key = (self.signature_of(rank), self._shapes_key())
        if use_cache and key in self._metrics_cache:
            return self._metrics_cache[key]
        st = init_replay_state(self.module, device="meta")
        comm = LocalSim()
        self._counters["metric_traces"] += 1
        tr = trace_fn(lambda s: self.module.run_rank(s, comm, rank), st)
        out = tr.total_compute()
        self._metrics_cache[key] = out
        return out

    def expand_rank_ids(self, rank: int) -> list[int]:
        return self.merged.expand_rank(rank)

    def _noise_totals(self, ranks: Sequence[int], cfg: NoiseConfig
                      ) -> tuple[dict, dict]:
        """Executed perturbed cost totals per rank: ``(compute, comm_bytes)``
        with ``compute[r]`` the ``(n_replicas, 6)`` float64 accumulator
        matrix and ``comm_bytes[r]`` the ``(n_replicas,)`` perturbed
        collective bytes.  The walker cannot see runtime randomness, so the
        noisy path executes the replicas and reads the accumulators."""
        pending = [(fn(arg), grp) for fn, arg, grp in
                   self._group_work(ranks, 0, LocalSim(), False, cfg)]
        compute: dict[int, np.ndarray] = {}
        comm_bytes: dict[int, np.ndarray] = {}
        for res, grp in pending:
            acc = res[noise_mod.NOISE_COMPUTE].cpu().numpy()
            cb = res[noise_mod.NOISE_COMM].cpu().numpy()
            for r in grp:       # replicas are group-level; ranks share them
                compute[r] = acc
                comm_bytes[r] = cb
        return compute, comm_bytes

    def fidelity(self, original_rank_traces: Sequence[Sequence[Event]],
                 original_rank_keys: Sequence[Sequence[str]] | None = None,
                 sample_ranks: int | None = None,
                 batched: bool = True, noise: NoiseConfig | None = None,
                 ) -> "FidelityReport | FidelityDistribution":
        """Compare proxy vs original per rank (paper §3.3.1).

        ``original_rank_traces`` is per-rank Event lists or a columnar
        :class:`~repro_torch.core.trace_ir.TraceStore`.  Compute metrics:
        walker totals of the generated code against the original's compute
        totals.  Communication: the merged grammar must expand to the
        original event *key* sequence exactly (losslessness).
        ``batched=False`` re-walks every rank (the parity baseline).

        ``noise=NoiseConfig(...)`` returns a
        :class:`~repro_torch.core.noise.FidelityDistribution` instead: the
        proxy side becomes the *executed* perturbed-cost accumulators of
        ``n_replicas`` seeded replicas, each replica's δ matrix computed
        against the same original totals.  A fixed ``(seed, n_replicas)``
        reproduces bit for bit on one device.  The σ→0 limit of the
        executed totals tracks, but is not bit-equal to, the walker's (the
        accumulators sum ``combo_cost`` per occurrence and charge no loop
        bookkeeping), so the bit-parity contract binds only the
        ``noise=None`` walker path."""
        if hasattr(original_rank_traces, "compute_totals"):
            totals = original_rank_traces.compute_totals()
            n_ranks = original_rank_traces.n_ranks
        else:
            totals = None
            n_ranks = len(original_rank_traces)
        ranks = list(range(n_ranks))
        if sample_ranks and n_ranks > sample_ranks:
            step = max(n_ranks // sample_ranks, 1)
            ranks = ranks[::step][:sample_ranks]
        lossless = True
        if original_rank_keys is not None:
            for r in range(n_ranks):
                got = [self.merged.table[i].key()
                       for i in self.expand_rank_ids(r)]
                if list(original_rank_keys[r]) != got:
                    lossless = False
                    break
        if totals is not None:
            a = totals[ranks].T
        else:
            a = np.zeros((N_METRICS, len(ranks)))
            for col, r in enumerate(ranks):
                for ev in original_rank_traces[r]:
                    if not is_comm(ev):
                        a[:, col] += ev.vector
        if noise is not None:
            compute, comm_b = self._noise_totals(ranks, noise)
            bn = np.stack([compute[r] for r in ranks], axis=2)
            replica_delta = np.stack(
                [proxy_search.rel_error_matrix(a, bn[j])
                 for j in range(noise.n_replicas)])
            cb = np.stack([comm_b[r] for r in ranks], axis=1)
            return FidelityDistribution(
                replica_delta=replica_delta, comm_bytes=cb,
                ranks=tuple(ranks), seed=noise.seed,
                n_replicas=noise.n_replicas, comm_lossless=lossless)
        b = np.stack([self.rank_metrics(r, use_cache=batched) for r in ranks],
                     axis=1)
        delta = proxy_search.rel_error_matrix(a, b)
        return FidelityReport(delta=delta, comm_lossless=lossless,
                              mean=float(delta.mean()))


def _check_noise(noise: NoiseConfig | None, batched: bool,
                 per_rank_seeds: bool) -> None:
    """The reference's guards: the noisy replicas own the stacked axis."""
    if noise is not None and per_rank_seeds:
        raise ValueError("noise= and per_rank_seeds are mutually "
                         "exclusive (both own the stacked batch axis)")
    if noise is not None and not batched:
        raise ValueError("noise= requires the batched replay path "
                         "(replicas ride the stacked group axis)")
