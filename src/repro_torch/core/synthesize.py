"""Top-level proxy-app synthesis pipeline (paper Fig. 1).

Port of :mod:`repro.core.synthesize` (single-trace synthesis)::

    trace → columnar TraceStore → compute-event clustering → per-rank
    Sequitur grammars → inter-process merge → block-combination fit →
    code generation → ProxyProgram on ``device``

One call::

    res = synthesize(store=TraceStore.load("trace.npz"))
    res.proxy.run_all()
    print(res.stats["compression_ratio"], res.fidelity(sample_ranks=None).mean)

or, from a per-rank torch program whose collectives are the wrappers of
:mod:`repro_torch.sharding.collectives`::

    res = synthesize(step, u, w, axis_sizes={"x": 8})

The program is walked on meta tensors (:func:`~repro_torch.core.tracer.
trace_fn_store`): nothing of it runs, on any device.  The front half
(clustering, grammars, merge) is the reference's numpy code, copied; the
fit and the replay run on ``device`` (``None`` means the CUDA card).
Corpus synthesis is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import noise as noise_mod
from repro_torch.core import proxy_search
from repro_torch.core.codegen import generate_source
from repro_torch.core.events import Event, is_comm
from repro_torch.core.grammar import Grammar, TerminalTable
from repro_torch.core.interproc import MergedProgram
from repro_torch.core.replay import ProxyProgram, load_module
from repro_torch.core.trace_ir import TraceStore, compress_store
from repro_torch.core.tracer import trace_fn_store
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SynthesisResult:
    proxy: ProxyProgram
    merged: MergedProgram
    grammars: list[Grammar]
    store: TraceStore
    rank_ids: list[list[int]]
    fits: dict[int, proxy_search.FitResult]
    stats: dict

    @property
    def source(self) -> str:
        return self.proxy.source

    def fidelity(self, sample_ranks: int | None = 16, batched: bool = True):
        """δ̄ report against the columnar store (paper eq. 8)."""
        keys = [[g.table[i].key() for i in ids]
                for g, ids in zip(self.grammars, self.rank_ids)]
        return self.proxy.fidelity(self.store, keys,
                                   sample_ranks=sample_ranks, batched=batched)


def compress_rank_traces(rank_traces: Sequence[Sequence[Event]],
                         rel_tol: float = 0.05,
                         threshold: float = 0.5,
                         ) -> tuple[list[Grammar], MergedProgram,
                                    list[list[int]], dict[int, np.ndarray]]:
    """Cluster compute events jointly, build per-rank grammars, merge."""
    store = TraceStore.from_rank_traces(rank_traces)
    return compress_store(store, rel_tol, threshold)


def _fit_terminals(table: TerminalTable, reps: dict[int, np.ndarray],
                   solver: str, count_scale: float, device=None,
                   ) -> tuple[dict[int, proxy_search.FitResult],
                              dict[int, tuple], str]:
    """Block-combination search, one fit per unique compute terminal.

    ``solver="pgd"`` solves every target in one batched program on
    ``device``; ``"nnls"`` runs the exact active-set solver per target on
    the host."""
    targets, gids = [], []
    for gid, ev in enumerate(table.events):
        if not is_comm(ev):
            t = np.asarray(reps[ev.cluster_id] if ev.cluster_id >= 0
                           else ev.vector) * count_scale
            targets.append(t)
            gids.append(gid)
    solver = proxy_search.choose_solver(len(targets), solver)
    fits: dict[int, proxy_search.FitResult] = {}
    combos: dict[int, tuple] = {}
    if solver == "pgd" and targets:
        for gid, fr in zip(gids, proxy_search.fit_batch(np.stack(targets),
                                                        device=device)):
            fits[gid] = fr
            combos[gid] = (tuple(int(v) for v in fr.x), fr.unroll)
    else:
        for gid, t in zip(gids, targets):
            fr = proxy_search.fit_combination(t)
            fits[gid] = fr
            combos[gid] = (tuple(int(v) for v in fr.x), fr.unroll)
    return fits, combos, solver


def _assemble_result(store: TraceStore, grammars, merged, rank_ids, fits,
                     combos, solver: str, name: str,
                     axis_sizes: dict[str, int], count_scale: float,
                     out_dir, noise_model: "noise_mod.NoiseModel | None" = None,
                     device=None) -> SynthesisResult:
    """Program-table codegen + module load + stats (the reference's
    unrolled emitter is not ported)."""
    noise_models = (noise_model.terminal_params(merged.table.events)
                    if noise_model is not None else None)
    source = generate_source(merged, combos, name, axis_sizes,
                             count_scale=count_scale, noise_models=noise_models)
    module = load_module(source, name=f"{name}_mod", out_dir=out_dir)
    proxy = ProxyProgram(source, module, merged, combos, axis_sizes,
                         device=device)

    trace_bytes = store.raw_trace_bytes()
    grammar_bytes = merged.encoded_size_bytes()
    fit_errs = [float(np.mean(f.per_metric_rel_err[f.target > 0]))
                for f in fits.values() if np.any(f.target > 0)]
    stats = {
        "n_ranks": store.n_ranks,
        "n_events": store.n_events,
        "n_signature_groups": len(module.SIGNATURE_GROUPS),
        "n_unique_terminals": len(merged.table),
        "n_rules": len(merged.rules),
        "trace_bytes": trace_bytes,
        "grammar_bytes": grammar_bytes,
        "compression_ratio": trace_bytes / max(grammar_bytes, 1),
        "source_lines": source.count("\n") + 1,
        "codegen": "table",
        "solver": solver,
        "mean_fit_rel_err": float(np.mean(fit_errs)) if fit_errs else 0.0,
        "max_fit_rel_err": float(np.max(fit_errs)) if fit_errs else 0.0,
    }
    return SynthesisResult(proxy=proxy, merged=merged, grammars=grammars,
                           store=store, rank_ids=rank_ids, fits=fits,
                           stats=stats)


def synthesize(fn: Callable | None = None, *args,
               rank_traces: Sequence[Sequence[Event]] | None = None,
               store: TraceStore | None = None,
               axis_sizes: dict[str, int] | None = None,
               name: str = "proxy",
               rel_tol: float = 0.05,
               threshold: float = 0.5,
               solver: str = "auto",
               count_scale: float = 1.0,
               out_dir=None,
               device=None) -> SynthesisResult:
    """Synthesize a proxy-app from a per-rank program ``fn(*args)``, from
    pre-recorded traces, or from a saved columnar :class:`TraceStore`
    (``TraceStore.load(path)``: the reference's ``.npz`` format, unchanged).
    ``axis_sizes`` gives the mesh axes ``fn``'s collectives name.

    ``solver="auto"`` picks exact NNLS up to
    :data:`~repro_torch.core.proxy_search.PGD_TERMINAL_THRESHOLD` distinct
    compute terminals and the batched PGD program above it.
    ``count_scale`` < 1 shrinks the fitted block counts proportionally.
    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU.
    """
    device = resolve_device(device)
    if store is None:
        if rank_traces is not None:
            store = TraceStore.from_rank_traces(rank_traces, axis_sizes)
        elif fn is not None:
            store = trace_fn_store(fn, *args, axis_sizes=axis_sizes)
        else:
            raise ValueError("need fn, rank_traces or store")
    axis_sizes = dict(store.axis_sizes if axis_sizes is None else axis_sizes)

    grammars, merged, rank_ids, reps = compress_store(store, rel_tol,
                                                      threshold)
    fits, combos, solver = _fit_terminals(merged.table, reps, solver,
                                          count_scale, device)
    # same rel_tol → same cluster assignment as compress_store, so the
    # calibrated σ keys line up with the merged table's cluster ids
    noise_model = noise_mod.calibrate(store, rel_tol=rel_tol)
    return _assemble_result(store, grammars, merged, rank_ids, fits, combos,
                            solver, name, axis_sizes, count_scale, out_dir,
                            noise_model=noise_model, device=device)
