"""Reference unrolled code generator (paper §2.7, Algorithm 2) — oracle.

Port of :mod:`repro.core.codegen_reference`: the per-symbol emitter, which
writes one torch statement per grammar symbol (a terminal calls
``_blocks.run_combo`` or the comm backend, then ``_noise.perturb``; a
symbol with an exponent calls ``replay.rep``), non-terminals as functions,
main rules as per-cluster drivers with rank-set guards.  The output is
trivially auditable — the generated source *is* the grammar, unrolled —
which is what makes it the parity oracle of the program-table flavor
(:mod:`repro_torch.core.codegen`): both must give **bit-identical δ̄**,
**identical per-rank comm sequences** and, with noise, bit-identical
distributions (``tests/test_torch_codegen_flavors.py``).

Shared pure-metadata helpers (rank-set formatting, signature grouping,
device hints, guard-run computation, the ``NOISE_MODELS`` block) come from
the port's :mod:`repro_torch.core.codegen`, so both flavors emit identical
``SIGNATURE_GROUPS`` / ``CLUSTER_RANKS`` / ``_GUARDS`` / ``NOISE_MODELS``
metadata by construction.  The generated module imports only
``repro_torch``.
"""
from __future__ import annotations

import textwrap
from typing import Mapping

from repro_torch.core.codegen import (
    _comm_buffers, _fmt_rankset, _fmt_ranktuple, _main_runs,
    _noise_models_block, _syms_comm_axes, _topo_order,
    compute_signature_groups, group_device_hint,
)
from repro_torch.core.events import is_comm
from repro_torch.core.interproc import MergedProgram


def generate_source(merged: MergedProgram,
                    combos: Mapping[int, tuple],
                    name: str = "proxy",
                    axis_sizes: Mapping[str, int] | None = None,
                    count_scale: float = 1.0,
                    noise_models=None) -> str:
    """Emit the unrolled proxy-app module source (one statement/symbol)."""
    axis_sizes = dict(axis_sizes or {})
    L: list[str] = []
    w = L.append

    w(f'"""Auto-generated performance proxy ({name}).')
    w("")
    w("Synthesized by repro_torch.core (PyTorch port): the collective skeleton is a")
    w("lossless replay of the traced program; compute segments are QP-fitted")
    w("block combinations.  Unrolled reference flavor (codegen_reference).")
    w("Do not edit."  '"""')
    w("from repro_torch.core import blocks as _blocks")
    w("from repro_torch.core import noise as _noise")
    w("from repro_torch.core.replay import rep as _rep")
    w("")
    w("CODEGEN = 'unrolled'")
    w(f"N_RANKS = {merged.n_ranks}")
    w(f"AXIS_SIZES = {dict(axis_sizes)!r}")

    # -- comm buffer pool (one per distinct payload shape/dtype) --------------
    bufs = _comm_buffers(merged)
    w("COMM_BUFFERS = {")
    for (shape, dtype), bname in bufs.items():
        w(f"    {bname!r}: ({shape!r}, {dtype!r}),")
    w("}")
    w("ALL = frozenset(range(N_RANKS))")
    w("")

    # -- noise params (shared table + this flavor's compact cost descs) --------
    # _NOISE_DESCS is the unrolled twin of the table flavor's TERMINALS for
    # noise lowering only: comm terminals carry just the payload bytes,
    # compute terminals their (x, unroll) combo — enough for
    # noise.lower_params to bind identical LoweredNoise records in both
    # flavors (the bit-parity prerequisite).
    w(_noise_models_block(merged, noise_models))
    w("_NOISE_DESCS = (")
    for gid, ev in enumerate(merged.table.events):
        if is_comm(ev):
            w(f"    ('comm', {int(ev.payload_bytes)}),  # t{gid}")
        else:
            combo = combos.get(gid)
            if combo is None:
                raise KeyError(f"no block combo for compute terminal {gid}")
            x, unroll = combo
            w(f"    ('compute', {tuple(int(v) for v in x)!r}, "
              f"{int(unroll)}),  # t{gid}")
    w(")")
    w("_NZ = _noise.lower_params(NOISE_MODELS, _NOISE_DESCS)")
    w("")

    # -- terminals -------------------------------------------------------------
    for gid, ev in enumerate(merged.table.events):
        if is_comm(ev):
            bname = bufs[(ev.shape, ev.dtype)]
            w(f"def t{gid}(st, comm):  # {ev.kind} {ev.dtype}{list(ev.shape)} over {ev.axes}")
            w(f"    st = comm.do(st, {bname!r}, kind={ev.kind!r}, "
              f"axes={ev.axes!r}, detail={ev.detail!r}, "
              f"shape={ev.shape!r}, dtype={ev.dtype!r})")
        else:
            combo = combos.get(gid)
            if combo is None:
                raise KeyError(f"no block combo for compute terminal {gid}")
            x, unroll = combo
            w(f"def t{gid}(st, comm):  # MPI_Compute proxy, cluster {ev.cluster_id}")
            w(f"    st = _blocks.run_combo(st, {tuple(int(v) for v in x)!r}, "
              f"unroll={int(unroll)})")
        w(f"    return _noise.perturb(st, _NZ[{gid}])")
        w("")

    # -- non-terminals (children before parents) -------------------------------
    order = _topo_order(merged.rules)
    for rid in order:
        w(f"def r{rid}(st, comm):")
        body = merged.rules[rid]
        if not body:
            w("    return st")
            w("")
            continue
        for kind, ref, exp in body:
            fn = f"t{ref}" if kind == "t" else f"r{ref}"
            if exp == 1:
                w(f"    st = {fn}(st, comm)")
            else:
                w(f"    st = _rep({fn}, {exp}, st, comm)")
        w("    return st")
        w("")

    # -- main rules with rank-set guards ----------------------------------------
    runs_per_cluster = _main_runs(merged)
    guards_meta: list[list[str]] = []
    cluster_runs: list[list[frozenset | None]] = []   # None == unguarded run
    for ci, (runs, cranks) in enumerate(zip(runs_per_cluster,
                                            merged.cluster_ranks)):
        w(f"def main{ci}(st, comm, rank):")
        if not runs:
            w("    return st")
            w("")
            guards_meta.append([])
            cluster_runs.append([])
            continue
        meta = []
        for rs, syms in runs:
            full = rs >= cranks
            indent = "    "
            if not full:
                w(f"    if rank in {_fmt_rankset(rs, merged.n_ranks)}:")
                indent = "        "
            for kind, ref, exp in syms:
                fn = f"t{ref}" if kind == "t" else f"r{ref}"
                if exp == 1:
                    w(f"{indent}st = {fn}(st, comm)")
                else:
                    w(f"{indent}st = _rep({fn}, {exp}, st, comm)")
            meta.append("None" if full else _fmt_rankset(rs, merged.n_ranks))
        w("    return st")
        w("")
        guards_meta.append(meta)
        cluster_runs.append([None if rs >= cranks else rs for rs, _ in runs])

    # -- driver + signature -------------------------------------------------------
    w("CLUSTER_RANKS = (")
    for cr in merged.cluster_ranks:
        w(f"    {_fmt_rankset(cr, merged.n_ranks)},")
    w(")")
    w("_MAINS = (" + ", ".join(f"main{i}" for i in range(len(merged.mains)))
      + ("," if len(merged.mains) == 1 else "") + ")")
    w("_GUARDS = (")
    for meta in guards_meta:
        w("    (" + ", ".join(meta) + ("," if len(meta) == 1 else "") + "),")
    w(")")
    w("")

    # -- signature-group metadata (batched replay, §3.3) -----------------------
    sig_groups = compute_signature_groups(merged.cluster_ranks, cluster_runs,
                                          merged.n_ranks)
    run_axes = [[_syms_comm_axes(syms, merged.rules, merged.table)
                 for _, syms in runs] for runs in runs_per_cluster]
    w("#: (signature, ranks, device_hint) triples; every rank appears in")
    w("#: exactly one group.")
    w("SIGNATURE_GROUPS = (")
    for sig, ranks in sig_groups:
        hint = group_device_hint(sig, run_axes, axis_sizes, count_scale)
        w(f"    ({sig!r}, {_fmt_ranktuple(ranks)}, {hint}),")
    w(")")
    w("")
    w(textwrap.dedent("""\
        def run_rank(st, comm, rank):
            \"\"\"Execute rank ``rank``'s proxy program (host-level dispatch).\"\"\"
            for ranks, fn in zip(CLUSTER_RANKS, _MAINS):
                if rank in ranks:
                    st = fn(st, comm, rank)
            return st


        def program_signature(rank):
            \"\"\"Hashable per-rank control-flow signature (jit dedupe key).\"\"\"
            sig = []
            for ci, (ranks, guards) in enumerate(zip(CLUSTER_RANKS, _GUARDS)):
                if rank in ranks:
                    sig.append((ci, tuple(i for i, g in enumerate(guards)
                                          if g is None or rank in g)))
            return tuple(sig)
    """))
    return "\n".join(L)
