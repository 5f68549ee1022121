"""Code generation (paper §2.7, Algorithm 2): grammar → executable source.

Port copy of :mod:`repro.core.codegen`, kept line for line so both packages build
the same grammars and tables; ``repro_torch`` imports nothing from ``repro``.

The merged grammar is emitted as a self-contained Python module carrying a
**program table** — the grammar itself, not an unrolled statement per
symbol — so the traced executable is sized O(grammar), not O(trace):

  * communication terminals → ``('comm', buf, dict(kind=..., ...))``
    descriptors carrying the exact traced parameters (kind, payload
    shape/dtype, mesh axes, permute detail) — lossless, like the paper's
    direct MPI-call emission;
  * computation terminals → ``('compute', x, unroll)`` descriptors with the
    QP-searched block counts (paper: "combine the code blocks into a
    function");
  * non-terminals → ``RULES[rid]`` bodies of ``(kind, ref, exp)`` symbols;
  * signature groups → ``GROUP_PROGRAMS[gi]``, the flattened guard-resolved
    symbol sequence each group executes.

:class:`repro_torch.core.progtable.ProgramTable` lowers the tables at import
time: run-length exponents become counted loops via
:func:`repro_torch.core.replay.rep`, nested rules become nested loops, and a
symbol sequence is a Python loop over its symbols.

The unrolled per-symbol emitter is preserved verbatim as
:mod:`repro.core.codegen_reference` — the parity oracle: both flavors must
produce bit-identical δ̄ and per-rank comm sequences (pinned by tests and
the CI parity step).  The module executes under any comm backend:
``LocalSim`` on one host, or ``DeviceComm`` inside ``shard_map`` on a real
mesh, where its lowered HLO reproduces the original program's collective
schedule.
"""
from __future__ import annotations

import textwrap
from typing import Mapping, Sequence

from repro_torch.core.events import CommEvent, ComputeEvent, is_comm
from repro_torch.core.interproc import MergedProgram


def _fmt_rankset(rs: frozenset, n_ranks: int) -> str:
    """Compact literal: ALL / range / strided range / explicit set.

    The range form needs >= 3 elements (mirroring :func:`_fmt_ranktuple`):
    a 2-element set like ``{0, 5}`` is an arithmetic progression too, but
    ``frozenset(range(0, 6, 5))`` is opaque where ``frozenset((0, 5,))``
    is obvious, and saves nothing."""
    if len(rs) == n_ranks:
        return "ALL"
    s = sorted(rs)
    if len(s) >= 3:
        step = s[1] - s[0]
        if step > 0 and all(b - a == step for a, b in zip(s, s[1:])):
            return f"frozenset(range({s[0]}, {s[-1] + 1}, {step}))" if step > 1 \
                else f"frozenset(range({s[0]}, {s[-1] + 1}))"
    return "frozenset((" + ", ".join(map(str, s)) + ",))"


# ---------------------------------------------------------------------------
# shared structural computation (table emitter + unrolled reference)
# ---------------------------------------------------------------------------


def _comm_buffers(merged: MergedProgram) -> dict[tuple, str]:
    """Comm buffer pool: one buffer per distinct payload (shape, dtype)."""
    bufs: dict[tuple, str] = {}
    for ev in merged.table.events:
        if is_comm(ev):
            key = (ev.shape, ev.dtype)
            if key not in bufs:
                bufs[key] = f"buf{len(bufs)}"
    return bufs


def _main_runs(merged: MergedProgram) -> list[list[tuple[frozenset, list]]]:
    """Per-cluster guard runs: consecutive main symbols sharing a rank set
    are grouped (Alg. 2 lines 15-18), preserving symbol order."""
    out: list[list[tuple[frozenset, list]]] = []
    for main in merged.mains:
        runs: list[tuple[frozenset, list]] = []
        for kind, ref, exp, rs in main:
            if runs and runs[-1][0] == rs:
                runs[-1][1].append((kind, ref, exp))
            else:
                runs.append((rs, [(kind, ref, exp)]))
        out.append(runs)
    return out


def generate_source(merged: MergedProgram,
                    combos: Mapping[int, tuple],
                    name: str = "proxy",
                    axis_sizes: Mapping[str, int] | None = None,
                    count_scale: float = 1.0,
                    noise_models: Sequence[tuple[float, float]] | None = None,
                    ) -> str:
    """Emit the grammar-compiled proxy-app module source.

    ``combos[gid]`` is ``(x, unroll)`` — the 11-int loop-turn vector and the
    block-instances-per-turn factor — for the compute terminal with global
    id ``gid`` (one per compute-event cluster, paper §2.4).

    ``count_scale`` is the time-dilation factor the block counts were
    fitted with; the per-group device hints in ``SIGNATURE_GROUPS`` scale
    with it (see :func:`group_device_hint`), so a 1/20-dilated proxy does
    not claim the full traced collective span per group.

    ``noise_models`` is the per-terminal ``(sigma, shift)`` table from
    :meth:`repro_torch.core.noise.NoiseModel.terminal_params` (aligned with
    ``TERMINALS``); ``None`` emits an all-zeros table (unit factors).
    The table is inert unless replay opts in with ``noise=NoiseConfig``.
    """
    axis_sizes = dict(axis_sizes or {})
    L: list[str] = []
    w = L.append

    w(f'"""Auto-generated performance proxy ({name}).')
    w("")
    w("Synthesized by repro_torch.core (PyTorch port): the collective skeleton is a")
    w("lossless replay of the traced program; compute segments are QP-fitted")
    w("block combinations.  Grammar-compiled flavor: the tables below ARE the")
    w("merged grammar; repro_torch.core.progtable lowers them to loop nests")
    w("sized O(grammar).  Do not edit."  '"""')
    w("from repro_torch.core.progtable import ProgramTable as _ProgramTable")
    w("from repro_torch.core.progtable import expand_symbols as _expand_symbols")
    w("")
    w("CODEGEN = 'table'")
    w(f"N_RANKS = {merged.n_ranks}")
    w(f"AXIS_SIZES = {dict(axis_sizes)!r}")

    bufs = _comm_buffers(merged)
    w("COMM_BUFFERS = {")
    for (shape, dtype), bname in bufs.items():
        w(f"    {bname!r}: ({shape!r}, {dtype!r}),")
    w("}")
    w("ALL = frozenset(range(N_RANKS))")
    w("")

    # -- terminal descriptors --------------------------------------------------
    w("#: terminal descriptors, indexed by global terminal id; comm terminals")
    w("#: keep their exact traced parameters (lossless collective skeleton)")
    w("TERMINALS = (")
    for gid, ev in enumerate(merged.table.events):
        if is_comm(ev):
            bname = bufs[(ev.shape, ev.dtype)]
            w(f"    # t{gid}: {ev.kind} {ev.dtype}{list(ev.shape)} over {ev.axes}")
            w(f"    ('comm', {bname!r}, dict(kind={ev.kind!r}, "
              f"axes={ev.axes!r}, detail={ev.detail!r}, "
              f"shape={ev.shape!r}, dtype={ev.dtype!r})),")
        else:
            combo = combos.get(gid)
            if combo is None:
                raise KeyError(f"no block combo for compute terminal {gid}")
            x, unroll = combo
            w(f"    # t{gid}: MPI_Compute proxy, cluster {ev.cluster_id}")
            w(f"    ('compute', {tuple(int(v) for v in x)!r}, {int(unroll)}),")
    w(")")
    w("")
    w(_noise_models_block(merged, noise_models))
    w("")

    # -- rule bodies (children before parents, for readability) ---------------
    w("#: non-terminal bodies as (kind, ref, exp) symbol tuples")
    w("RULES = {")
    for rid in merged.rule_topo_order():
        body = tuple((k, int(r), int(e)) for k, r, e in merged.rules[rid])
        w(f"    {rid}: {body!r},")
    w("}")
    w("")

    # -- cluster / guard metadata (program_signature support) ------------------
    runs_per_cluster = _main_runs(merged)
    guards_meta: list[list[str]] = []
    cluster_runs: list[list[frozenset | None]] = []
    for runs, cranks in zip(runs_per_cluster, merged.cluster_ranks):
        guards_meta.append(["None" if rs >= cranks
                            else _fmt_rankset(rs, merged.n_ranks)
                            for rs, _ in runs])
        cluster_runs.append([None if rs >= cranks else rs for rs, _ in runs])
    w("CLUSTER_RANKS = (")
    for cr in merged.cluster_ranks:
        w(f"    {_fmt_rankset(cr, merged.n_ranks)},")
    w(")")
    w("_GUARDS = (")
    for meta in guards_meta:
        w("    (" + ", ".join(meta) + ("," if len(meta) == 1 else "") + "),")
    w(")")
    w("")

    # -- signature-group metadata (batched replay, §3.3) -----------------------
    # Ranks sharing a control-flow signature execute byte-identical programs,
    # so the replay engine can stack their states and run one compiled
    # executable for the whole group.  Each group carries a device-count
    # hint (see codegen_reference for the unrolled twin of this block) and —
    # table flavor only — its flattened guard-resolved symbol sequence in
    # GROUP_PROGRAMS, which ProgramTable lowers to one rolled executable.
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
    w("#: GROUP_PROGRAMS[gi]: signature group gi's flattened symbol sequence")
    w("GROUP_PROGRAMS = (")
    for sig, _ranks in sig_groups:
        prog: list[tuple] = []
        for ci, run_ids in sig:
            for i in run_ids:
                prog.extend((k, int(r), int(e))
                            for k, r, e in runs_per_cluster[ci][i][1])
        w(f"    {tuple(prog)!r},")
    w(")")
    w("")
    w("_PT = _ProgramTable(TERMINALS, RULES, GROUP_PROGRAMS, "
      "noise=NOISE_MODELS)")
    w("_GROUP_INDEX = {r: gi for gi, g in enumerate(SIGNATURE_GROUPS)")
    w("                for r in g[1]}")
    w("")
    w(textwrap.dedent("""\
        def run_rank(st, comm, rank):
            \"\"\"Execute rank ``rank``'s proxy program (grammar-compiled).\"\"\"
            return _PT.run(_GROUP_INDEX[rank], st, comm)


        def expand_rank_ids(rank):
            \"\"\"Terminal-id stream rank ``rank`` replays (symbolic, no
            execution) — the lossless-expansion oracle of this module.\"\"\"
            return _expand_symbols(GROUP_PROGRAMS[_GROUP_INDEX[rank]], RULES)


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


def _noise_models_block(merged: MergedProgram,
                        noise_models: Sequence[tuple[float, float]] | None,
                        ) -> str:
    """``NOISE_MODELS`` table source, shared by both codegen flavors.

    One ``(sigma, shift)`` float pair per terminal, aligned with the
    terminal table; ``repr`` floats round-trip exactly, which the noise
    property suite pins.  All-zeros (unit factors) when no model was
    calibrated, so pre-noise pipelines emit a well-formed table too.
    """
    events = merged.table.events
    if noise_models is None:
        noise_models = ((0.0, 0.0),) * len(events)
    if len(noise_models) != len(events):
        raise ValueError("noise_models length does not match terminal table: "
                         f"{len(noise_models)} vs {len(events)}")
    L = ["#: per-terminal calibrated (sigma, shift) noise params — mean-one",
         "#: multiplicative factors lowered by repro_torch.core.noise; inert unless",
         "#: replay opts in (ProxyProgram.*(noise=NoiseConfig(...)))",
         "NOISE_MODELS = ("]
    for gid, (sigma, shift) in enumerate(noise_models):
        L.append(f"    ({float(sigma)!r}, {float(shift)!r}),  # t{gid}")
    L.append(")")
    return "\n".join(L)


def _fmt_ranktuple(s: Sequence[int]) -> str:
    """Compact ordered-tuple literal: arithmetic progressions (the common
    SPMD group shape) render as ``tuple(range(...))`` so a thousand-rank
    group costs O(1) generated source, not O(n)."""
    s = list(s)
    if len(s) >= 3:
        step = s[1] - s[0]
        if step > 0 and all(b - a == step for a, b in zip(s, s[1:])):
            return (f"tuple(range({s[0]}, {s[-1] + 1}))" if step == 1
                    else f"tuple(range({s[0]}, {s[-1] + 1}, {step}))")
    return repr(tuple(s))


def _syms_comm_axes(syms: Sequence[tuple], rules: Mapping[int, list],
                    table) -> frozenset:
    """Mesh axes touched by the comm terminals reachable from ``syms``
    (transitively through non-terminal references)."""
    axes: set[str] = set()
    seen: set[int] = set()

    def visit_rule(rid: int) -> None:
        if rid in seen:
            return
        seen.add(rid)
        for kind, ref, _ in rules[rid]:
            if kind == "t":
                visit_term(ref)
            else:
                visit_rule(ref)

    def visit_term(gid: int) -> None:
        ev = table.events[gid]
        if is_comm(ev):
            axes.update(ev.axes)

    for kind, ref, _ in syms:
        if kind == "t":
            visit_term(ref)
        else:
            visit_rule(ref)
    return frozenset(axes)


def group_device_hint(sig: tuple, cluster_run_axes: Sequence[Sequence[frozenset]],
                      axis_sizes: Mapping[str, int],
                      count_scale: float = 1.0) -> int:
    """Devices that fully reproduce the collective span of a signature group:
    the product of the traced sizes of every mesh axis the group's comm
    terminals touch (1 for comm-free groups, or when an axis size is
    unknown).

    ``count_scale`` < 1 scales the hint down proportionally (floor 1): a
    time-dilated proxy replays 1/count_scale of the traced work, so tiny
    groups should share sub-meshes instead of idling devices sized for the
    full span (the sweep scheduler packs unit-hint groups together — see
    :func:`repro.core.replay.plan_mesh_sweep`)."""
    axes: set[str] = set()
    for ci, run_ids in sig:
        for i in run_ids:
            axes |= cluster_run_axes[ci][i]
    hint = 1
    for a in sorted(axes):
        hint *= max(int(axis_sizes.get(a, 1)), 1)
    hint = max(hint, 1)
    if count_scale < 1.0:
        hint = max(1, int(round(hint * count_scale)))
    return hint


def compute_signature_groups(cluster_ranks: Sequence[frozenset],
                             cluster_runs: Sequence[Sequence[frozenset | None]],
                             n_ranks: int,
                             ) -> list[tuple[tuple, list[int]]]:
    """Group ranks by control-flow signature (mirrors ``program_signature``).

    A rank's signature is the tuple of ``(cluster_id, matched_guard_runs)``
    over the clusters containing it — the exact per-rank trace key of the
    generated module.  Groups preserve rank order; signatures are ordered by
    first rank seen, so output is deterministic.
    """
    groups: dict[tuple, list[int]] = {}
    for rank in range(n_ranks):
        sig = []
        for ci, (cranks, runs) in enumerate(zip(cluster_ranks, cluster_runs)):
            if rank in cranks:
                sig.append((ci, tuple(i for i, rs in enumerate(runs)
                                      if rs is None or rank in rs)))
        groups.setdefault(tuple(sig), []).append(rank)
    return list(groups.items())


def _topo_order(rules: dict[int, list]) -> list[int]:
    """Children-first ordering of non-terminal definitions."""
    seen: set[int] = set()
    out: list[int] = []

    def visit(rid: int):
        if rid in seen:
            return
        seen.add(rid)
        for kind, ref, _ in rules[rid]:
            if kind == "r":
                visit(ref)
        out.append(rid)

    for rid in sorted(rules):
        visit(rid)
    return out
