"""The launch tier against the reference: the HLO-text half of
``launch/hlo_cost.py``, the dry run on meta tensors, its roofline and
report, and the production mesh.

Three processes start together in the module's fixture: the reference
(one subprocess for the file, see test_torch_harness.py, on four forced
host devices) compiles the smoke Llama, Mamba2 and DeepSeek-MoE train,
prefill and decode steps on a 2 × 2 mesh (``jax.jit(step).lower(*specs)
.compile()``, compile only) and writes their memory analysis, HLO cost,
roofline and report; the port's fake world (a subprocess of its own, so
no default process group leaks into this worker's other files) walks the
same cells and builds the production meshes; and the port's entry point
runs one full-width cell.  The reference's ``hlo_cost``, ``roofline`` and
``report`` import no JAX compiler state and are also called in process.

Parity levels, as each test states: the HLO-text functions equal to the
bit on any text; argument bytes, output bytes and MODEL_FLOPS equal; the
op log's FLOPs within 1% of the reference's HLO count for the dense
prefill and decode, both values pinned elsewhere (ROADMAP §3, D7 where
they differ by more); the collective bytes by kind equal to the analytic
Megatron count each case states (GSPMD picks other collectives); the
roofline fed the reference's cost under the reference's constants equal
field for field; the report's tables the same bytes.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from repro.launch import hlo_cost as ref_hlo
from repro.launch import report as ref_report
from repro.launch import roofline as ref_roofline
from repro_torch.configs import get, smoke
from repro_torch.configs.base import RunShape
from repro_torch.configs.registry import input_specs
from repro_torch.core.tracer import trace_fn
from repro_torch.launch import hlo_cost, report, roofline
from repro_torch.launch.dryrun import build_step
from repro_torch.models.layers import tree_leaves, tree_map
from test_hlo_partition import _SIMPLE_HLO
from test_torch_harness import ROOT, one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ("llama3.2-3b", "mamba2-2.7b", "deepseek-moe-16b")
KINDS = ("train", "prefill", "decode")
CELLS = [(a, k) for a in ARCHS for k in KINDS]
#: the smoke cells' global batch and sequence on the 2 × 2 mesh
BATCH, SEQ = 4, 16
MESH = {"data": 2, "model": 2}
#: the reference's constants, set by name on the port's roofline
REF_CONSTANTS = {"PEAK_FLOPS_BF16": 197e12, "HBM_BW": 819e9, "ICI_BW": 50e9}
#: op-log FLOPs against the reference's HLO FLOPs, dense prefill and decode
FLOPS_RTOL = 0.01
#: the other cells' FLOPs, (port, reference's HLO): pinned both ways
PINNED_FLOPS = {
    ("llama3.2-3b", "train"): (10616832.0, 10616832.0),
    ("mamba2-2.7b", "train"): (9469952.0, 9363456.0),        # D7
    ("mamba2-2.7b", "prefill"): (2146304.0, 2138112.0),
    ("mamba2-2.7b", "decode"): (187392.0, 184832.0),         # D7
    ("deepseek-moe-16b", "train"): (46104576.0, 46071808.0),
    ("deepseek-moe-16b", "prefill"): (14385152.0, 14368768.0),
    ("deepseek-moe-16b", "decode"): (960512.0, 959488.0),
}
#: the full-width cell of the entry point
ENTRY = ("llama3.2-3b", "decode_32k")


def _shape(kind: str) -> RunShape:
    return RunShape(f"{kind}_smoke", SEQ, BATCH, kind)


REFERENCE_CODE = """
import json
import jax, jax.numpy as jnp
jax.devices()                 # four forced host devices, before dryrun
from repro.configs import get, smoke
from repro.configs.base import RunShape
from repro.configs.registry import (
    batch_specs, cache_specs, param_specs, rules_for)
from repro.launch import mesh as mesh_mod, report, roofline
from repro.launch.dryrun import build_step
from repro.launch.hlo_cost import analyze
from repro.train.optimizer import abstract_opt_state

ARCHS, KINDS, BATCH, SEQ = {archs!r}, {kinds!r}, {batch}, {seq}
mesh = mesh_mod.make_test_mesh(2, 2)
cells, records = {{}}, []
for arch in ARCHS:
    cfg = smoke(get(arch))
    rules = rules_for(cfg)
    for kind in KINDS:
        shape = RunShape(f"{{kind}}_smoke", SEQ, BATCH, kind)
        params = param_specs(cfg, mesh, rules)
        batch = batch_specs(cfg, shape, mesh, rules)
        if kind == "train":
            specs = (params, abstract_opt_state(params, mesh, rules), batch)
        elif kind == "prefill":
            specs = (params, batch)
        else:
            specs = (params, cache_specs(cfg, shape, mesh, rules), batch,
                     jax.ShapeDtypeStruct((), jnp.int32))
        step, donate = build_step(cfg, kind, mesh)
        with mesh:
            compiled = jax.jit(step, donate_argnums=donate).lower(
                *specs).compile()
        text = compiled.as_text()
        if arch == "llama3.2-3b" and kind == "prefill":
            (OUT / "llama_prefill.hlo").write_text(text)
        mem = compiled.memory_analysis()
        cost = analyze(text)
        rep = roofline.report(compiled, cfg, shape, mesh, "test2x2")
        memory = {{
            "argument_bytes": int(mem.argument_size_in_bytes),
            "output_bytes": int(mem.output_size_in_bytes),
            "temp_bytes": int(mem.temp_size_in_bytes),
            "alias_bytes": int(mem.alias_size_in_bytes),
            "code_bytes": int(mem.generated_code_size_in_bytes)}}
        ca = compiled.cost_analysis() or {{}}
        rec = {{"arch": arch, "shape": shape.name, "mesh": "test2x2",
               "ok": True, "compile_sec": 1.5, "memory_analysis": memory,
               "xla_cost_analysis": {{
                   "flops": float(ca.get("flops", -1)),
                   "bytes_accessed": float(ca.get("bytes accessed", -1))}},
               "roofline": rep.as_dict(),
               "roofline_fraction": roofline.roofline_fraction(rep),
               "step_time_bound_s": roofline.step_time_bound(rep)}}
        records.append(rec)
        cells[f"{{arch}}|{{kind}}"] = {{
            "memory": memory, "record": rec,
            "cost": {{"flops": cost.flops, "bytes": cost.bytes,
                     "collective_bytes": cost.collective_bytes,
                     "collective_by_kind": dict(cost.collective_by_kind),
                     "collective_count": cost.collective_count,
                     "transcendentals": cost.transcendentals}}}}
# the production mesh's shape and names, from the reference's own builder
mesh_mod._mk = lambda shape, axes: (list(shape), list(axes))
prod = {{str(mp): mesh_mod.make_production_mesh(multi_pod=mp)
        for mp in (False, True)}}
tables = {{"roofline": report.roofline_table(records, "test2x2"),
          "dryrun": report.dryrun_table(records)}}
(OUT / "ref.json").write_text(json.dumps(
    {{"cells": cells, "prod": prod, "tables": tables, "records": records}}))
"""

PORT_CODE = """
import json, sys
from pathlib import Path
import torch.distributed as dist
from repro_torch.configs import get, smoke
from repro_torch.configs.base import RunShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh, mesh_groups

out = Path(sys.argv[1])
ARCHS, KINDS, BATCH, SEQ = {archs!r}, {kinds!r}, {batch}, {seq}
cells = {{}}
for arch in ARCHS:
    for kind in KINDS:
        rec = dryrun.run_cell(smoke(get(arch)),
                              RunShape(f"{{kind}}_smoke", SEQ, BATCH, kind),
                              mesh_shape={{"data": 2, "model": 2}})
        cells[f"{{arch}}|{{kind}}"] = rec
prod = {{}}
for mp, n in ((False, 256), (True, 512)):
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=mp)
        groups = mesh_groups(mesh)
        prod[str(mp)] = {{
            "world": dist.get_world_size(),
            "shape": [int(s) for s in mesh.mesh.shape],
            "names": list(mesh.mesh_dim_names),
            "groups": {{",".join(k): len(v[1])
                       for k, v in groups._groups.items()}}}}
assert not dist.is_initialized()
(out / "port.json").write_text(json.dumps({{"cells": cells, "prod": prod}}))
"""


def _port_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _run(cmd: list, timeout: float = 600) -> None:
    proc = subprocess.run(cmd, cwd=str(ROOT), env=_port_env(),
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's compiled cells, the port's walked cells and
    production meshes, and the entry point's record, run at once."""
    base = tmp_path_factory.mktemp("launch")
    fmt = dict(archs=ARCHS, kinds=KINDS, batch=BATCH, seq=SEQ)
    (base / "port").mkdir()
    (base / "port.py").write_text(textwrap.dedent(PORT_CODE.format(**fmt)))
    entry = base / "entry"
    with ThreadPoolExecutor(3) as pool:
        ref = pool.submit(
            run_reference, REFERENCE_CODE.format(**fmt), base / "ref", 600,
            {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
        port = pool.submit(_run, [sys.executable, str(base / "port.py"),
                                  str(base / "port")])
        main = pool.submit(_run, [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            ENTRY[0], "--shape", ENTRY[1], "--out", str(entry)])
        ref_out = ref.result()
        port.result()
        main.result()
    return {"ref": ref_out["ref"],
            "hlo": (base / "ref" / "llama_prefill.hlo").read_text(),
            "port": json.loads((base / "port" / "port.json").read_text()),
            "entry": sorted(entry.glob("*.json"))}


# ---------------------------------------------------------------------------
# the HLO-text half: the reference's numbers to the bit
# ---------------------------------------------------------------------------


def _module_state(comps):
    out = {}
    for name, comp in comps.items():
        if isinstance(comp, str):
            out[name] = comp
            continue
        out[name] = (comp.name, dict(comp.params), list(comp.order),
                     [(o.name, o.opcode, o.result_type, list(o.operands),
                       o.attrs, o.line) for o in comp.ops.values()])
    return out


def _cost_state(c):
    return (c.flops, c.bytes, c.collective_bytes,
            sorted(c.collective_by_kind.items()), c.collective_count,
            c.transcendentals)


def _text_half_equal(text: str) -> None:
    assert _module_state(hlo_cost.parse_module(text)) == \
        _module_state(ref_hlo.parse_module(text))
    assert _cost_state(hlo_cost.analyze(text)) == \
        _cost_state(ref_hlo.analyze(text))
    for key in ("bytes", "flops", "collective"):
        assert hlo_cost.top_sites(text, 40, key) == \
            ref_hlo.top_sites(text, 40, key)
    comps, ref_comps = hlo_cost.parse_module(text), ref_hlo.parse_module(text)
    comps.pop(hlo_cost.ENTRY_KEY, None)
    ref_comps.pop(ref_hlo.ENTRY_KEY, None)
    conds = [c for comp in comps.values() for op in comp.ops.values()
             for k, c in hlo_cost._callees(op) if k == "condition"]
    for cond in conds:
        assert hlo_cost.while_trip_count(comps, cond) == \
            ref_hlo.while_trip_count(ref_comps, cond)
    for comp in comps.values():
        for op in comp.ops.values():
            t = op.result_type
            assert hlo_cost.shape_bytes(t) == ref_hlo.shape_bytes(t)
            assert hlo_cost.shape_elems(t) == ref_hlo.shape_elems(t)
            assert hlo_cost._group_size(op) == ref_hlo._group_size(op)


def test_text_half_on_the_literal_module():
    """``tests/test_hlo_partition.py``'s module: parse, cost, sites and the
    trip count equal the reference's to the bit."""
    _text_half_equal(_SIMPLE_HLO)
    assert hlo_cost.analyze(_SIMPLE_HLO).flops == 12 * 2 * 8 ** 3
    comps = hlo_cost.parse_module(_SIMPLE_HLO)
    comps.pop(hlo_cost.ENTRY_KEY, None)
    assert hlo_cost.while_trip_count(comps, "cond") == 12


def test_text_half_on_a_compiled_module(runs):
    """The HLO text XLA compiles for the smoke Llama's prefill on a forced
    2 × 2 mesh: every function of the text half equals the reference's."""
    text = runs["hlo"]
    assert "all-reduce" in text or "all-gather" in text
    _text_half_equal(text)
    assert hlo_cost.analyze(text).flops > 0


# ---------------------------------------------------------------------------
# the dry run against the reference's compiled steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", CELLS)
def test_dryrun_memory_matches_the_reference(runs, arch, kind):
    """Argument and output bytes equal the reference's memory analysis (the
    outputs with XLA's table of 8-byte buffer pointers).  Alias bytes: the
    reference's less the optimizer's step count in train (the port's
    AdamW makes a new step tensor; XLA donates the old one)."""
    mine = runs["port"]["cells"][f"{arch}|{kind}"]["memory_analysis"]
    ref = runs["ref"]["cells"][f"{arch}|{kind}"]["memory"]
    assert mine["argument_bytes"] == ref["argument_bytes"]
    assert mine["output_bytes"] == ref["output_bytes"]
    assert mine["alias_bytes"] == ref["alias_bytes"] - (
        4 if kind == "train" else 0)
    assert mine["code_bytes"] == 0 and mine["temp_bytes"] > 0


@pytest.mark.parametrize("arch,kind", CELLS)
def test_model_flops_and_flops_per_chip(runs, arch, kind):
    """MODEL_FLOPS bit-equal to the reference's; the op log's FLOPs within
    1% of the reference's HLO count for the dense prefill and decode, and
    both values pinned for the rest."""
    rec = runs["port"]["cells"][f"{arch}|{kind}"]
    ref = runs["ref"]["cells"][f"{arch}|{kind}"]
    from repro.configs import get as ref_get
    from repro.configs import smoke as ref_smoke
    from repro.configs.base import RunShape as RefShape
    want = ref_roofline.model_flops(ref_smoke(ref_get(arch)),
                                    RefShape(f"{kind}_smoke", SEQ, BATCH,
                                             kind))
    assert rec["roofline"]["model_flops"] == want == \
        roofline.model_flops(smoke(get(arch)), _shape(kind))
    assert rec["roofline"]["model_flops"] == \
        ref["record"]["roofline"]["model_flops"]
    got, theirs = rec["roofline"]["flops_per_chip"], ref["cost"]["flops"]
    if arch == "llama3.2-3b" and kind != "train":
        assert abs(got - theirs) <= FLOPS_RTOL * theirs, (got, theirs)
    else:
        assert (got, theirs) == PINNED_FLOPS[(arch, kind)]


def _megatron(arch: str, kind: str, param_bytes: int) -> dict:
    """The collective bytes of one process (operands, f32) that the port's
    Megatron plan moves for a smoke cell on data 2 × model 2, term by term:
    b rows a process, s tokens (1 in decode), d the width, L layers.
    ``param_bytes`` is the process's parameter block (the gradient mean)."""
    cfg = smoke(get(arch))
    w, tp, dp, L = 4, MESH["model"], MESH["data"], cfg.n_layers
    b, d = BATCH // dp, cfg.d_model
    s = 1 if kind == "decode" else SEQ
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    act = b * s * d * w                      # one (b, s, d) activation
    out = {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0}
    if arch == "mamba2-2.7b":
        di = cfg.ssm_expand * d
        H = di // cfg.ssm_head_dim
        conv = di + 2 * cfg.ssm_groups * cfg.ssm_state     # conv channels
        din = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + H
        k = 4                                              # conv kernel
        # embedding lookup (vocab-parallel); per layer the gated norm's
        # statistic and the out-projection (row-parallel)
        out["all-reduce"] = act + L * (b * s * w + act)
        # per layer the conv weight and bias whole, the in-projection's
        # columns gathered (decode: the conv state whole too)
        out["all-gather"] = L * (k * conv + conv + b * s * din
                                 + (b * (k - 1) * conv if kind == "decode"
                                    else 0)) * w // tp
        if kind == "train":
            # the loss's max and sums; backward f of each column-parallel
            # input (in-projections, the unembedding) and the norm's
            # statistic; the gradient mean, the loss and the clip's norm
            out["all-reduce"] += 3 * b * s * w + (L + 1) * act \
                + L * b * s * w + param_bytes + 2 * w
            # backward of each gather: the gathered tensors reduce-scattered
            out["reduce-scatter"] = L * (k * conv + conv + b * s * din) * w
        return {k_: v for k_, v in out.items() if v}
    # attention layers: embedding lookup, then per layer the row-parallel
    # output projection and the FFN's (MoE: its combined experts) output
    out["all-reduce"] = act + 2 * L * act
    if kind == "decode":
        # the sequence-split cache: softmax max and sum, partial outputs;
        # q and the new token's k and v gathered to whole heads
        out["all-reduce"] += L * (2 * b * h + b * h * hd) * w
        out["all-gather"] += L * (b * h * hd + 2 * b * g * hd) * w // tp
    if arch == "deepseek-moe-16b":
        E, fe = cfg.n_experts, cfg.d_ff_expert
        fs = cfg.n_shared_experts * fe
        # the aux loss's two means over the data shards
        out["all-reduce"] += L * 2 * E * w
        # FSDP (embed on data): every weight's embed blocks gathered: the
        # vocab table twice (lookup, unembedding), per layer two norms,
        # wq, wk, wv, wo, the router, 3 expert and 3 shared matrices,
        # and the final norm
        dd = d // dp
        layer = (2 * dd + dd * h * hd // tp + 2 * dd * g * hd // tp
                 + h * hd // tp * dd + dd * E + 3 * (E // tp) * dd * fe
                 + 3 * dd * fs // tp)
        out["all-gather"] += (2 * cfg.vocab // tp * dd + L * layer + dd) * w
        if kind == "train":
            # the loss's max and sums; backward f at each column-parallel
            # input (attention's qkv and the unembedding: L + 1; the MoE
            # input twice a layer), the aux means' and the router's; the
            # loss mean and the clip's norm (one group of 2, two of 4)
            out["all-reduce"] += 3 * b * s * w + (L + 1 + 2 * L) * act \
                + L * E * w + L * d * w + w + 3 * w
            # each gathered weight's gradient reduce-scattered over data
            out["reduce-scatter"] = dp * out["all-gather"]
    elif kind == "train":
        # the loss's max and sums, backward f at each column-parallel input
        # (qkv, the MLP's up projection, the unembedding), the gradient
        # mean, the loss and the clip's norm
        out["all-reduce"] += 3 * b * s * w + (2 * L + 1) * act \
            + param_bytes + 2 * w
    return {k_: v for k_, v in out.items() if v}


def _param_bytes(arch: str) -> int:
    """The process's parameter block of the smoke config on 2 × 2 (from
    the specs, in a world of no process: the block shapes are pure)."""
    from repro_torch.sharding.partition import block_of

    _, (params, _batch) = input_specs(smoke(get(arch)), _shape("prefill"),
                                      MESH, with_opt=False)
    total = 0
    for m in tree_leaves(params):
        shape = list(m.meta.shape)
        for dim, entry in enumerate(m.spec):
            shape[dim] //= block_of(entry, MESH, {"data": 0, "model": 0})[1]
        total += math.prod(shape) * m.meta.element_size()
    return total


@pytest.mark.parametrize("arch,kind", CELLS)
def test_collective_bytes_are_the_megatron_count(runs, arch, kind):
    """Collective bytes by kind equal the analytic count of the port's
    Megatron plan (``sharding/spmd.py``); the reference's GSPMD plan moves
    other collectives (its kinds and bytes are printed, not compared)."""
    rec = runs["port"]["cells"][f"{arch}|{kind}"]["roofline"]
    want = _megatron(arch, kind, _param_bytes(arch))
    assert rec["coll_by_kind"] == pytest.approx(want, rel=0, abs=0), (
        rec["coll_by_kind"], want,
        runs["ref"]["cells"][f"{arch}|{kind}"]["cost"]["collective_by_kind"])
    assert rec["coll_bytes_per_chip"] == sum(want.values())


@pytest.mark.parametrize("arch,kind", CELLS)
def test_roofline_report_fed_the_references_cost(runs, arch, kind,
                                                 monkeypatch):
    """With the reference's constants set by name, ``report`` fed the
    reference's HLO cost and memory gives its RooflineReport field for
    field, and its fraction and step-time bound."""
    for name, value in REF_CONSTANTS.items():
        monkeypatch.setattr(roofline, name, value)
    ref = runs["ref"]["cells"][f"{arch}|{kind}"]
    c = ref["cost"]
    cost = hlo_cost.HloCost(flops=c["flops"], bytes=c["bytes"],
                            collective_bytes=c["collective_bytes"],
                            collective_count=c["collective_count"],
                            transcendentals=c["transcendentals"])
    cost.collective_by_kind.update(c["collective_by_kind"])
    rep = roofline.report(cost, ref["memory"], smoke(get(arch)),
                          _shape(kind), MESH, "test2x2")
    want = ref["record"]
    assert json.loads(json.dumps(rep.as_dict())) == want["roofline"]
    assert roofline.roofline_fraction(rep) == want["roofline_fraction"]
    assert roofline.step_time_bound(rep) == want["step_time_bound_s"]


def test_report_renders_the_references_records(runs, tmp_path):
    """Both tables of the reference's records are the same bytes from the
    port's report and the reference's, and ``load`` reads them back."""
    records = runs["ref"]["records"]
    tables = runs["ref"]["tables"]
    assert report.roofline_table(records, "test2x2") == tables["roofline"]
    assert report.dryrun_table(records) == tables["dryrun"]
    assert ref_report.dryrun_table(records) == tables["dryrun"]
    for i, rec in enumerate(records):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(rec))
    assert report.load(tmp_path) == records
    port = [runs["port"]["cells"][f"{a}|{k}"] for a, k in CELLS]
    assert report.dryrun_table(port) == ref_report.dryrun_table(port)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_the_references(runs, multi_pod):
    """On a fake world of 256 (512) processes: the reference's shape and
    axis names, and a group over any set of axes as large as the product
    of their sizes (GSPMD's replica groups on that mesh)."""
    ref_shape, ref_names = runs["ref"]["prod"][str(multi_pod)]
    mine = runs["port"]["prod"][str(multi_pod)]
    assert mine["shape"] == ref_shape and mine["names"] == ref_names
    assert mine["world"] == math.prod(ref_shape)
    sizes = dict(zip(ref_names, ref_shape))
    assert mine["groups"]
    for axes, n in mine["groups"].items():
        assert n == math.prod(sizes[a] for a in axes.split(","))
    assert len(mine["groups"]) == sum(
        math.perm(len(ref_names), k) for k in range(1, len(ref_names) + 1))


def test_entry_point_writes_an_ok_record_at_full_width(runs):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape
    decode_32k`` on the production mesh writes one ``ok`` record with
    every key of the reference's record (``src/repro/launch/dryrun.py``)."""
    files = runs["entry"]
    assert [p.name for p in files] == \
        [f"{ENTRY[0]}__{ENTRY[1]}__pod16x16.json"]
    rec = json.loads(files[0].read_text())
    want = runs["ref"]["records"][0]
    assert rec["ok"] is True
    assert set(rec) == set(want)
    assert set(rec["memory_analysis"]) == set(want["memory_analysis"])
    assert set(rec["xla_cost_analysis"]) == set(want["xla_cost_analysis"])
    assert set(rec["roofline"]) == set(want["roofline"])
    r = rec["roofline"]
    assert r["n_chips"] == 256 and r["flops_per_chip"] > 0
    assert r["memory_per_device"] == rec["memory_analysis"]["argument_bytes"] \
        + rec["memory_analysis"]["temp_bytes"]
    assert rec["step_time_bound_s"] == max(r["t_compute"], r["t_memory"],
                                           r["t_collective"])


# ---------------------------------------------------------------------------
# the op log itself (no process group: one device)
# ---------------------------------------------------------------------------


def _smoke_args(arch: str, kind: str):
    cfg = smoke(get(arch))
    _, specs = input_specs(cfg, _shape(kind), {"data": 1})
    return cfg, tree_map(lambda m: m.meta.clone(), specs)


@pytest.mark.parametrize("arch", ARCHS)
def test_op_log_agrees_with_the_walker(arch):
    """The records' costs times their multiplicities are the cost walker's
    totals (every column but scan steps), and ``trace_fn`` of the same
    prefill charges the same; a stack walked once is one record of mult
    n_units; no collective without a mesh."""
    cfg, args = _smoke_args(arch, "prefill")
    step = build_step(cfg, "prefill", None)
    _, log = hlo_cost.record_step(step, *args)
    import numpy as np
    summed = sum((r.cost * r.mult for r in log.records), np.zeros(6))
    np.testing.assert_array_equal(summed[:5], log.total[:5])
    walked = trace_fn(step, *args).total_compute()
    np.testing.assert_array_equal(walked[:5], log.total[:5])
    cost = hlo_cost.analyze(log)
    assert (cost.flops, cost.bytes, cost.transcendentals) == \
        (log.total[0], log.total[2], log.total[3])
    assert cost.collective_bytes == 0 and not cost.collective_by_kind
    units = {r.mult for r in log.records}
    assert cfg.n_layers // len(cfg.layer_pattern) in units
    sites = hlo_cost.top_sites(log, 5, "flops")
    assert sites and all(len(t) == 6 for t in sites)
    assert sites[0][0] == max(t[0] for t in sites)
    assert log.argument_bytes == sum(
        t.numel() * t.element_size() for t in tree_leaves(args))
    assert log.peak_temp_bytes > 0
