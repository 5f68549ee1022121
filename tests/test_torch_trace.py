"""The port's tracer front end against the JAX reference: the instrumented
collectives, the loop helpers, per-rank specialisation, TraceSession, and
synthesize(fn) of the paper's programs and the three ported zoo scenarios.

Everything the reference computes here (it needs ``repro.sharding.
collectives`` and ``repro.core.synthesize``, which do not import in-process
on JAX 0.9) comes from one subprocess per test module
(:func:`test_torch_harness.run_reference`), cached for the module.
Parity levels: comm events and per-rank comm streams exact; compute costs
exact where the programs are the same equations (the programs and the
flash chunk); TraceStores bit-identical where both sides record the same
events; δ̄ of the port's synthesis on the reference's own TraceStore within
0.05 of the reference's (it comes out equal to 1e-12)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import SCENARIOS, build_scenario
from repro_torch.core import tracer
from repro_torch.core.events import is_comm
from repro_torch.core.synthesize import synthesize
from repro_torch.core.trace_ir import TraceStore
from repro_torch.sharding import collectives as C
from repro_torch.workloads import PROGRAMS, pipeline_traces
from test_torch_harness import run_reference

N = 4
SCENARIO_NAMES = ("transformer-dp", "flash-ring", "ssm-decode", "moe-ep",
                  "encdec-pipeline")
#: (n_ranks, steps) of each scenario run: fidelity_baseline.json's, and the
#: scenario's defaults (None)
SCENARIO_SIZES = ((4, 2), (None, None))
DELTA_ATOL = 0.05

#: (name, wrapper, per-rank shape, dtype, keyword arguments)
WRAPPER_CASES = [
    ("psum", "psum", (3, 5), "float32", {}),
    ("psum_0d", "psum", (), "float32", {}),
    ("pmax", "pmax", (4,), "bfloat16", {}),
    ("all_gather", "all_gather", (2, 3), "float32", {"gather_dim": 1}),
    ("all_gather_tiled", "all_gather", (4, 3), "float32",
     {"gather_dim": 0, "tiled": True}),
    ("psum_scatter", "psum_scatter", (8, 3), "float32", {"scatter_dim": 0}),
    ("psum_scatter_untiled", "psum_scatter", (4, 6), "bfloat16",
     {"scatter_dim": 0, "tiled": False}),
    ("all_to_all", "all_to_all", (8, 4), "float32",
     {"split_axis": 0, "concat_axis": 1}),
    ("all_to_all_untiled", "all_to_all", (4, 6), "float32",
     {"split_axis": 0, "concat_axis": 1, "tiled": False}),
    ("ppermute", "ppermute", (2, 3), "bfloat16",
     {"perm": tuple((i, (i + 1) % N) for i in range(N))}),
]

#: cases whose jaxpr collective is not the call the wrapper records: JAX
#: lowers an untiled all_to_all as a reshape to (..., 1) and a tiled one.
#: The port records what the reference's wrapper records, in both contexts.
JAXPR_DIFFERS = {"all_to_all_untiled": [
    ["comm", "all_to_all", [4, 6, 1], "float32", ["x"], "(0, 2)"]]}

REFERENCE = r'''
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.sharding import collectives as RC
from repro.core.tracer import (TraceSession, per_rank_traces, trace_fn,
                               trace_fn_store)
from repro.core.trace_ir import TraceStore
from repro.core.synthesize import synthesize
from repro.configs.registry import build_scenario
from benchmarks.common import (allreduce_train_program, pipeline_traces,
                               stencil_program)

N = %(N)d
CASES = %(CASES)r
mesh = make_mesh((N,), ("x",))

def enc(e):
    if hasattr(e, "kind"):
        return ["comm", e.kind, list(e.shape), e.dtype, list(e.axes),
                repr(e.detail)]
    return ["comp", [float(v) for v in e.metrics]]

def per_rank(fn, *args):
    return shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                     out_specs=P("x"))

out = {"wrappers": {}, "loops": {}}
for name, wrapper, shape, dtype, kw in CASES:
    shapes = []
    def body(x, wrapper=wrapper, kw=kw):
        f = getattr(RC, wrapper)
        if wrapper == "ppermute":
            y = f(x, "x", kw["perm"])
        elif wrapper == "all_to_all":
            y = f(x, "x", kw["split_axis"], kw["concat_axis"],
                  tiled=kw.get("tiled", True))
        else:
            y = f(x, "x", **kw)
        shapes.append(list(y.shape))
        return jnp.sum(y.astype(jnp.float32))[None]
    x = jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))
    with TraceSession(N, {"x": N}) as sess:
        jax.make_jaxpr(per_rank(body, x))(x)
    walked = trace_fn(per_rank(body, x), x, axis_sizes={"x": N})
    out["wrappers"][name] = {
        "session": [enc(e) for e in sess.rank_streams[0]],
        "walker": [enc(e) for e in walked.events if hasattr(e, "kind")],
        "out_shape": shapes[0]}

ring = [(i, (i + 1) %% N) for i in range(N)]
line = [(0, 1), (1, 2)]

def scan_coll(u):
    u = u * 2.0
    def body(c, _):
        c = lax.psum(jnp.tanh(c), "x")
        return c * 3.0, None
    c, _ = lax.scan(body, u, None, length=3)
    return (c + 1.0).sum()[None]

def fori_coll(u):
    return lax.fori_loop(0, 3, lambda i, c: lax.ppermute(
        jnp.tanh(c), "x", ring), u * 0.5).sum()[None]

def xs_free(x, ws):
    c, _ = lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)
    return c.sum()[None]

def xs_coll(x, ws):
    def body(c, w):
        h = jnp.tanh(c @ w)
        return h + lax.psum(h.sum(axis=0), "x")[None, :], None
    c, _ = lax.scan(body, x * 1.5, ws)
    return c.sum()[None]

def nested(u):
    def outer(c, _):
        c = lax.fori_loop(0, 2, lambda i, v: lax.pmax(v * 0.5, "x"), c)
        return jnp.exp(c), None
    c, _ = lax.scan(outer, u, None, length=2)
    return c.sum()[None]

def ys(c0, ws):
    c, r = lax.scan(lambda c, w: (c + 1.0, jnp.sum(c * w)), c0, ws)
    return (c.sum() + r.sum())[None]

def halo(u):
    return lax.ppermute(u, "x", line).astype(jnp.float32).sum()[None]

S = jax.ShapeDtypeStruct
f32 = jnp.float32
LOOPS = {
    "scan_coll": (scan_coll, [S((8, 16), f32)]),
    "fori_coll": (fori_coll, [S((8, 16), f32)]),
    "xs_free": (xs_free, [S((16, 32), f32), S((5, 32, 32), f32)]),
    "xs_coll": (xs_coll, [S((16, 32), f32), S((5, 32, 32), f32)]),
    "nested": (nested, [S((64,), f32)]),
    "ys": (ys, [S((8, 4), f32), S((6, 8, 4), f32)]),
    "halo": (halo, [S((4, 8), jnp.bfloat16)]),
}
def unchecked(fn, *args):
    # loop carries change replication through the collectives
    return shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                     out_specs=P("x"), check_vma=False)

for name, (fn, specs) in LOOPS.items():
    tr = trace_fn(unchecked(fn, *specs), *specs, axis_sizes={"x": N})
    out["loops"][name] = {
        "events": [enc(e) for e in tr.events],
        "ranks": [[enc(e) for e in evs] for evs in per_rank_traces(tr)]}

fn, args, ax = stencil_program()
tr = trace_fn(fn, *args, axis_sizes=ax)
out["stencil_ranks"] = [[enc(e) for e in evs] for evs in per_rank_traces(tr)]
out["stencil_comm_bytes"] = int(tr.total_comm_bytes())
out["stencil_metrics"] = tr.compute_metrics_array().tolist()

stores = {}
for name, prog in (("stencil2d", stencil_program),
                   ("dp_train", allreduce_train_program)):
    fn, args, ax = prog()
    stores[name] = trace_fn_store(fn, *args, axis_sizes=ax)
stores["pipeline"] = TraceStore.from_rank_traces(pipeline_traces())
for sc in %(SCENARIOS)r:
    for n, steps in %(SIZES)r:
        key = sc if n is None else "%%s@%%dx%%d" %% (sc, n, steps)
        stores[key] = build_scenario(sc, n_ranks=n, steps=steps)
out["delta"] = {}
for key, st in stores.items():
    st.save(OUT / ("store_" + key + ".npz"))
    res = synthesize(store=st)
    res.proxy.run_all()
    fid = res.fidelity(sample_ranks=None)
    out["delta"][key] = [fid.mean, bool(fid.comm_lossless)]
(OUT / "ref.json").write_text(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    code = REFERENCE % {"N": N, "CASES": WRAPPER_CASES,
                        "SCENARIOS": SCENARIO_NAMES, "SIZES": SCENARIO_SIZES}
    out = tmp_path_factory.mktemp("trace_ref")
    run_reference(code, out, timeout=600)
    data = __import__("json").loads((out / "ref.json").read_text())
    data["stores"] = {p.stem[len("store_"):]: TraceStore.load(p)
                      for p in out.glob("store_*.npz")}
    return data


def enc(e) -> list:
    if is_comm(e):
        return ["comm", e.kind, list(e.shape), e.dtype, list(e.axes),
                repr(e.detail)]
    return ["comp", [float(v) for v in e.metrics]]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _call(wrapper, x, kw):
    f = getattr(C, wrapper)
    if wrapper == "ppermute":
        return f(x, "x", kw["perm"])
    if wrapper == "all_to_all":
        return f(x, "x", kw["split_axis"], kw["concat_axis"],
                 tiled=kw.get("tiled", True))
    return f(x, "x", **kw)


# ---------------------------------------------------------------------------
# instrumented collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", WRAPPER_CASES, ids=lambda c: c[0])
def test_wrapper_event_and_shape_match_reference(case, ref):
    """Under the walker and under a TraceSession, each wrapper records the
    reference's CommEvent (the jaxpr walker's and the reference wrapper's:
    numpy dtype names, string axes, its detail) and returns a meta tensor
    of the collective's per-rank output shape."""
    name, wrapper, shape, dtype, kw = case
    want = ref["wrappers"][name]
    if name in JAXPR_DIFFERS:
        assert want["walker"] == JAXPR_DIFFERS[name]
    else:
        assert want["session"] == want["walker"]
    seen = []
    tr = tracer.trace_fn(lambda x: seen.append(_call(wrapper, x, kw)),
                         _meta(shape, dtype), axis_sizes={"x": N})
    assert [enc(e) for e in tr.comm_events()] == want["session"]
    assert list(seen[0].shape) == want["out_shape"]
    assert seen[0].device.type == "meta"
    assert seen[0].dtype == getattr(torch, dtype)
    with tracer.TraceSession(N, {"x": N}) as sess:
        y = _call(wrapper, _meta(shape, dtype), kw)
    assert [[enc(e) for e in s] for s in sess.rank_streams] == \
        [want["session"]] * N
    assert list(y.shape) == want["out_shape"]


def test_wrappers_raise_on_real_tensors_and_unknown_axes():
    """No silent pass-through: a real tensor needs the mesh backend, and an
    axis of unknown size cannot give an output shape."""
    with pytest.raises(NotImplementedError, match="item 11"):
        C.psum(torch.ones(3), "x")
    with tracer.TraceSession(N, {"x": N}):
        with pytest.raises(NotImplementedError, match="item 11"):
            C.ppermute(torch.ones(3), "x", [(0, 1)])
    with pytest.raises(ValueError, match="unknown size"):
        tracer.trace_fn(lambda x: C.all_gather(x, "y"), torch.ones(3),
                        axis_sizes={"x": N})


# ---------------------------------------------------------------------------
# loop helpers and per-rank specialisation
# ---------------------------------------------------------------------------

RING = tuple((i, (i + 1) % N) for i in range(N))


def _scan_coll(u):
    u = u * 2.0

    def body(c):
        c = C.psum(torch.tanh(c), "x")
        return c * 3.0
    return (tracer.scan_loop(3, body, u) + 1.0).sum()[None]


def _fori_coll(u):
    return tracer.counted_loop(3, lambda c: C.ppermute(torch.tanh(c), "x",
                                                       RING), u * 0.5).sum()[None]


def _xs_free(x, ws):
    return tracer.scan_loop(ws.shape[0], lambda c, w: torch.tanh(c @ w), x,
                            xs=ws).sum()[None]


def _xs_coll(x, ws):
    def body(c, w):
        h = torch.tanh(c @ w)
        return h + C.psum(h.sum(dim=0), "x")[None, :]
    return tracer.scan_loop(ws.shape[0], body, x * 1.5, xs=ws).sum()[None]


def _nested(u):
    def outer(c):
        c = tracer.counted_loop(2, lambda v: C.pmax(v * 0.5, "x"), c)
        return torch.exp(c)
    return tracer.scan_loop(2, outer, u).sum()[None]


def _ys(c0, ws):
    c, r = tracer.scan_loop(ws.shape[0], lambda c, w: (c + 1.0,
                                                        torch.sum(c * w)),
                            c0, xs=ws, stack_ys=True)
    return (c.sum() + r.sum())[None]


def _halo(u):
    return C.ppermute(u, "x", [(0, 1), (1, 2)]).float().sum()[None]


LOOPS = {
    "scan_coll": (_scan_coll, [((8, 16), "float32")]),
    "fori_coll": (_fori_coll, [((8, 16), "float32")]),
    "xs_free": (_xs_free, [((16, 32), "float32"), ((5, 32, 32), "float32")]),
    "xs_coll": (_xs_coll, [((16, 32), "float32"), ((5, 32, 32), "float32")]),
    "nested": (_nested, [((64,), "float32")]),
    "ys": (_ys, [((8, 4), "float32"), ((6, 8, 4), "float32")]),
    "halo": (_halo, [((4, 8), "bfloat16")]),
}


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_loop_helpers_match_the_reference_walk(name, ref):
    """The reference's ``_walk_scan`` rules, event for event and cost for
    cost: a body with a collective walked every turn (no scan steps, the
    compute before the loop merged into the first event, the counter's add
    each turn), a collective-free one charged ``n`` times with ``n`` scan
    steps, xs slices and stacked ys free; and the per-rank streams."""
    fn, specs = LOOPS[name]
    tr = tracer.trace_fn(fn, *[_meta(s, d) for s, d in specs],
                         axis_sizes={"x": N})
    want = ref["loops"][name]
    assert [enc(e) for e in tr.events] == want["events"]
    assert [[enc(e) for e in evs] for evs in tracer.per_rank_traces(tr)] \
        == want["ranks"]


def test_loop_helpers_run_plain_loops_with_real_tensors():
    out = tracer.scan_loop(3, lambda c, w: c * w, torch.ones(2),
                           xs=torch.tensor([[2.0, 3.0]] * 3))
    assert out.tolist() == [8.0, 27.0]
    c, ys = tracer.scan_loop(3, lambda c, w: (c + w, c), torch.zeros(()),
                             xs=torch.arange(3.0), stack_ys=True)
    assert float(c) == 3.0 and ys.tolist() == [0.0, 0.0, 1.0]


def test_scan_under_autograd_runs_every_turn_and_charges_its_transpose():
    """With a gradient wanted every turn runs (autograd needs each turn's
    graph); forward and backward each charge n scan steps, and the xs
    slices and their gradients' stacking cost nothing."""
    def loss(x, ws):
        ws.requires_grad_(True)
        out = tracer.scan_loop(4, lambda c, w: torch.tanh(c @ w), x, xs=ws)
        return torch.autograd.grad(out.sum(), ws)

    got = tracer.compute_cost(loss, torch.ones(8, 16), torch.ones(4, 16, 16))
    fwd = tracer.compute_cost(lambda x, w: torch.tanh(x @ w),
                              torch.ones(8, 16), torch.ones(16, 16))
    assert got[5] == 8                          # 4 forward + 4 backward turns
    # each turn's matmul, its weight gradient, and (but the first turn's:
    # x needs none) its input gradient
    assert got[0] == 4 * fwd[0] + 4 * fwd[0] + 3 * fwd[0]


def test_per_rank_traces_of_the_stencil_match_reference(ref):
    fn, args, axes = PROGRAMS["stencil2d"]()
    tr = tracer.trace_fn(fn, *args, axis_sizes=axes)
    got = [[enc(e) for e in evs] for evs in tracer.per_rank_traces(tr)]
    assert got == ref["stencil_ranks"]
    assert tr.total_comm_bytes() == ref["stencil_comm_bytes"]
    assert tr.compute_metrics_array().tolist() == ref["stencil_metrics"]


def _assert_stores_equal(a: TraceStore, b: TraceStore) -> None:
    assert a.content_hash() == b.content_hash()
    assert a.to_rank_traces() == b.to_rank_traces()
    assert a.axis_sizes == b.axis_sizes


def test_trace_session_to_store_is_the_references(ref):
    """Bit-identical TraceStore of the pipeline schedule, recorded through
    TraceSession.emit, record_event and record_compute alike."""
    _assert_stores_equal(TraceStore.from_rank_traces(pipeline_traces()),
                         ref["stores"]["pipeline"])
    with tracer.TraceSession(3, {"stage": 3}) as sess:
        tracer.record_compute(lambda a, b: torch.tanh(a @ b),
                              torch.ones(64, 256), torch.ones(256, 256),
                              ranks=[0, 2])
        tracer.record_event(C.CommEvent("psum", (4,), "float32", ("stage",)))
    assert [len(s) for s in sess.rank_streams] == [2, 1, 2]
    assert sess.rank_streams[0][0] == pipeline_traces(2, 1)[0][0]
    assert tracer.active_session() is None
    st = sess.to_store()
    assert st.n_ranks == 3 and st.axis_sizes == {"stage": 3}


# ---------------------------------------------------------------------------
# synthesize(fn) of the paper's programs and the zoo scenarios
# ---------------------------------------------------------------------------


def _delta(res):
    res.proxy.run_all()
    fid = res.fidelity(sample_ranks=None)
    return fid.mean, fid.comm_lossless


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_synthesize_fn_of_the_programs(name, ref, tmp_path):
    """synthesize(fn, *args, axis_sizes=...) traces the per-rank torch
    program into the reference's own TraceStore, bit for bit, and its δ̄
    equals the reference's (0.031361 and 0.073385)."""
    fn, args, axes = PROGRAMS[name]()
    res = synthesize(fn, *args, axis_sizes=axes, device="cpu",
                     out_dir=tmp_path)
    _assert_stores_equal(res.store, ref["stores"][name])
    delta, lossless = _delta(res)
    want, want_lossless = ref["delta"][name]
    assert lossless and want_lossless
    assert abs(delta - want) <= 1e-12


def test_synthesize_pipeline_matches_reference(ref, tmp_path):
    res = synthesize(rank_traces=pipeline_traces(), device="cpu",
                     out_dir=tmp_path)
    delta, lossless = _delta(res)
    assert lossless and abs(delta - ref["delta"]["pipeline"][0]) <= 1e-12


def _key(name, n, steps):
    return name if n is None else f"{name}@{n}x{steps}"


@pytest.mark.parametrize("size", SCENARIO_SIZES, ids=["4x2", "default"])
@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_scenario_comm_streams_and_delta_match_reference(name, size, ref,
                                                         tmp_path):
    """Per-rank comm streams identical to the reference's; δ̄ of the port's
    synthesis on the reference's own TraceStore within 0.05 of the
    reference's (equal to 1e-12 in fact); the port-traced store replays
    losslessly too (its compute costs are the port walker's, see
    test_torch_trace_costs.py)."""
    n, steps = size
    want = ref["stores"][_key(name, n, steps)]
    got = build_scenario(name, n_ranks=n, steps=steps)
    assert got.n_ranks == want.n_ranks == (n or SCENARIOS[name].n_ranks)
    assert got.axis_sizes == want.axis_sizes
    for a, b in zip(got.to_rank_traces(), want.to_rank_traces()):
        assert [enc(e) for e in a if is_comm(e)] == \
            [enc(e) for e in b if is_comm(e)]
        assert [is_comm(e) for e in a] == [is_comm(e) for e in b]
    ref_delta, ref_lossless = ref["delta"][_key(name, n, steps)]
    delta, lossless = _delta(synthesize(store=want, device="cpu",
                                        out_dir=tmp_path))
    assert lossless and ref_lossless
    assert abs(delta - ref_delta) <= DELTA_ATOL
    assert abs(delta - ref_delta) <= 1e-12
    port_delta, port_lossless = _delta(synthesize(store=got, device="cpu",
                                                  out_dir=tmp_path))
    assert port_lossless and np.isfinite(port_delta)

