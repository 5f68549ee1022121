"""The port's mesh-sharded replay tier against the JAX reference.

Three layers, as in the reference's ``tests/test_replay_mesh.py``:

* the pure planner (``submesh_axis_sizes``, ``plan_mesh_sweep``): the
  reference's literal cases, and the reference's own plans on seeded random
  groups and hints (one subprocess);
* ``DeviceComm`` on four gloo processes (one pool per module, on a
  ``FileStore`` under the module's temporary directory): every collective
  kind, both fallbacks and every ``_detail_to_perm`` path, on a 1-D and a
  2-D sub-mesh, with the pool buffer's shape and dtype stable, a stacked
  state's one collective equal to one collective a member bit for bit, and
  each process's output equal to the reference ``DeviceComm``'s on a forced
  4-device CPU mesh bit for bit (inputs are small integers, so every sum is
  exact in any order);
* the sweep end to end: the reference's 8-rank ``_synth`` trace replayed
  with ``run_all(mesh=)`` on four processes (states bit-equal to LocalSim's
  and to the sequential mesh baseline, the comm buffers bit-equal to the
  reference's mesh sweep, δ̄ within 1e-12 of the reference's
  ``fidelity(mesh=)`` with ``mesh_checked``, the placement cache, the seeded
  noise distribution bit-equal under LocalSim and the mesh), and the same on
  a one-process gloo group in this process (the card runs it on a
  one-process NCCL group through ``chip_smoke.py``).

Each test's time limit is the pool's per-task timeout (``TASK_TIMEOUT``) or
the reference's subprocess timeout.
"""
from __future__ import annotations

import inspect
import json
import os
import queue
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.events import CommEvent, ComputeEvent
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.replay import plan_mesh_sweep, submesh_axis_sizes
from repro_torch.core.synthesize import synthesize
from repro_torch.launch import mesh as mesh_mod
from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TASK_TIMEOUT = 120          # seconds a pool task may take
N_STACK = 3                 # stacked states per DeviceComm case

# (kind, detail, payload shape, dtype, axes) on the 1-D sub-mesh {"x": 4}
CASES_1D = [
    ("psum", (), (16, 8), "float32", ("x",)),
    ("pmax", (), (16, 8), "float32", ("x",)),
    ("pmin", (), (16, 8), "float32", ("x",)),
    ("all_gather", (0,), (16, 8), "float32", ("x",)),
    ("reduce_scatter", (0,), (16, 8), "float32", ("x",)),     # divisible
    ("reduce_scatter", (1,), (16, 8), "float32", ("x",)),     # dim 1
    ("reduce_scatter", (0,), (15, 8), "float32", ("x",)),     # fallback
    ("all_to_all", (0, 1), (16, 8), "float32", ("x",)),       # divisible
    ("all_to_all", (1, 0), (16, 8), "float32", ("x",)),       # split 1
    ("all_to_all", (0, 1), (15, 8), "float32", ("x",)),       # fallback
    ("ppermute", ("shift", 1), (16, 8), "float32", ("x",)),
    ("ppermute", ("shift", 1, (0, 2)), (16, 8), "float32", ("x",)),
    ("ppermute", ("empty",), (16, 8), "float32", ("x",)),
    ("ppermute", ("rawperm", tuple((i, (i + 3) % 4) for i in range(4))),
     (16, 8), "float32", ("x",)),
    ("ppermute", (), (16, 8), "float32", ("x",)),             # default ring
    ("broadcast", (), (16, 8), "float32", ("x",)),
    ("psum", (), (4, 4), "bfloat16", ("x",)),
]
# on the 2-D sub-mesh {"data": 2, "model": 2}: groups over one axis, over
# both, and over both in the other order (the collective's linear index)
CASES_2D = [
    ("psum", (), (16, 8), "float32", ("model",)),
    ("psum", (), (16, 8), "float32", ("data", "model")),
    ("all_gather", (0,), (16, 8), "float32", ("model", "data")),
    ("all_to_all", (0, 1), (16, 8), "float32", ("data",)),
    ("all_to_all", (0, 1), (16, 8), "float32", ("model", "data")),
    ("ppermute", ("shift", 1), (16, 8), "float32", ("model",)),
    ("ppermute", ("rawperm", ((0, 3), (3, 1), (1, 2), (2, 0))),
     (16, 8), "float32", ("model", "data")),
    ("broadcast", (), (16, 8), "float32", ("model", "data")),
]
MESHES = {"1d": ({"x": 4}, CASES_1D), "2d": ({"data": 2, "model": 2},
                                             CASES_2D)}


def _synth_traces(n_ranks: int = 8):
    """The reference's ``tests/test_replay_mesh.py:_synth`` trace."""
    comm = CommEvent("psum", (16,), "float32", ("x",))
    perm = CommEvent("ppermute", (4, 4), "bfloat16", ("x",), ("shift", 1))
    comp = ComputeEvent((2.1e6, 3.3e4, 1.1e6, 8.2e2, 0., 0.))
    traces = []
    for r in range(n_ranks):
        tr = [comp, comm, comp, perm] * 6
        if r == 0:
            tr = tr + [comm]
        traces.append(tr)
    return traces


def _random_plans(seed: int = 7, n: int = 60) -> list[dict]:
    """Seeded planner inputs: groups, hints (some missing), geometry,
    device count, unit-group sharing."""
    rng = np.random.RandomState(seed)
    cases = []
    for _ in range(n):
        n_groups = int(rng.randint(0, 10))
        sizes = ({"x": int(rng.choice([1, 3, 4, 8, 16, 100]))}
                 if rng.rand() < 0.5 else
                 {"data": int(rng.choice([2, 4, 8])),
                  "model": int(rng.choice([1, 2, 3, 4]))})
        groups, hints, r0 = [], {}, 0
        for g in range(n_groups):
            k = int(rng.randint(1, 5))
            groups.append([[g, int(rng.randint(0, 3))], list(range(r0, r0 + k))])
            r0 += k
            if rng.rand() < 0.8:
                hints[str(g)] = int(rng.choice([1, 1, 2, 3, 4, 8, 16, 100]))
        cases.append({"groups": groups, "hints": hints, "axis_sizes": sizes,
                      "n_devices": int(rng.randint(1, 17)),
                      "share": bool(rng.rand() < 0.5)})
    return cases


def _plan_rows(groups, hints, sizes, n_devices, share):
    sig = {str(g[0][0]): tuple(g[0]) for g in groups}
    plan = plan_mesh_sweep([(tuple(g[0]), g[1]) for g in groups],
                           {sig[k]: v for k, v in hints.items()}, sizes,
                           n_devices, share_unit_groups=share)
    return [[list(p.ranks), list(p.device_ids),
             [list(a) for a in p.axis_sizes]] for p in plan]


def _comm_inputs(seed: int = 0) -> dict[str, np.ndarray]:
    """Small integers a process and stack member: every sum exact."""
    rng = np.random.RandomState(seed)
    return {f"{m}{i}": rng.randint(0, 8, (WORLD, N_STACK) + shape)
            .astype(np.float32)
            for m, (_, cases) in MESHES.items()
            for i, (_, _, shape, _, _) in enumerate(cases)}


REFERENCE_CODE = """
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core.events import CommEvent, ComputeEvent
from repro.core.noise import NoiseConfig
from repro.core.replay import plan_mesh_sweep, submesh_axis_sizes
from repro.core.synthesize import synthesize
from repro.launch.mesh import make_replay_mesh
from repro.sharding.collectives import DeviceComm

assert jax.device_count() == 4
spec = json.loads((OUT / "spec.json.in").read_text())
inputs = np.load(OUT / "inputs.npz.in")

# DeviceComm: each device its own slice, stacked and one at a time
out = {}
for m, (sizes, cases) in MESHES.items():
    mesh = make_mesh(tuple(sizes.values()), tuple(sizes))
    comm = DeviceComm(sizes)
    lead = tuple(sizes)
    for i, (kind, detail, shape, dtype, axes) in enumerate(cases):
        wire = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        x = jnp.asarray(inputs[f"{m}{i}"], wire)
        def one(b, kind=kind, detail=detail, shape=tuple(shape), dtype=dtype,
                axes=tuple(axes)):
            return comm.do({"b0": b}, "b0", kind=kind, axes=axes,
                           detail=detail, shape=shape, dtype=dtype)["b0"]
        sm = lambda f: jax.jit(shard_map(f, mesh=mesh, in_specs=(P(lead),),
                                         out_specs=P(lead), check_vma=False))
        out[f"bat_{m}{i}"] = sm(lambda s: jax.vmap(one)(s[0])[None])(x)
        out[f"seq_{m}{i}"] = jnp.stack(
            [sm(lambda s: one(s[0])[None])(x[:, j]) for j in range(x.shape[1])],
            axis=1)
save_arrays(OUT / "comm.npz", out)

# the planner on seeded random inputs
plans = []
for c in spec["plans"]:
    sig = {str(g[0][0]): tuple(g[0]) for g in c["groups"]}
    plan = plan_mesh_sweep([(tuple(g[0]), g[1]) for g in c["groups"]],
                           {sig[k]: v for k, v in c["hints"].items()},
                           c["axis_sizes"], c["n_devices"],
                           share_unit_groups=c["share"])
    plans.append([[list(p.ranks), list(p.device_ids),
                   [list(a) for a in p.axis_sizes]] for p in plan])

# the sweep end to end on the 8-rank trace, 4 devices
comm_ev = CommEvent("psum", (16,), "float32", ("x",))
perm = CommEvent("ppermute", (4, 4), "bfloat16", ("x",), ("shift", 1))
comp = ComputeEvent((2.1e6, 3.3e4, 1.1e6, 8.2e2, 0., 0.))
traces = []
for r in range(8):
    tr = [comp, comm_ev, comp, perm] * 6
    if r == 0:
        tr = tr + [comm_ev]
    traces.append(tr)
res = synthesize(rank_traces=traces, axis_sizes={"x": 8}, name="mesh_8")
mesh = make_replay_mesh(submesh_axis_sizes(4, {"x": 8}))
sweep = res.proxy.run_all(mesh=mesh, per_rank_seeds=True)
save_arrays(OUT / "sweep.npz", {f"{r}_{k}": v for r, st in sweep.items()
                                for k, v in st.items() if k.startswith("buf")})
fid = res.proxy.fidelity(res.rank_traces, sample_ranks=None, mesh=mesh)
dist = res.fidelity(sample_ranks=None, mesh=mesh, noise=NoiseConfig(3, 4))
np.savez(OUT / "fid.npz", delta=fid.delta, replica_delta=dist.replica_delta)
(OUT / "meta.json").write_text(json.dumps({
    "plans": plans, "mean": fid.mean, "mesh_checked": fid.mesh_checked,
    "comm_lossless": fid.comm_lossless,
    "noise_mesh_checked": dist.mesh_checked,
    "sweep_plan": [[list(p.ranks), list(p.device_ids),
                    [list(a) for a in p.axis_sizes]]
                   for p in res.proxy.mesh_sweep_plan(mesh)],
    "hints": [[k, v] for k, v in res.proxy.group_device_hints().items()]}))
"""


@pytest.fixture(scope="module")
def spec():
    return {"plans": _random_plans()}


@pytest.fixture(scope="module")
def reference(spec, tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_mesh")
    (out / "spec.json.in").write_text(json.dumps(spec))
    with open(out / "inputs.npz.in", "wb") as f:   # not read back as a result
        np.savez(f, **_comm_inputs())
    return run_reference(
        f"MESHES = {MESHES!r}\n" + REFERENCE_CODE, out, timeout=300,
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})


# ---------------------------------------------------------------------------
# a pool of four gloo processes, shared by the module
# ---------------------------------------------------------------------------

WORKER = r"""
import datetime, json, sys, traceback
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=90))
ns = {"rank": rank, "world": world}
for line in sys.stdin:
    task = json.loads(line)
    try:
        ns.pop("RESULT", None)
        exec(task["code"], ns)
        torch.save(ns.get("RESULT"), task["out"])
        print("@@DONE", flush=True)
    except BaseException:
        with open(task["out"] + ".err", "w") as f:
            f.write(traceback.format_exc())
        print("@@ERR", flush=True)
"""


class GlooPool:
    """``world`` (``WORLD`` by default) worker processes in one gloo group.
    :meth:`run` executes the same code in each (SPMD; ``rank`` and
    ``world`` are defined, names persist between tasks) and returns each
    process's ``RESULT``."""

    def __init__(self, root: Path, world: int = WORLD):
        self.root = root
        self.world = world
        self.n_tasks = 0
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]), OMP_NUM_THREADS="1")
        store = str(root / "store")
        self.procs, self.lines = [], []
        for r in range(world):
            err = open(root / f"worker{r}.stderr", "w")
            p = subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                                  str(world), store], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=err,
                                 text=True, env=env, cwd=str(ROOT))
            q: queue.Queue = queue.Queue()
            threading.Thread(target=self._pump, args=(p, q),
                             daemon=True).start()
            self.procs.append(p)
            self.lines.append(q)

    @staticmethod
    def _pump(proc, q):
        for line in proc.stdout:
            if line.startswith("@@"):
                q.put(line.strip())
        q.put("@@EXIT")

    def run(self, code: str, timeout: float = TASK_TIMEOUT) -> list:
        self.n_tasks += 1
        outs = [str(self.root / f"task{self.n_tasks}_rank{r}.pt")
                for r in range(self.world)]
        for p, out in zip(self.procs, outs):
            p.stdin.write(json.dumps({"code": code, "out": out}) + "\n")
            p.stdin.flush()
        status = []
        for q in self.lines:
            try:
                status.append(q.get(timeout=timeout))
            except queue.Empty:
                status.append("@@TIMEOUT")
        if any(s != "@@DONE" for s in status):
            errs = [Path(o + ".err").read_text() if Path(o + ".err").exists()
                    else s for o, s in zip(outs, status)]
            raise RuntimeError("gloo pool task failed:\n" + "\n".join(errs))
        return [torch.load(o, weights_only=False) for o in outs]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.stdin.close()
        for p in self.procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = GlooPool(tmp_path_factory.mktemp("gloo_pool"))
    yield p
    p.close()


# ---------------------------------------------------------------------------
# planner (pure): the reference's literal cases
# ---------------------------------------------------------------------------


def test_submesh_axis_sizes():
    assert submesh_axis_sizes(8, {"x": 16}) == {"x": 8}
    assert submesh_axis_sizes(8, {"data": 4, "model": 4}) == \
        {"data": 4, "model": 2}
    assert submesh_axis_sizes(6, {"x": 4}) == {"x": 2}
    assert submesh_axis_sizes(5, {"x": 16}) == {"x": 1}   # coprime → unit
    assert submesh_axis_sizes(3, {}) == {"x": 1}          # comm-free proxy
    assert submesh_axis_sizes(1, {"x": 16}) == {"x": 1}


def test_plan_proportional_disjoint():
    groups = [(("a",), [0]), (("b",), list(range(1, 16)))]
    plan = plan_mesh_sweep(groups, {("a",): 16, ("b",): 16}, {"x": 16}, 8)
    assert [p.n_devices for p in plan] == [4, 4]
    assert plan[0].device_ids == (0, 1, 2, 3)
    assert plan[1].device_ids == (4, 5, 6, 7)
    assert dict(plan[0].axis_sizes) == {"x": 4}
    assert plan[0].ranks == (0,) and plan[1].ranks == tuple(range(1, 16))
    assert isinstance(hash(plan[0]), int) and plan[0].key() != plan[1].key()


def test_plan_caps_at_hint_and_realizable():
    groups = [(("free",), [0]), (("big",), list(range(1, 16)))]
    plan = plan_mesh_sweep(groups, {("free",): 1, ("big",): 16}, {"x": 16}, 8)
    assert plan[0].n_devices == 1
    assert dict(plan[0].axis_sizes) == {"x": 1}
    assert plan[1].n_devices == 4
    assert dict(plan[1].axis_sizes) == {"x": 4}
    assert set(plan[0].device_ids).isdisjoint(plan[1].device_ids)


def test_plan_never_oversubscribes():
    groups = [((i,), [i]) for i in range(7)]
    hints = {(0,): 100, **{(i,): 1 for i in range(1, 7)}}
    plan = plan_mesh_sweep(groups, hints, {"x": 100}, 8)
    ids = [i for p in plan for i in p.device_ids]
    assert max(ids) < 8
    assert len(ids) == len(set(ids))
    assert all(p.n_devices >= 1 for p in plan)


def test_plan_wraps_when_groups_exceed_devices():
    groups = [((i,), [i]) for i in range(5)]
    plan = plan_mesh_sweep(groups, {}, {"x": 4}, 2)
    assert [p.device_ids for p in plan] == [(0,), (1,), (0,), (1,), (0,)]
    assert all(dict(p.axis_sizes) == {"x": 1} for p in plan)


def test_plan_empty_groups():
    assert plan_mesh_sweep([], {}, {"x": 4}, 8) == []


def test_count_scale_scaled_hints_and_unit_group_sharing(tmp_path):
    """``count_scale`` scales the generated device hints, and the planner
    packs the unit-hint groups onto one shared device under scarcity."""
    comp = ComputeEvent((2.1e6, 3.3e4, 1.1e6, 8.2e2, 0., 0.))
    comp2 = ComputeEvent((7.7e5, 1.1e4, 3.3e5, 0., 0., 1.0))
    big = CommEvent("psum", (16,), "float32", ("x", "y"))
    small = CommEvent("psum", (4,), "float32", ("y",))
    traces = [[comp, big] * 6 for _ in range(14)]
    traces.append([comp2, small] * 6)
    traces.append([comp2, small] * 6 + [small])
    axis = {"x": 8, "y": 2}
    full = synthesize(rank_traces=traces, axis_sizes=axis, name="cs_full",
                      device="cpu", out_dir=tmp_path)
    scaled = synthesize(rank_traces=traces, axis_sizes=axis,
                        count_scale=0.5, name="cs_half", device="cpu",
                        out_dir=tmp_path)
    assert sorted(g[2] for g in full.proxy.module.SIGNATURE_GROUPS) == \
        [2, 2, 16]
    assert sorted(g[2] for g in scaled.proxy.module.SIGNATURE_GROUPS) == \
        [1, 1, 8]
    plan = plan_mesh_sweep(scaled.proxy.signature_groups(),
                           scaled.proxy.group_device_hints(), axis, 8,
                           share_unit_groups=True)
    units = [p for p in plan if len(p.ranks) == 1]
    bigp = next(p for p in plan if len(p.ranks) > 1)
    assert len(units) == 2
    assert units[0].device_ids == units[1].device_ids
    assert set(units[0].device_ids).isdisjoint(bigp.device_ids)
    assert bigp.n_devices == 4
    plan2 = plan_mesh_sweep(full.proxy.signature_groups(),
                            full.proxy.group_device_hints(), axis, 8,
                            share_unit_groups=True)
    ids = [i for p in plan2 for i in p.device_ids]
    assert len(ids) == len(set(ids))
    plan3 = plan_mesh_sweep(
        [(("a",), [0]), (("b",), [1]), (("c",), [2])],
        {("a",): 4, ("b",): 1, ("c",): 1}, {"x": 8}, 8,
        share_unit_groups=True)
    ids3 = [i for p in plan3 for i in p.device_ids]
    assert len(ids3) == len(set(ids3))


def test_plan_equals_the_reference_on_seeded_random_inputs(spec, reference):
    cases = spec["plans"]
    got = [_plan_rows(c["groups"], c["hints"], c["axis_sizes"],
                      c["n_devices"], c["share"]) for c in cases]
    assert got == reference["meta"]["plans"]
    assert sum(len(p) for p in got) > 100       # the cases place groups


# ---------------------------------------------------------------------------
# DeviceComm on four gloo processes
# ---------------------------------------------------------------------------

COMM_TASK = """
import numpy as np, torch
from repro_torch.launch.mesh import Submesh
from repro_torch.sharding.collectives import DeviceComm
inputs = np.load(INPUTS)
RESULT = {}
for m, (sizes, cases) in MESHES.items():
    sub = Submesh(range(world), sizes, sorted({tuple(c[4]) for c in cases}))
    comm = DeviceComm(sub)
    for i, (kind, detail, shape, dtype, axes) in enumerate(cases):
        buf = torch.from_numpy(inputs[f"{m}{i}"][rank]).to(getattr(torch, dtype))
        kw = dict(kind=kind, axes=axes, detail=detail, shape=shape,
                  dtype=dtype)
        st = {"b0": buf, "other": torch.ones(2)}
        bat = comm.do(st, "b0", **kw)
        assert bat["other"] is st["other"] and st["b0"] is buf
        seq = torch.stack([comm.do({"b0": buf[j]}, "b0", **kw)["b0"]
                           for j in range(buf.shape[0])])
        RESULT[f"{m}{i}"] = (buf, bat["b0"], seq)
"""


def test_device_comm_every_kind_on_four_processes(pool, reference, tmp_path):
    """Every kind and fallback and perm decode, 1-D and 2-D sub-meshes:
    shape and dtype stable, stacked = one a member bit for bit, and each
    process's output = the reference's on its device bit for bit."""
    np.savez(tmp_path / "in.npz", **_comm_inputs())
    code = (f"INPUTS = {str(tmp_path / 'in.npz')!r}\n"
            f"MESHES = {MESHES!r}\n" + COMM_TASK)
    outs = pool.run(code)
    ref = reference["comm"]
    for m, (_, cases) in MESHES.items():
        for i, case in enumerate(cases):
            for r, out in enumerate(outs):
                buf, bat, seq = out[f"{m}{i}"]
                assert bat.shape == buf.shape and bat.dtype == buf.dtype, case
                assert torch.equal(bat, seq), (case, r)
                want_b = np.asarray(ref[f"bat_{m}{i}"][r], np.float32)
                want_s = np.asarray(ref[f"seq_{m}{i}"][r], np.float32)
                np.testing.assert_array_equal(bat.float().numpy(), want_b,
                                              err_msg=f"{case} rank {r}")
                np.testing.assert_array_equal(seq.float().numpy(), want_s,
                                              err_msg=f"{case} rank {r}")
    # the cases move data: a collective that passed its input through
    # would fail them
    moved = [(m, i) for m, (_, cases) in MESHES.items()
             for i in range(len(cases))
             if not torch.equal(outs[1][f"{m}{i}"][0], outs[1][f"{m}{i}"][1])]
    assert len(moved) == len(CASES_1D) + len(CASES_2D)


def test_mesh_constructors_on_four_processes(pool):
    code = """
from repro_torch.launch.mesh import (make_dp_mesh, make_replay_mesh,
                                     make_test_mesh, mesh_ranks)
t = make_test_mesh(2, 2)
d = make_dp_mesh(4)
r = make_replay_mesh({"x": 2}, devices=[2, 3])
RESULT = (tuple(t.mesh.shape), t.mesh_dim_names, t.device_type,
          mesh_ranks(d), d.mesh_dim_names, mesh_ranks(r))
"""
    for out in pool.run(code):
        assert out == ((2, 2), ("data", "model"), "cpu", (0, 1, 2, 3),
                       ("data",), (2, 3))


# ---------------------------------------------------------------------------
# the sweep end to end
# ---------------------------------------------------------------------------

SWEEP_TASK = """
import numpy as np, torch
from repro_torch.core.events import CommEvent, ComputeEvent
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.replay import submesh_axis_sizes
from repro_torch.core.synthesize import synthesize
from repro_torch.launch.mesh import make_replay_mesh

res = synthesize(rank_traces=_synth_traces(8), axis_sizes={"x": 8},
                 name="mesh_8", device="cpu", out_dir=f"{ROOT}/rank{rank}")
p = res.proxy
mesh = make_replay_mesh(submesh_axis_sizes(world, {"x": 8}))
plan = p.mesh_sweep_plan(mesh)
out_b = p.run_all(mesh=mesh, per_rank_seeds=True)
s1 = p.cache_stats()
out_s = p.run_all(mesh=mesh, per_rank_seeds=True, batched=False)
local = p.run_all(per_rank_seeds=True)
s2 = p.cache_stats()
p.run_all(mesh=mesh, per_rank_seeds=True)
s3 = p.cache_stats()
mesh2 = make_replay_mesh({"x": 2}, devices=[0, 1])
on2 = p.run_all(mesh=mesh2, per_rank_seeds=True)
s4 = p.cache_stats()
shared = p.run_all(mesh=mesh)
fid = res.fidelity(sample_ranks=None, mesh=mesh)
fid_local = res.fidelity(sample_ranks=None, batched=False)
cfg = NoiseConfig(3, 4)
dist_mesh = res.fidelity(sample_ranks=None, mesh=mesh, noise=cfg)
dist_local = res.fidelity(sample_ranks=None, noise=cfg)
t = p.time_all(mesh=mesh)
RESULT = dict(
    plan=[(pl.ranks, pl.device_ids, pl.axis_sizes) for pl in plan],
    out_b=out_b, out_s=out_s, local=local, on2=on2, shared=shared,
    stats=(s1, s2, s3, s4), delta=fid.delta, mean=fid.mean,
    mesh_checked=fid.mesh_checked, lossless=fid.comm_lossless,
    delta_local=fid_local.delta, local_checked=fid_local.mesh_checked,
    noise_mesh=dist_mesh.replica_delta, noise_local=dist_local.replica_delta,
    noise_cb=(dist_mesh.comm_bytes, dist_local.comm_bytes),
    noise_checked=dist_mesh.mesh_checked, time_all=t)
"""


def _same_states(a: dict, b: dict, what: str) -> None:
    assert sorted(a) == sorted(b), what
    for r in a:
        assert sorted(a[r]) == sorted(b[r]), (what, r)
        for k in a[r]:
            assert a[r][k].dtype == b[r][k].dtype, (what, r, k)
            assert torch.equal(a[r][k], b[r][k]), (what, r, k)


def test_mesh_sweep_on_four_processes(pool, reference, tmp_path):
    """The 8-rank trace on four processes: every process returns every
    rank's state, bit-equal to LocalSim's and to the sequential mesh
    baseline, with the reference's comm buffers, plan and δ̄."""
    outs = pool.run(f"ROOT = {str(tmp_path)!r}\n"
                    + inspect.getsource(_synth_traces) + SWEEP_TASK)
    meta = reference["meta"]
    o = outs[0]
    assert [[list(rs), list(ids), [list(a) for a in ax]]
            for rs, ids, ax in o["plan"]] == meta["sweep_plan"]
    for got in outs:
        _same_states(got["out_b"], o["out_b"], "processes agree")
        _same_states(got["out_b"], got["local"], "mesh vs LocalSim")
        _same_states(got["out_b"], got["out_s"], "batched vs sequential")
        _same_states(got["on2"], got["local"], "2-device mesh vs LocalSim")
        assert sorted(got["shared"]) == list(range(8))
    sweep = reference["sweep"]
    for r, st in o["out_b"].items():
        for k, v in st.items():
            if k.startswith("buf"):
                np.testing.assert_array_equal(
                    v.float().numpy(),
                    np.asarray(sweep[f"{r}_{k}"], np.float32))
    ref_delta = reference["fid"]["delta"]
    assert abs(o["mean"] - meta["mean"]) <= 1e-12
    np.testing.assert_allclose(o["delta"], ref_delta, rtol=0, atol=1e-12)
    assert np.array_equal(o["delta"], o["delta_local"])
    assert o["mesh_checked"] and meta["mesh_checked"]
    assert not o["local_checked"]
    assert o["lossless"] and meta["comm_lossless"]
    # the seeded noise distribution: mesh = LocalSim, bit for bit
    assert np.array_equal(o["noise_mesh"], o["noise_local"])
    assert np.array_equal(*o["noise_cb"])
    assert o["noise_checked"] and meta["noise_mesh_checked"]
    assert o["noise_mesh"].shape == reference["fid"]["replica_delta"].shape
    # placement cache: one bound program a group; a repeat sweep hits, a
    # new placement misses
    s1, s2, s3, s4 = o["stats"]
    assert s1["batch_cache_misses"] == len(o["plan"]) == 2
    assert s3["batch_cache_misses"] == s2["batch_cache_misses"]
    assert s3["batch_cache_hits"] > s2["batch_cache_hits"]
    assert s4["batch_cache_misses"] > s3["batch_cache_misses"]
    assert o["time_all"] > 0


def test_one_process_mesh_sweep_equals_local(tmp_path):
    """What the card runs on one NCCL process, on one gloo process: every
    group on the one device, every collective over a group of one.  No
    process group: the mesh functions and ``run_all(mesh=)`` raise."""
    res = synthesize(rank_traces=_synth_traces(8), axis_sizes={"x": 8},
                     name="mesh_one", device="cpu", out_dir=tmp_path)
    p = res.proxy
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        mesh_mod.make_replay_mesh({"x": 1})
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod.make_replay_mesh(submesh_axis_sizes(1, {"x": 8}))
        plan = p.mesh_sweep_plan(mesh)
        assert [pl.device_ids for pl in plan] == [(0,), (0,)]
        got = p.run_all(mesh=mesh, per_rank_seeds=True)
        _same_states(got, p.run_all(per_rank_seeds=True), "one process")
        fid = res.fidelity(sample_ranks=None, mesh=mesh)
        assert fid.mesh_checked
        assert np.array_equal(fid.delta,
                              res.fidelity(sample_ranks=None).delta)
        assert p.time_all(mesh=mesh) > 0
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        p.run_all(mesh=mesh)


def test_tensor_of_the_other_device_raises():
    """NCCL runs CUDA tensors and gloo CPU tensors: no staging."""
    mesh_mod.check_tensor_backend("gloo", torch.device("cpu"))
    mesh_mod.check_tensor_backend("nccl", torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="stages nothing"):
        mesh_mod.check_tensor_backend("gloo", torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="stages nothing"):
        mesh_mod.check_tensor_backend("nccl", torch.device("cpu"))


def test_group_device_hints_equal_the_reference(reference, tmp_path):
    res = synthesize(rank_traces=_synth_traces(8), axis_sizes={"x": 8},
                     name="mesh_hints", device="cpu", out_dir=tmp_path)
    got = json.loads(json.dumps(
        [[k, v] for k, v in res.proxy.group_device_hints().items()]))
    assert sorted(got) == sorted(reference["meta"]["hints"])
    assert sorted(v for _, v in got) == [8, 8]
