"""The port's data-parallel training tier against the JAX reference.

* The int8 quantizer (``train/compression.py``) bit for bit against the
  reference's in process, and the reference's 50-step error-feedback
  property on the port.
* On four gloo processes (one pool a module, as ``tests/test_torch_mesh.py``
  runs it) against the reference on a forced 4-device CPU mesh (one
  subprocess a module, started beside the pool):
  - ``make_manual_dp_train_step`` process by device: each process against
    **its own** device's shard (``addressable_shards``), since the
    reference's "replicated" outputs differ between devices (ROADMAP §3);
  - ``Trainer(mesh=make_dp_mesh(4))`` for 3 steps of the Llama and Whisper
    smoke configs, and ``reshard`` dp 4 -> dp 2 -> ``None``;
  - every instrumented wrapper kind on real tensors against ``lax`` in the
    reference's ``shard_map``, with the ``TraceSession`` events equal, and
    ``workloads.PROGRAMS``' stencil2d and dp_train executed for real;
  - crash/resume on the mesh trainer, checkpoints across the mesh and the
    single-device trainer, and the raises (sharded parameters, expert
    routing on a data size over 1, no bound mesh).
* ``Trainer(mesh=make_dp_mesh(1))`` on a one-process gloo group in this
  process, bit-equal to ``Trainer(None)``.

Parity levels (each test states its own): *train* is the loss within 1e-5
relative and each parameter leaf within 1e-4 of its largest |reference|
value (f32 sums in other orders: gloo's ring against XLA's all-reduce, a
mean of shard means against the global mean); the int8 error state within
one quantum (the leaf's scale) of the reference's, since a gradient that
differs in its last bit may move one ``round`` by a step; collectives on
small-integer inputs bit for bit (exact sums in any order).
"""
from __future__ import annotations

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.train import compression as JC
from repro_torch.configs import get, smoke
from repro_torch.launch.mesh import make_dp_mesh
from repro_torch.models.layers import tree_leaves
from repro_torch.train import compression as PC
from repro_torch.train.loop import Trainer
from test_torch_harness import run_reference
from test_torch_mesh import WORLD, GlooPool, _comm_inputs

#: the train level (module docstring)
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
#: the norm of a step's reduced gradient, relative (f32 sums in other orders)
GRAD_NORM_RTOL = 1e-4
#: the smoke global batch: 8 rows of 16 tokens, 2 rows a process
BATCH, SEQ = 8, 16
STEPS = 3

RING = tuple((i, (i + 1) % 4) for i in range(4))
#: (mesh, wrapper, axes, keyword arguments, input key of ``_comm_inputs``,
#: reshape of the (16, 8) input or None)
WRAPPER_CASES = [
    ("1d", "psum", "x", {}, "1d0", None),
    ("1d", "pmax", "x", {}, "1d1", None),
    ("1d", "all_gather", "x", {"gather_dim": 0}, "1d3", None),
    ("1d", "all_gather", "x", {"gather_dim": 1, "tiled": True}, "1d3", None),
    ("1d", "psum_scatter", "x", {"scatter_dim": 0}, "1d4", None),
    ("1d", "psum_scatter", "x", {"scatter_dim": 1}, "1d5", None),
    ("1d", "psum_scatter", "x", {"scatter_dim": 0, "tiled": False}, "1d4",
     (4, 4, 8)),
    ("1d", "all_to_all", "x", {"split_axis": 0, "concat_axis": 1}, "1d7",
     None),
    ("1d", "all_to_all", "x", {"split_axis": 1, "concat_axis": 0}, "1d8",
     None),
    ("1d", "all_to_all", "x", {"split_axis": 0, "concat_axis": 2,
                               "tiled": False}, "1d7", (4, 4, 8)),
    ("1d", "ppermute", "x", {"perm": RING}, "1d10", None),
    ("1d", "ppermute", "x", {"perm": ((0, 2), (2, 0))}, "1d11", None),
    ("2d", "psum", ("data", "model"), {}, "2d1", None),
    ("2d", "psum", "model", {}, "2d0", None),
    ("2d", "pmax", "data", {}, "2d0", None),
    ("2d", "all_gather", ("model", "data"), {"gather_dim": 0}, "2d2", None),
    ("2d", "psum_scatter", "data", {"scatter_dim": 1}, "2d3", None),
    ("2d", "psum_scatter", ("model", "data"), {"scatter_dim": 0}, "2d7",
     None),
    ("2d", "all_to_all", "data", {"split_axis": 0, "concat_axis": 1}, "2d3",
     None),
    ("2d", "all_to_all", ("model", "data"), {"split_axis": 0,
                                              "concat_axis": 1}, "2d4", None),
    ("2d", "ppermute", "model", {"perm": ((0, 1), (1, 0))}, "2d5", None),
    ("2d", "ppermute", ("model", "data"),
     {"perm": ((0, 3), (3, 1), (1, 2), (2, 0))}, "2d6", None),
]
SIZES = {"1d": {"x": 4}, "2d": {"data": 2, "model": 2}}
#: the trainer's configs, by the name of their files
TAGS = {"llama3.2-3b": "llama", "whisper-large-v3": "whisper"}


def _program_inputs(seed: int = 5) -> dict[str, np.ndarray]:
    """Random global inputs of the paper's two traced programs at 4 ranks
    (stencil2d: 3 iterations; dp_train: 2 layers)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return {"stencil_u": rng.normal(0, 1, (256, 128 * 4)).astype(f),
            "stencil_w": (0.08 * rng.normal(0, 1, (128, 128))).astype(f),
            "dp_x": rng.normal(0, 1, (16 * 4, 512)).astype(f),
            "dp_ws": (0.04 * rng.normal(0, 1, (2, 512, 512))).astype(f)}


REFERENCE_CODE = """
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get, smoke
from repro.core.tracer import TraceSession
from repro.launch.mesh import make_dp_mesh
from repro.models.model import build_forward, init_params
from repro.sharding import collectives as C
from repro.train.compression import init_error_state
from repro.train.data import TokenDataset
from repro.train.loop import Trainer, make_manual_dp_train_step
from repro.train.optimizer import adamw_init
import benchmarks.common as programs

assert jax.device_count() == 4
inputs = np.load(OUT / "inputs.npz.in")

def per_device(x, mesh):
    by_id = {s.device.id: np.asarray(s.data) for s in x.addressable_shards}
    return np.stack([by_id[d.id] for d in mesh.devices.flat])

# -- the manual-DP step, process by device ------------------------------------
cfg = smoke(get("llama3.2-3b"))
mesh = make_dp_mesh(4)
params = init_params(cfg, 0)
save_arrays(OUT / "init_llama.npz",
            {str(i): a for i, a in enumerate(jax.tree.leaves(params))})
loss_fn = build_forward(cfg, "loss")
ds = TokenDataset(cfg.vocab, SEQ, BATCH, seed=3)
b0 = {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}
rows = BATCH // 4
scales = []
for d in range(4):
    shard = {k: v[d * rows:(d + 1) * rows] for k, v in b0.items()}
    g = jax.grad(lambda p: loss_fn(p, shard, cfg, None))(params)
    scales.append([float(jnp.max(jnp.abs(x.astype(jnp.float32)))) / 127.0
                   for x in jax.tree.leaves(g)])
step = make_manual_dp_train_step(cfg, mesh)
p, opt, err = params, adamw_init(params), init_error_state(params)
manual = {"scale1": np.asarray(scales)}
for i in range(2):
    batch = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
    p, opt, err, m = step(p, opt, err, batch)
    manual[f"loss{i}"] = per_device(m["loss"], mesh)
    manual[f"gn{i}"] = per_device(m["grad_norm"], mesh)
    for j, leaf in enumerate(jax.tree.leaves(p)):
        manual[f"p{i}_{j}"] = per_device(leaf, mesh)
    for j, leaf in enumerate(jax.tree.leaves(err)):
        manual[f"e{i}_{j}"] = per_device(leaf, mesh)
save_arrays(OUT / "manual.npz", manual)

# -- Trainer on the dp 4 mesh, and reshard -------------------------------------
def spy(t, norms):
    # record the norm of each step's reduced gradient (the log has none)
    inner = t.step_fn
    def step(p, o, b):
        p, o, m = inner(p, o, b)
        norms.append(float(m["grad_norm"]))
        return p, o, m
    t.step_fn = step

meta = {}
for arch in ("llama3.2-3b", "whisper-large-v3"):
    c = smoke(get(arch))
    if arch != "llama3.2-3b":
        save_arrays(OUT / f"init_{TAGS[arch]}.npz",
                    {str(i): a for i, a in
                     enumerate(jax.tree.leaves(init_params(c, 0)))})
    t = Trainer(c, make_dp_mesh(4), global_batch=BATCH, seq_len=SEQ,
                ckpt_dir=str(OUT / f"ck_{arch}"))
    norms = meta[f"gn_{arch}"] = []
    spy(t, norms)
    meta[arch] = [r["loss"] for r in t.run(STEPS)]
    save_arrays(OUT / f"trained_{TAGS[arch]}.npz",
                {str(i): np.asarray(a)
                 for i, a in enumerate(jax.tree.leaves(t.params))})
t = Trainer(cfg, make_dp_mesh(4), global_batch=BATCH, seq_len=SEQ,
            ckpt_dir=str(OUT / "ck_reshard"))
norms = meta["gn_reshard"] = []
spy(t, norms)
t.run(2, ckpt_every=1)
t.reshard(make_dp_mesh(2))
spy(t, norms)
t.run(2)
t.reshard(None)
spy(t, norms)
t.run(2)
meta["reshard"] = [r["loss"] for r in t.metrics_log]

# -- the instrumented wrappers under shard_map, with a TraceSession ----------
out, events = {}, {}
for i, (m, kind, axes, kw, key, shape) in enumerate(WRAPPER_CASES):
    sizes = SIZES[m]
    mesh = make_mesh(tuple(sizes.values()), tuple(sizes))
    lead = tuple(sizes)
    x = inputs[key][:, 0]
    if shape is not None:
        x = x.reshape((x.shape[0],) + tuple(shape))
    fn = getattr(C, kind)
    def one(s, fn=fn, axes=axes, kw=kw):
        return fn(s[0], axes if isinstance(axes, str) else tuple(axes),
                  **kw)[None]
    with TraceSession(n_ranks=4) as sess:
        f = jax.jit(shard_map(one, mesh=mesh, in_specs=(P(lead),),
                              out_specs=P(lead), check_vma=False))
        out[str(i)] = f(jnp.asarray(x))
    events[str(i)] = [[e.kind, list(e.shape), e.dtype, list(e.axes),
                       json.loads(json.dumps(e.detail))]
                      for e in sess.rank_streams[0]]
save_arrays(OUT / "wrappers.npz", out)
meta["events"] = events

# -- the paper's programs under shard_map, at 4 ranks --------------------------
f, _, _ = programs.stencil_program(n=4, length=3)
u, rs = f(jnp.asarray(inputs["stencil_u"]), jnp.asarray(inputs["stencil_w"]))
f, _, _ = programs.allreduce_train_program(n=4, layers=2)
tot = f(jnp.asarray(inputs["dp_x"]), jnp.asarray(inputs["dp_ws"]))
save_arrays(OUT / "programs.npz", {"u": u, "rs": rs, "tot": tot})
(OUT / "meta.json").write_text(json.dumps(meta))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run, started in the background beside the pool."""
    out = tmp_path_factory.mktemp("ref_dp")
    with open(out / "inputs.npz.in", "wb") as f:    # not read back as a result
        np.savez(f, **_comm_inputs(), **_program_inputs())
    code = (f"WRAPPER_CASES = {WRAPPER_CASES!r}\nSIZES = {SIZES!r}\n"
            f"TAGS = {TAGS!r}\n"
            f"BATCH, SEQ, STEPS = {BATCH}, {SEQ}, {STEPS}\n"
            + REFERENCE_CODE)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(lambda: {**run_reference(code, out, 600, env),
                             "_dir": out})
    yield fut
    ex.shutdown(wait=True)


@pytest.fixture(scope="module")
def pool(tmp_path_factory, reference):
    p = GlooPool(tmp_path_factory.mktemp("gloo_dp"))
    yield p
    p.close()


def _leaves_of(arrays: dict) -> list[np.ndarray]:
    return [arrays[str(i)] for i in range(len(arrays))]


def _leaf_close(got, want, rtol: float, what: str) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * top, f"{what}: {err} > {rtol} * {top}"
    return err / top if top else 0.0


#: the pool's helpers: the reference's initial weights loaded into a port
#: tree (leaves in ``tree_leaves`` order)
POOL_HELPERS = """
import numpy as np, torch
from repro_torch.configs import get, smoke
from repro_torch.launch.mesh import make_dp_mesh, make_test_mesh
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import init_params
from repro_torch.train.data import TokenDataset
from repro_torch.train.loop import Trainer, _InjectedFailure
from repro_torch.train.optimizer import adamw_init

def load_leaves(tree, path):
    arrs = np.load(path)
    idx = {id(t): i for i, t in enumerate(tree_leaves(tree))}
    assert len(idx) == len(arrs.files)
    return tree_map(lambda t: torch.from_numpy(np.array(arrs[str(idx[id(t)])]))
                    .to(t.device, t.dtype), tree)

def start(t, path):
    t.params = load_leaves(t.params, path)
    t.opt_state = adamw_init(t.params)
    return t

def np_leaves(tree):
    return [t.detach().clone() for t in tree_leaves(tree)]

def spy(t, norms):
    # record the norm of each step's reduced gradient (the log has none)
    inner = t.step_fn
    def step(p, o, b):
        p, o, m = inner(p, o, b)
        norms.append(float(m["grad_norm"]))
        return p, o, m
    t.step_fn = step
"""


# ---------------------------------------------------------------------------
# the quantizer, in process
# ---------------------------------------------------------------------------


def _grad_tree(rng, step: int) -> dict:
    g = {"w": rng.normal(0, 1, (64, 33)).astype(np.float32),
         "stack": (rng.normal(0, 1, (3, 17, 8)) ** 3).astype(np.float32),
         "zero": np.zeros((5,), np.float32),
         # exact halves at scale 1: 127 sets the scale, the rest tie
         "ties": np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5],
                            np.float32)}
    if step % 2:
        g["w"] *= 1e-3
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_is_the_references_bit_for_bit(dtype):
    """Five steps of ``quantize_tree`` with the error state fed back, and
    ``dequantize_tree``: q, scales, the new error and the dequantized
    values bit-identical to the reference's (bf16 gradients too: the cast
    to f32 is exact)."""
    rng = np.random.RandomState(0)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    jerr = terr = None
    for step in range(5):
        g = _grad_tree(rng, step)
        jg = {k: jnp.asarray(v, jd) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.array(jnp.asarray(v, jd)
                                             .astype(jnp.float32))).to(td)
              for k, v in g.items()}
        if jerr is None:
            jerr, terr = JC.init_error_state(jg), PC.init_error_state(tg)
        jq, js, jerr = JC.quantize_tree(jg, jerr)
        tq, ts, terr = PC.quantize_tree(tg, terr)
        jdq, tdq = JC.dequantize_tree(jq, js), PC.dequantize_tree(tq, ts)
        for k in g:
            assert tq[k].dtype == torch.int8 and terr[k].dtype == torch.float32
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            assert ts[k].numpy().tobytes() == np.asarray(js[k]).tobytes()
            assert terr[k].numpy().tobytes() == \
                np.asarray(jerr[k]).tobytes(), (step, k)
            assert tdq[k].numpy().tobytes() == np.asarray(jdq[k]).tobytes()
    # half to even at the ties (scale 1 at step 0 of a fresh state)
    q, s, _ = PC._leaf_quant(torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5]),
                             torch.zeros(5))
    assert float(s) == 1.0 and q.tolist() == [127, 0, 2, 2, 0]


def test_int8_error_feedback_unbiased():
    """The reference's property (``tests/test_train_infra.py``): the error
    is carried, so the mean of 50 dequantized steps of one gradient is the
    gradient to 2e-3."""
    rng = np.random.RandomState(0)
    g_true = {"w": torch.from_numpy(rng.normal(0, 1, (256,))
                                    .astype(np.float32))}
    err = PC.init_error_state(g_true)
    acc = np.zeros((256,))
    steps = 50
    for _ in range(steps):
        q, scales, err = PC.quantize_tree(g_true, err)
        acc += PC.dequantize_tree(q, scales)["w"].numpy()
    np.testing.assert_allclose(acc / steps, g_true["w"].numpy(), atol=2e-3)
    # one step alone is off by up to half a quantum: the feedback is what
    # brings the mean within the limit
    q, s, _ = PC.quantize_tree(g_true, PC.init_error_state(g_true))
    one = PC.dequantize_tree(q, s)["w"].numpy()
    assert np.abs(one - g_true["w"].numpy()).max() > 2e-3


# ---------------------------------------------------------------------------
# one gloo process in this process
# ---------------------------------------------------------------------------


def test_dp1_trainer_is_bit_equal_to_the_single_device_trainer(tmp_path):
    """What the card runs on a one-process NCCL group, on one gloo process:
    the batch is whole and every all-reduce is over a group of one, so
    ``Trainer(mesh=make_dp_mesh(1))`` gives the single-device trainer's
    losses, weights and moments bit for bit; ``compressed_psum`` on a group
    of one is the quantizer's dequantized value."""
    cfg = smoke(get("llama3.2-3b"))
    kw = dict(global_batch=4, seq_len=SEQ, device="cpu")
    single = Trainer(cfg, None, ckpt_dir=tmp_path / "single", **kw)
    log_s = single.run(STEPS, ckpt_every=2)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = Trainer(cfg, make_dp_mesh(1), ckpt_dir=tmp_path / "mesh", **kw)
        assert mesh.active and mesh.device.type == "cpu"
        log_m = mesh.run(STEPS, ckpt_every=2)
        g = torch.randn(40, 7)
        err = torch.zeros(40, 7)
        q, s, want_err = PC._leaf_quant(g, torch.zeros(40, 7))
        out, new_err = PC.compressed_psum(g, None, err)
        assert new_err is err and torch.equal(err, want_err)
        assert torch.equal(out, q.float() * s)
    finally:
        dist.destroy_process_group()
    assert [m["loss"] for m in log_m] == [m["loss"] for m in log_s]
    for a, b in zip(tree_leaves(mesh.params), tree_leaves(single.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(mesh.opt_state),
                    tree_leaves(single.opt_state)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# four gloo processes against the reference's four devices
# ---------------------------------------------------------------------------

MANUAL_TASK = """
from repro_torch.train.compression import init_error_state
from repro_torch.train.loop import make_manual_dp_train_step
cfg = smoke(get("llama3.2-3b"))
params = load_leaves(init_params(cfg, 0, "cpu"), f"{REF}/init_llama.npz")
step = make_manual_dp_train_step(cfg, make_dp_mesh(4))
opt, err = adamw_init(params), init_error_state(params)
ds = TokenDataset(cfg.vocab, SEQ, BATCH, seed=3)
RESULT = {}
for i in range(2):
    params, opt, err, m = step(params, opt, err, ds.batch_at(i))
    RESULT[i] = (float(m["loss"]), np_leaves(params), np_leaves(err),
                 float(m["grad_norm"]))
"""


def test_manual_dp_step_process_by_device(pool, reference):
    """Two int8 error-feedback DP steps of the smoke Llama (8 × 16, 2 rows
    a process): each process's loss, parameters and error state against
    its own device's, at the train level and within one quantum, and the
    norm of its reduced gradient within 1e-4 (a quantum's worth of the
    dequantized sum); the processes' parameters differ from each other, as
    the devices' do."""
    ref = reference.result()
    outs = pool.run(f"REF = {str(ref['_dir'])!r}\nSEQ, BATCH = {SEQ}, "
                    f"{BATCH}\n" + POOL_HELPERS + MANUAL_TASK)
    man = ref["manual"]
    scale1 = man["scale1"]                     # (device, leaf) at step 1
    flips, ref_split, port_split = 0, set(), set()
    for i in range(2):
        for r, out in enumerate(outs):
            loss, params, err, gn = out[i]
            want = float(man[f"loss{i}"][r])
            assert abs(loss - want) <= LOSS_RTOL * abs(want), (i, r)
            # the reduced gradient's norm: a sum where the mean belongs is
            # 4 times off (AdamW's update alone would not show it)
            want = float(man[f"gn{i}"][r])
            assert abs(gn - want) <= GRAD_NORM_RTOL * want, (i, r, gn, want)
            for j, (p, e) in enumerate(zip(params, err)):
                _leaf_close(p.numpy(), man[f"p{i}_{j}"][r], PARAM_RTOL,
                            f"step {i} process {r} leaf {j}")
                if i == 0:
                    d = np.abs(e.numpy() - man[f"e0_{j}"][r])
                    assert d.max() <= scale1[r, j] * (1 + 1e-3), (r, j)
                    flips += int((d > scale1[r, j] / 2).sum())
        for j in range(len(outs[0][i][1])):
            if np.abs(man[f"p{i}_{j}"] - man[f"p{i}_{j}"][:1]).max() > 0:
                ref_split.add((i, j))
            if any(not torch.equal(o[i][1][j], outs[0][i][1][j])
                   for o in outs):
                port_split.add((i, j))
    n_el = sum(e.numel() for e in outs[0][0][2]) * WORLD
    spread = [(float(np.abs(man[f"p0_{j}"] - man[f"p0_{j}"][:1]).max()),
               max(float((o[0][1][j] - outs[0][0][1][j]).abs().max())
                   for o in outs)) for j in range(len(outs[0][0][1]))]
    print(f"int8 steps: {flips} of {n_el} error elements a quantum apart "
          f"(a rounding moved); replicas that differ: reference "
          f"{sorted(ref_split)}, port {sorted(port_split)}; after one step, "
          f"max |device k - device 0| a leaf (reference, port): {spread}")
    # the reference's replicas diverge (ROADMAP §3), and the port's
    # processes, each dequantizing with its own scale, do too
    assert ref_split and port_split
    assert flips <= 1e-3 * n_el


TRAINER_TASK = """
RESULT = {}
for arch in ("llama3.2-3b", "whisper-large-v3"):
    cfg = smoke(get(arch))
    t = Trainer(cfg, make_dp_mesh(4), global_batch=BATCH, seq_len=SEQ,
                ckpt_dir=f"{ROOT}/ck_{arch}")
    start(t, f"{REF}/init_{TAGS[arch]}.npz")
    norms = []
    spy(t, norms)
    log = t.run(STEPS)
    RESULT[arch] = ([m["loss"] for m in log], np_leaves(t.params),
                    t.device.type, t.active, norms)
"""


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-large-v3"])
def test_mesh_trainer_matches_the_references(pool, reference, tmp_path, arch):
    """``Trainer(mesh=make_dp_mesh(4))``, 3 steps from the reference's
    weights (Whisper's frames ride along, split by rows): losses and the
    trained weights at the train level, and the norm of each step's
    reduced gradient within 1e-4 relative of the reference's (AdamW's
    update and the clip cancel a gradient's scale, so the weights alone
    would not show a sum where the mean belongs); every process holds the
    same weights and norms bit for bit (the gradient mean is all-reduced)."""
    ref = reference.result()
    if not hasattr(pool, "trained"):
        pool.trained = pool.run(
            f"REF = {str(ref['_dir'])!r}\nROOT = {str(tmp_path)!r}\n"
            f"SEQ, BATCH, STEPS = {SEQ}, {BATCH}, {STEPS}\n"
            f"TAGS = {TAGS!r}\n" + POOL_HELPERS + TRAINER_TASK)
    outs = pool.trained
    want = ref["meta"][arch]
    trained = _leaves_of(ref[f"trained_{TAGS[arch]}"])
    want_gn = ref["meta"][f"gn_{arch}"]
    for r, out in enumerate(outs):
        losses, params, device, active, norms = out[arch]
        assert device == "cpu" and active
        assert len(losses) == STEPS and len(norms) == STEPS
        for got, w in zip(losses, want):
            assert abs(got - w) <= LOSS_RTOL * abs(w), (r, losses, want)
        for got, w in zip(norms, want_gn):
            assert abs(got - w) <= GRAD_NORM_RTOL * w, (r, norms, want_gn)
        assert norms == outs[0][arch][4]
        assert len(params) == len(trained)
        for j, (p, w) in enumerate(zip(params, trained)):
            _leaf_close(p.numpy(), w, PARAM_RTOL, f"process {r} leaf {j}")
            assert torch.equal(p, outs[0][arch][1][j])


RESHARD_TASK = """
cfg = smoke(get("llama3.2-3b"))
t = Trainer(cfg, make_dp_mesh(4), global_batch=BATCH, seq_len=SEQ,
            ckpt_dir=f"{ROOT}/ck_reshard")
start(t, f"{REF}/init_llama.npz")
norms = []
spy(t, norms)
t.run(2, ckpt_every=1)
t.reshard(make_dp_mesh(2))
mid = (t.active, t.step)
spy(t, norms)
t.run(2)
t.reshard(None)
spy(t, norms)
t.run(2)
RESULT = ([m["loss"] for m in t.metrics_log], mid, t.active, t.step,
          None if t.params is None else np_leaves(t.params), norms)
"""


def test_reshard_dp4_dp2_none_matches_the_references_losses(pool, reference,
                                                            tmp_path):
    """dp 4 (2 steps, a checkpoint each) -> dp 2 (2 steps) -> ``None`` (2
    steps): process 0 carries the reference's six losses (train level) and
    the norms of its six reduced gradients (within 1e-4 relative: a
    division by the wrong group size would show there); processes 2 and 3
    drop their state at dp 2, process 1 at ``None``."""
    ref = reference.result()
    outs = pool.run(f"REF = {str(ref['_dir'])!r}\nROOT = {str(tmp_path)!r}\n"
                    f"SEQ, BATCH = {SEQ}, {BATCH}\n" + POOL_HELPERS
                    + RESHARD_TASK)
    want = ref["meta"]["reshard"]
    assert len(want) == 6
    want_gn = ref["meta"]["gn_reshard"]
    losses, mid, active, step, params, norms = outs[0]
    assert len(losses) == 6 and active and step == 6 and mid == (True, 2)
    for got, w in zip(losses, want):
        assert abs(got - w) <= LOSS_RTOL * abs(w), (losses, want)
    assert len(norms) == len(want_gn) == 6
    for got, w in zip(norms, want_gn):
        assert abs(got - w) <= GRAD_NORM_RTOL * w, (norms, want_gn)
    assert outs[1][5] == norms[:4]
    assert outs[2][5] == outs[3][5] == norms[:2]
    assert outs[1][0] == losses[:4] and outs[1][1] == (True, 2)
    assert not outs[1][2] and outs[1][4] is None
    for r in (2, 3):
        assert outs[r][0] == losses[:2] and outs[r][1] == (False, 2)
        assert not outs[r][2] and outs[r][4] is None


CRASH_TASK = """
cfg = smoke(get("llama3.2-3b"))
kw = dict(global_batch=BATCH, seq_len=SEQ)
t1 = Trainer(cfg, make_dp_mesh(4), ckpt_dir=f"{ROOT}/a", **kw)
log1 = t1.run(4, ckpt_every=2)
t2 = Trainer(cfg, make_dp_mesh(4), ckpt_dir=f"{ROOT}/b", **kw)
crashed = []
def inject(step):
    if step == 3 and not crashed:
        crashed.append(step)
        raise _InjectedFailure("simulated node loss")
log2 = t2.run(4, ckpt_every=2, failure_injector=inject)
same = (all(torch.equal(a, b) for a, b in zip(tree_leaves(t1.params),
                                               tree_leaves(t2.params)))
        and all(torch.equal(a, b) for a, b in zip(tree_leaves(t1.opt_state),
                                                   tree_leaves(t2.opt_state))))
# the single-device trainer's checkpoint, restored on the mesh
t3 = Trainer(cfg, make_dp_mesh(4), ckpt_dir=f"{ROOT}/single", **kw)
t3.restore()
RESULT = dict(crashed=crashed, log1=[(m["step"], m["loss"]) for m in log1],
              log2=[(m["step"], m["loss"]) for m in log2], same=same,
              params=np_leaves(t1.params), step3=t3.step,
              restored=np_leaves(t3.params))
"""


def test_mesh_crash_resume_and_checkpoints_across_trainers(pool, tmp_path):
    """A failure at step 3 of 4 (checkpoints every 2) on the mesh trainer
    replays to the uninterrupted run bit for bit on every process; the
    mesh's checkpoint (written once, by process 0) restores in the
    single-device ``Trainer`` to the same bits, and a single-device
    checkpoint restores on the mesh."""
    cfg = smoke(get("llama3.2-3b"))
    single = Trainer(cfg, None, global_batch=BATCH, seq_len=SEQ,
                     ckpt_dir=tmp_path / "single", device="cpu")
    single.run(2, ckpt_every=2)
    outs = pool.run(f"ROOT = {str(tmp_path)!r}\nSEQ, BATCH = {SEQ}, "
                    f"{BATCH}\n" + POOL_HELPERS + CRASH_TASK)
    for out in outs:
        assert out["crashed"] == [3] and out["same"]
        l1, l2 = dict(out["log1"]), dict(out["log2"])
        assert len(out["log2"]) > len(out["log1"]) and l1 == l2
        for a, b in zip(out["params"], outs[0]["params"]):
            assert torch.equal(a, b)
        assert out["step3"] == 2
        for a, b in zip(out["restored"], tree_leaves(single.params)):
            assert torch.equal(a, b)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        ["step_00000002", "step_00000004"]
    back = Trainer(cfg, None, global_batch=BATCH, seq_len=SEQ,
                   ckpt_dir=tmp_path / "a", device="cpu")
    assert back.restore() and back.step == 4
    for a, b in zip(tree_leaves(back.params), outs[0]["params"]):
        assert torch.equal(a, b)


WRAPPER_TASK = """
import numpy as np, torch
from repro_torch.core.tracer import TraceSession
from repro_torch.launch.mesh import make_replay_mesh
from repro_torch.sharding import collectives as C
inputs = np.load(INPUTS)
subs = {}
for m, s in SIZES.items():
    with C.bind_mesh(make_replay_mesh(s)) as sub:
        subs[m] = sub
RESULT = {}
for i, (m, kind, axes, kw, key, shape) in enumerate(WRAPPER_CASES):
    x = torch.from_numpy(np.array(inputs[key][rank, 0]))
    if shape is not None:
        x = x.reshape(shape)
    with C.bind_mesh(subs[m]), TraceSession(4) as sess:
        y = getattr(C, kind)(x, axes, **kw)
    RESULT[i] = (y, [[e.kind, list(e.shape), e.dtype, list(e.axes),
                      json.loads(json.dumps(e.detail))]
                     for e in sess.rank_streams[0]])
"""


def test_wrappers_on_real_tensors_match_lax(pool, reference, tmp_path):
    """Every wrapper kind, tiled and not, over one axis and two (in both
    orders), on a 1-D and a 2 × 2 mesh of four processes: each process's
    output equal to its device's under the reference's ``shard_map`` bit
    for bit (small integers: exact sums), and the ``TraceSession`` events
    the reference's."""
    ref = reference.result()
    np.savez(tmp_path / "in.npz", **_comm_inputs())
    outs = pool.run(f"import json\nINPUTS = {str(tmp_path / 'in.npz')!r}\n"
                    f"WRAPPER_CASES = {WRAPPER_CASES!r}\nSIZES = {SIZES!r}\n"
                    + WRAPPER_TASK)
    moved = 0
    for i, case in enumerate(WRAPPER_CASES):
        want = ref["wrappers"][str(i)]
        for r, out in enumerate(outs):
            y, events = out[i]
            assert tuple(y.shape) == want.shape[1:], (case, r)
            np.testing.assert_array_equal(y.numpy(), want[r],
                                          err_msg=f"{case} rank {r}")
            assert events == ref["meta"]["events"][str(i)], case
        x = _comm_inputs()[case[4]][1, 0]
        moved += not (outs[1][i][0].shape == x.shape
                      and np.array_equal(outs[1][i][0].numpy(), x))
    assert moved == len(WRAPPER_CASES)


PROGRAM_TASK = """
import numpy as np, torch
from repro_torch.launch.mesh import make_replay_mesh
from repro_torch.sharding import collectives as C
from repro_torch.workloads import PROGRAMS
inp = {k: torch.from_numpy(v) for k, v in np.load(INPUTS).items()}
with C.bind_mesh(make_replay_mesh({"x": 4})):
    fn, args, axes = PROGRAMS["stencil2d"](n=4, length=3)
    u = inp["stencil_u"][:, 128 * rank:128 * (rank + 1)]
    u_out, rs = fn(u.contiguous(), inp["stencil_w"])
    fn, args, axes = PROGRAMS["dp_train"](n=4, layers=2)
    tot = fn(inp["dp_x"][16 * rank:16 * (rank + 1)], inp["dp_ws"])
RESULT = (u_out, rs, tot, tuple(args[0].shape))
"""


def test_programs_run_for_real_against_the_references(pool, reference,
                                                      tmp_path):
    """``workloads.PROGRAMS``' stencil2d (3 iterations of halo ppermutes,
    matmuls and a psum) and dp_train (2 layers of per-layer psums) executed
    on four processes, each rank its block of the reference's global
    inputs: outputs within 1e-5 of the largest (f32 products and sums in
    other orders)."""
    ref = reference.result()
    np.savez(tmp_path / "in.npz", **_program_inputs())
    outs = pool.run(f"INPUTS = {str(tmp_path / 'in.npz')!r}\n"
                    + PROGRAM_TASK)
    want = ref["programs"]
    for r, (u, rs, tot, shape) in enumerate(outs):
        assert shape == (16, 512)
        _leaf_close(u.numpy(), want["u"][:, 128 * r:128 * (r + 1)], 1e-5,
                    f"stencil u rank {r}")
        _leaf_close(rs.numpy(), want["rs"], 1e-5, "stencil psums")
        _leaf_close(tot.numpy(), want["tot"], 1e-5, "dp_train total")
    assert not torch.equal(outs[0][0], outs[1][0])


RAISE_TASK = """
import dataclasses
from repro_torch.sharding import collectives as C
RESULT = {}
mixtral = smoke(get("mixtral-8x22b"))
cases = {"deepseek_dp4": (smoke(get("deepseek-moe-16b")), make_dp_mesh(4)),
         "mixtral_dp4": (dataclasses.replace(mixtral, rules_overrides=()),
                         make_dp_mesh(4)),
         "llama_2x2": (smoke(get("llama3.2-3b")), make_test_mesh(2, 2)),
         "mixtral_1x4": (mixtral, make_test_mesh(1, 4)),
         "mamba_1x4": (dataclasses.replace(smoke(get("mamba2-2.7b")),
                                           ssm_head_dim=64),
                       make_test_mesh(1, 4))}
for name, (cfg, mesh) in cases.items():
    try:
        t = Trainer(cfg, mesh, global_batch=BATCH, seq_len=SEQ,
                    ckpt_dir=f"{ROOT}/{name}")
        RESULT[name] = [m["loss"] for m in t.run(1)]
    except NotImplementedError as e:
        RESULT[name] = str(e)
try:
    C.psum(torch.ones(3), "data")
    RESULT["unbound"] = None
except RuntimeError as e:
    RESULT["unbound"] = str(e)
"""


def test_what_still_raises_on_four_processes(pool, tmp_path):
    """A Mamba2 smoke variant with 2 SSM heads on a 1 × 4 mesh (heads the
    model axis does not divide) raises ``NotImplementedError`` naming item
    12; DeepSeek smoke on dp 4 (its ``("embed", "data")`` override shards
    the embed dims of its MoE layers; each process routes its rows as a
    data shard), Mixtral without its overrides on dp 4 (every weight
    replicated, but it routes experts on a data size of 4) and Mixtral on
    a 1 × 4 mesh (each expert's FFN split over ``model``) train a step
    since the MoE slice, as Llama on a 2 × 2 ``data × model`` mesh does
    since the tensor-parallel slice (the same loss on every process;
    ``tests/test_torch_tp.py`` and ``tests/test_torch_tp_families.py``
    hold them to the reference); a wrapper on a real tensor with no bound
    mesh raises."""
    outs = pool.run(f"ROOT = {str(tmp_path)!r}\nSEQ, BATCH = {SEQ}, "
                    f"{BATCH}\n" + POOL_HELPERS + RAISE_TASK)
    for out in outs:
        assert isinstance(out["mamba_1x4"], str) and \
            "item 12" in out["mamba_1x4"] and "SSM heads" in \
            out["mamba_1x4"], out["mamba_1x4"]
        for name in ("llama_2x2", "deepseek_dp4", "mixtral_dp4",
                     "mixtral_1x4"):
            assert out[name] == outs[0][name], name
            assert len(out[name]) == 1 and out[name][0] > 0, name
        assert "no mesh bound" in out["unbound"]


ROWS_TASK = """
from repro_torch.launch.mesh import make_replay_mesh
from repro_torch.train.loop import DataParallel
cfg = smoke(get("llama3.2-3b"))
RESULT = {}
for name, mesh in (("dp4", make_dp_mesh(4)),
                   ("pod2xdp2", make_replay_mesh({"pod": 2, "data": 2}))):
    dp = DataParallel(cfg, mesh)
    for b in (8, 6, 3):
        batch = {"tokens": np.arange(b * 3).reshape(b, 3),
                 "frames": np.arange(b * 4.0).reshape(b, 2, 2)}
        local, axes = dp.local_batch(batch)
        RESULT[name, b] = (local["tokens"], local["frames"], axes)
"""


def test_batch_rows_are_dealt_as_the_reference_deals_them(pool):
    """The reference's ``batch``-sharded ``device_put``: on dp 4 process r
    takes rows [2r, 2r + 2) of 8; on ``pod`` 2 × ``data`` 2, rows by
    ``pod`` major; a batch of 6 splits over ``pod`` alone there (4 does
    not divide it) and over nothing on dp 4, nor does a batch of 3 (every
    process takes it whole); every array of the batch the same rows."""
    outs = pool.run(POOL_HELPERS + ROWS_TASK)
    for r, out in enumerate(outs):
        for name in ("dp4", "pod2xdp2"):
            tokens, frames, axes = out[name, 8]
            assert axes == (("data",) if name == "dp4" else ("pod", "data"))
            assert tokens.tolist() == np.arange(24).reshape(8, 3)[
                2 * r:2 * r + 2].tolist()
            assert torch.equal(frames, torch.arange(32.0, dtype=torch.float64)
                               .reshape(8, 2, 2)[2 * r:2 * r + 2])
        tokens, _, axes = out["pod2xdp2", 6]
        assert axes == ("pod",)
        assert tokens.tolist() == np.arange(18).reshape(6, 3)[
            3 * (r // 2):3 * (r // 2) + 3].tolist()
        for name, b in (("dp4", 6), ("dp4", 3), ("pod2xdp2", 3)):
            tokens, _, axes = out[name, b]
            assert axes == () and tokens.tolist() == \
                np.arange(3 * b).reshape(b, 3).tolist()
