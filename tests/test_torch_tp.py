"""The port's tensor-parallel and FSDP execution against the JAX reference.

Four gloo processes (one pool a module, ``test_torch_mesh.py``'s
``GlooPool``) against the reference on a forced 4-device CPU mesh (one
subprocess a module, started beside the pool), for the smoke configs of
Llama 3.2 3B (GQA: 4 q and 2 kv heads), Gemma 3 4B (sliding windows, ring
decode caches, ``qk_norm``), Qwen3-32B (its ``("embed", "data")`` FSDP
override, ``qk_norm``) and Mamba2 2.7B (in_proj's columns re-dealt), on a
``data 2 × model 2`` and a ``data 1 × model 4`` mesh (on the latter
Llama's kv heads do not divide the model axis: the rules replicate K/V):

* serve: prefill's logits, each process's vocab block within 1e-4 of the
  largest of the reference's, and ``ServeEngine(mesh=)``'s greedy tokens
  over 8 decode steps equal to the reference engine's on the mesh; Llama's
  prefill at 1024 tokens (flash on the local heads) against the port's
  own on one process;
* train: 3 ``Trainer`` steps from the reference's weights, the loss within
  1e-5 relative, each process's block within 1e-4 of the largest value of
  the reference's global leaf (sliced to the block), the norm of each
  step's reduced gradient within 1e-4 relative;
* ``reshard`` dp 4 -> 2 × 2 -> ``None`` against the reference's sequence,
  and crash/resume on 2 × 2 bit for bit, its checkpoint restored on dp 4,
  without a mesh and by the reference.

In process: ``cache_specs`` and ``input_specs`` equal to the reference's
for every config and run shape on ``data`` 4, 2 × 2 and 2 × 2 × 2 meshes
(the reference's own functions, with a stand-in for the device placement:
the rules read only axis names and sizes).

Parity levels (the train level of ``test_torch_dp_train.py``): f32 sums
in other orders (gloo's rings, the vocab-split log-sum-exp, the row-split
products) against XLA's.
"""
from __future__ import annotations

import concurrent.futures
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get, smoke
from repro_torch.configs.registry import ARCH_IDS, param_specs, rules_for
from repro_torch.models.layers import tree_leaves
from repro_torch.sharding import partition as PP
from test_torch_harness import one_thread, run_reference
from test_torch_mesh import GlooPool

pytestmark = pytest.mark.usefixtures("one_thread")

#: the train level
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-4
#: the serve level
LOGIT_RTOL = 1e-4

CONFIGS = {"llama": "llama3.2-3b", "gemma": "gemma3-4b",
           "qwen": "qwen3-32b", "mamba": "mamba2-2.7b"}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: 4 rows of 16 tokens (2 rows a data position); 8 new tokens in a
#: 32-position engine (Gemma's windows of 16 wrap)
BATCH, SEQ, NEW, MAX_LEN = 4, 16, 8, 32
STEPS = 3
#: Llama's prefill through flash: 2 rows of 1024 tokens
FLASH_SEQ = 1024


def _inputs(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"prompts": rng.randint(0, 512, (BATCH, SEQ)).astype(np.int32),
            "long": rng.randint(0, 512, (2, FLASH_SEQ)).astype(np.int32)}


REFERENCE_CODE = """
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get, smoke
from repro.configs.registry import rules_for
from repro.launch.mesh import make_dp_mesh, make_test_mesh
from repro.models.model import init_params, logical_axes_tree
from repro.serve.engine import ServeEngine
from repro.sharding.partition import sharding_for_shape
from repro.train.loop import Trainer

assert jax.device_count() == 4
inputs = np.load(OUT / "inputs.npz.in")

def place(params, cfg, mesh):
    rules = rules_for(cfg)
    return jax.tree.map(
        lambda a, ax: jax.device_put(
            a, sharding_for_shape(a.shape, ax, mesh, rules)),
        params, logical_axes_tree(cfg),
        is_leaf=lambda x: hasattr(x, "shape") and not isinstance(x, tuple))

def spy(t, norms):
    inner = t.step_fn
    def step(p, o, b):
        p, o, m = inner(p, o, b)
        norms.append(float(m["grad_norm"]))
        return p, o, m
    t.step_fn = step

meta = {}
for tag, arch in CONFIGS.items():
    cfg = smoke(get(arch))
    d, m = MESHES[MESH]
    mesh = make_test_mesh(d, m)
    p = place(init_params(cfg, 0), cfg, mesh)
    eng = ServeEngine(cfg, p, mesh, max_len=MAX_LEN)
    # prefill's logits from the engine's own jitted prefill
    out = {"logits": eng._prefill(p, {"tokens": jnp.asarray(
        inputs["prompts"])})[0]}
    out["tokens"] = eng.generate(inputs["prompts"], NEW).tokens
    t = Trainer(cfg, mesh, global_batch=BATCH, seq_len=SEQ,
                ckpt_dir=str(OUT / f"ck_{tag}"))
    norms = []
    spy(t, norms)
    meta[tag] = {"losses": [r["loss"] for r in t.run(STEPS)], "norms": norms}
    for i, a in enumerate(jax.tree.leaves(t.params)):
        out[f"p{i}"] = np.asarray(a)
    save_arrays(OUT / f"run_{tag}.npz", out)

if RESHARD:     # dp 4 -> 2 x 2 -> None
    cfg = smoke(get("llama3.2-3b"))
    t = Trainer(cfg, make_dp_mesh(4), global_batch=BATCH, seq_len=SEQ,
                ckpt_dir=str(OUT / "ck_reshard"))
    norms = meta["reshard_norms"] = []
    spy(t, norms)
    t.run(2, ckpt_every=1)
    t.reshard(make_test_mesh(2, 2))
    spy(t, norms)
    t.run(2)
    t.reshard(None)
    spy(t, norms)
    t.run(2)
    meta["reshard"] = [r["loss"] for r in t.metrics_log]
(OUT / "meta.json").write_text(json.dumps(meta))
"""


@pytest.fixture(scope="module")
def init_weights(tmp_path_factory):
    """The reference's initial weights of each config (its ``init_params``
    in process: numpy draws), as ``init_<tag>.npz`` of leaves in order."""
    import jax
    from repro.configs import get as jget, smoke as jsmoke
    from repro.models.model import init_params as jinit
    out = tmp_path_factory.mktemp("tp_init")
    for tag, arch in CONFIGS.items():
        leaves = jax.tree.leaves(jinit(jsmoke(jget(arch)), 0))
        np.savez(out / f"init_{tag}.npz",
                 **{str(i): np.asarray(a) for i, a in enumerate(leaves)})
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs, one subprocess a mesh (the 2 × 2 one with the
    reshard), started in the background beside the pool."""
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ex = concurrent.futures.ThreadPoolExecutor(len(MESHES))
    futs = {}
    for mname in MESHES:
        out = tmp_path_factory.mktemp(f"ref_tp_{mname}")
        with open(out / "inputs.npz.in", "wb") as f:   # not read back
            np.savez(f, **_inputs())
        code = (f"CONFIGS = {CONFIGS!r}\nMESHES = {MESHES!r}\n"
                f"MESH, RESHARD = {mname!r}, {mname == '2x2'}\n"
                f"BATCH, SEQ, NEW, MAX_LEN, STEPS = {BATCH}, {SEQ}, {NEW}, "
                f"{MAX_LEN}, {STEPS}\n" + REFERENCE_CODE)
        futs[mname] = ex.submit(run_reference, code, out, 600, env)
    yield futs
    ex.shutdown(wait=True)


@pytest.fixture(scope="module")
def pool(tmp_path_factory, reference):
    p = GlooPool(tmp_path_factory.mktemp("gloo_tp"))
    p.run(f"MESHES = {MESHES!r}\n" + POOL_SETUP)
    yield p
    p.close()


#: run once a pool: every process builds the meshes, in the same order
POOL_SETUP = """
import numpy as np, torch
from repro_torch.configs import get, smoke
from repro_torch.configs.registry import rules_for
from repro_torch.launch.mesh import make_dp_mesh, make_test_mesh
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import (
    build_forward, init_params, logical_axes_tree, params_from_numpy,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding.partition import (
    constraint, gather_full, local_shard, shard_params, sharding_for_shape,
)
from repro_torch.train.loop import Trainer, _InjectedFailure
from repro_torch.train.optimizer import adamw_init
meshes = {name: make_test_mesh(d, m) for name, (d, m) in MESHES.items()}
meshes["dp4"] = make_dp_mesh(4)

def whole_from(cfg, path):
    arrs = np.load(path)
    tmpl = init_params(cfg, 0, "cpu")
    idx = {id(t): i for i, t in enumerate(tree_leaves(tmpl))}
    return tree_map(lambda t: torch.from_numpy(np.array(arrs[str(idx[id(t)])]))
                    .to(t.dtype), tmpl)

def rows(x, mesh, cfg):
    spec = sharding_for_shape(x.shape, ("batch", "seq"), mesh, rules_for(cfg))
    return torch.from_numpy(np.ascontiguousarray(local_shard(x, spec, mesh)))

def spy(t, norms):
    inner = t.step_fn
    def step(p, o, b):
        p, o, m = inner(p, o, b)
        norms.append(float(m["grad_norm"]))
        return p, o, m
    t.step_fn = step

def leaves(tree):
    return [x.detach().clone() for x in tree_leaves(tree)]
"""

SERVE_TRAIN_TASK = """
inputs = np.load(INPUTS)
RESULT = {}
for tag, arch in CONFIGS.items():
    cfg = smoke(get(arch))
    whole = whole_from(cfg, f"{INIT}/init_{tag}.npz")
    for mname in MESHES:
        mesh = meshes[mname]
        params = params_from_numpy(tree_map(lambda t: t.numpy(), whole),
                                   mesh=mesh, cfg=cfg)
        prefill = build_forward(cfg, "prefill")
        with torch.inference_mode():
            logits = prefill(params, {"tokens": rows(inputs["prompts"], mesh,
                                                     cfg)}, cfg, mesh)[0]
            long = None
            if tag == "llama" and mname == "2x2":      # flash, local heads
                long = (prefill(params, {"tokens": rows(inputs["long"], mesh,
                                                        cfg)}, cfg, mesh)[0],
                        prefill(whole, {"tokens": torch.from_numpy(
                            inputs["long"])}, cfg)[0])
        eng = ServeEngine(cfg, params, mesh, max_len=MAX_LEN)
        tokens = eng.generate(inputs["prompts"], NEW).tokens
        t = Trainer(cfg, mesh, global_batch=BATCH, seq_len=SEQ,
                    ckpt_dir=f"{ROOT}/ck_{tag}_{mname}")
        t.params = shard_params(whole, logical_axes_tree(cfg), mesh,
                                rules_for(cfg))
        t.opt_state = adamw_init(t.params)
        norms = []
        spy(t, norms)
        losses = [m["loss"] for m in t.run(STEPS)]
        RESULT[tag, mname] = dict(
            logits=logits, long=long, tokens=tokens, losses=losses,
            norms=norms, params=leaves(t.params),
            sharded=t._dp.sharded)
"""


def _coord(mname: str, r: int) -> dict:
    d, m = MESHES[mname]
    return {"data": r // m, "model": r % m}


def _close(got, want, rtol: float, what: str) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= rtol * top, f"{what}: {err} > {rtol} * {top}"
    return err / top if top else 0.0


def _block(x, spec, mname: str, r: int):
    sizes = dict(zip(("data", "model"), MESHES[mname]))
    return PP.local_shard(x, spec, sizes, _coord(mname, r))


@pytest.fixture(scope="module")
def served(pool, reference, init_weights, tmp_path_factory):
    """The pool's serve and train runs (from the reference's weights, while
    the reference runs), and the reference's results by mesh."""
    inputs = tmp_path_factory.mktemp("tp_in") / "in.npz"
    np.savez(inputs, **_inputs())
    root = tmp_path_factory.mktemp("tp_ck")
    outs = pool.run(
        f"INIT = {str(init_weights)!r}\nROOT = {str(root)!r}\n"
        f"INPUTS = {str(inputs)!r}\nCONFIGS = {CONFIGS!r}\n"
        f"BATCH, SEQ, NEW, MAX_LEN, STEPS = {BATCH}, {SEQ}, {NEW}, "
        f"{MAX_LEN}, {STEPS}\n" + SERVE_TRAIN_TASK, timeout=300)
    return {m: f.result() for m, f in reference.items()}, outs


CASES = [(tag, m) for tag in CONFIGS for m in MESHES]


@pytest.mark.parametrize("tag,mname", CASES)
def test_serve_on_the_mesh_matches_the_references(served, tag, mname):
    """Prefill's logits (each process's block of (rows, vocab)) within 1e-4
    of the largest of the reference's on the same mesh, and the engine's
    greedy tokens over 8 decode steps equal to the reference engine's, on
    every process (each serves its rows and gathers the batch)."""
    refs, outs = served
    want = refs[mname][f"run_{tag}"]
    cfg = smoke(get(CONFIGS[tag]))
    sizes = dict(zip(("data", "model"), MESHES[mname]))
    spec = PP.sharding_for_shape((BATCH, cfg.padded_vocab),
                                 ("batch", "vocab"), sizes, rules_for(cfg))
    for r, out in enumerate(outs):
        got = out[tag, mname]
        assert got["sharded"]
        _close(got["logits"].numpy(), _block(want["logits"], spec, mname, r),
               LOGIT_RTOL, f"{tag} {mname} process {r} logits")
        np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                      err_msg=f"{tag} {mname} process {r}")
        if got["long"] is not None:
            lspec = PP.sharding_for_shape(
                (2, cfg.padded_vocab), ("batch", "vocab"), sizes,
                rules_for(cfg))
            block, whole = got["long"]
            _close(block.numpy(), _block(whole.numpy(), lspec, mname, r),
                   LOGIT_RTOL, f"{tag} {mname} process {r} flash logits")


@pytest.mark.parametrize("tag,mname", CASES)
def test_trainer_on_the_mesh_matches_the_references(served, tag, mname):
    """Three ``Trainer`` steps from the reference's weights: the losses at
    the train level on every process, the norm of each step's reduced
    gradient within 1e-4 relative, and each process's block of every leaf
    within 1e-4 of the largest value of the reference's trained leaf,
    sliced as the rules split it."""
    refs, outs = served
    meta = refs[mname]["meta"][tag]
    want = refs[mname][f"run_{tag}"]
    cfg = smoke(get(CONFIGS[tag]))
    sizes = dict(zip(("data", "model"), MESHES[mname]))
    specs = [m.spec for m in tree_leaves(param_specs(cfg, sizes))]
    assert any(not PP.is_replicated(s, sizes) for s in specs)
    for r, out in enumerate(outs):
        got = out[tag, mname]
        for a, b in zip(got["losses"], meta["losses"]):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (r, got["losses"],
                                                      meta["losses"])
        assert len(got["norms"]) == STEPS
        for a, b in zip(got["norms"], meta["norms"]):
            assert abs(a - b) <= GRAD_NORM_RTOL * b, (r, got["norms"],
                                                      meta["norms"])
        assert len(got["params"]) == len(specs)
        for j, (p, spec) in enumerate(zip(got["params"], specs)):
            w = want[f"p{j}"]
            blk = _block(w, spec, mname, r)
            assert tuple(p.shape) == blk.shape, (j, spec)
            top = float(np.abs(w).max())
            err = float(np.abs(p.numpy() - blk).max())
            assert err <= PARAM_RTOL * top, (tag, mname, r, j, err, top)


RESHARD_TASK = """
cfg = smoke(get("llama3.2-3b"))
t = Trainer(cfg, meshes["dp4"], global_batch=BATCH, seq_len=SEQ,
            ckpt_dir=f"{ROOT}/ck_reshard")
t.params = shard_params(whole_from(cfg, f"{INIT}/init_llama.npz"),
                        logical_axes_tree(cfg), meshes["dp4"], rules_for(cfg))
t.opt_state = adamw_init(t.params)
norms = []
spy(t, norms)
t.run(2, ckpt_every=1)
t.reshard(meshes["2x2"])
mid = (t.active, t.step, t._dp.sharded,
       [tuple(x.shape) for x in tree_leaves(t.params)])
spy(t, norms)
t.run(2)
t.reshard(None)
spy(t, norms)
t.run(2)
RESULT = ([m["loss"] for m in t.metrics_log], mid, t.active, t.step, norms)
"""


def test_reshard_dp4_tp_none_matches_the_references(pool, reference,
                                                    init_weights, tmp_path):
    """dp 4 (2 steps, a checkpoint each) -> 2 × 2 (2 steps, the weights
    split over ``model``) -> ``None`` (2 steps, process 0): the reference's
    six losses at the train level and the norms of its six reduced
    gradients within 1e-4 relative on process 0; at 2 × 2 every process
    holds its blocks."""
    outs = pool.run(f"INIT = {str(init_weights)!r}\n"
                    f"ROOT = {str(tmp_path)!r}\n"
                    f"BATCH, SEQ = {BATCH}, {SEQ}\n" + RESHARD_TASK)
    ref = reference["2x2"].result()
    want, want_gn = ref["meta"]["reshard"], ref["meta"]["reshard_norms"]
    assert len(want) == len(want_gn) == 6
    losses, mid, active, step, norms = outs[0]
    assert active and step == 6 and len(losses) == 6
    for a, b in zip(losses, want):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (losses, want)
    for a, b in zip(norms, want_gn):
        assert abs(a - b) <= GRAD_NORM_RTOL * b, (norms, want_gn)
    whole = [tuple(m.meta.shape) for m in tree_leaves(
        param_specs(smoke(get("llama3.2-3b")), {"data": 4}))]
    for r, out in enumerate(outs):
        assert out[1][:3] == (True, 2, True)
        assert out[1][3] != whole          # blocks, not whole leaves
        assert out[0][:4] == losses[:4]
        assert out[2] == (r == 0)


CRASH_TASK = """
cfg = smoke(get("gemma3-4b"))
kw = dict(global_batch=BATCH, seq_len=SEQ)
t1 = Trainer(cfg, meshes["2x2"], ckpt_dir=f"{ROOT}/a", **kw)
log1 = t1.run(4, ckpt_every=2)
t2 = Trainer(cfg, meshes["2x2"], ckpt_dir=f"{ROOT}/b", **kw)
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
whole = t1.step_fn.data_parallel.gather_state(
    {"params": t1.params, "opt": t1.opt_state})
# the 2 x 2 checkpoint on dp 4 (whole leaves on every process)
t3 = Trainer(cfg, meshes["dp4"], ckpt_dir=f"{ROOT}/a", **kw)
t3.restore()
RESULT = dict(crashed=crashed, same=same,
              log=([(m["step"], m["loss"]) for m in log1],
                   [(m["step"], m["loss"]) for m in log2]),
              whole=leaves(whole["params"]), step3=t3.step,
              dp4=leaves(t3.params))
"""


def test_crash_resume_and_checkpoints_across_layouts(pool, tmp_path):
    """On 2 × 2 (the Gemma smoke: windows, ``qk_norm``), a failure at step 3
    of 4 (checkpoints every 2) replays to the uninterrupted run bit for bit
    on every process; the checkpoint it writes (whole leaves, gathered)
    restores on dp 4, in the single-device trainer and in the reference
    (its f32 files) to the gathered weights bit for bit."""
    from repro_torch.train.loop import Trainer
    outs = pool.run(f"ROOT = {str(tmp_path)!r}\nBATCH, SEQ = {BATCH}, "
                    f"{SEQ}\n" + CRASH_TASK)
    for out in outs:
        assert out["crashed"] == [3] and out["same"]
        l1, l2 = out["log"]
        assert len(l2) > len(l1) and dict(l1) == dict(l2)
        assert out["step3"] == 4
    whole = outs[0]["whole"]
    n = len(tree_leaves(param_specs(smoke(get("gemma3-4b")), {"data": 4})))
    assert len(whole) == n
    for out in outs:
        assert len(out["dp4"]) == n
        for a, b in zip(out["dp4"], whole):
            assert torch.equal(a, b)
    cfg = smoke(get("gemma3-4b"))
    back = Trainer(cfg, None, global_batch=BATCH, seq_len=SEQ,
                   ckpt_dir=tmp_path / "a", device="cpu")
    assert back.restore() and back.step == 4
    for a, b in zip(tree_leaves(back.params), whole):
        assert torch.equal(a, b)
    got = run_reference(f"""
        import jax, numpy as np
        from repro.configs import get, smoke
        from repro.models.model import init_params
        from repro.train.checkpoint import CheckpointManager
        cfg = smoke(get("gemma3-4b"))
        tmpl = {{"params": init_params(cfg, 0)}}
        step, state, _ = CheckpointManager({str(tmp_path / 'a')!r}).restore(
            tmpl)
        save_arrays(OUT / "restored.npz", {{str(i): np.asarray(a) for i, a in
            enumerate(jax.tree.leaves(state["params"]))}})
    """, tmp_path / "ref_restore")
    assert len(got["restored"]) == n
    for i, b in enumerate(whole):
        np.testing.assert_array_equal(got["restored"][str(i)], b.numpy())


CONSTRAINT_TASK = """
x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
mesh = meshes["2x2"]
y = constraint(x, ("batch", "seq", "heads"), mesh)
z = constraint(x, ("batch", "seq", "embed"), meshes["dp4"])
w = constraint(x, ("embed", "seq", "embed"), mesh)
back = gather_full(y.contiguous(), sharding_for_shape(
    tuple(x.shape), ("batch", "seq", "heads"), mesh), mesh)
cfg = smoke(get("qwen3-32b"))
blocks = init_params(cfg, 0, "cpu", mesh=mesh)
cut = shard_params(init_params(cfg, 0, "cpu"), logical_axes_tree(cfg), mesh,
                   rules_for(cfg))
same = all(torch.equal(a, b) for a, b in zip(tree_leaves(blocks),
                                             tree_leaves(cut)))
# greedy argmax over 4 vocab blocks of 128: ties go to the lowest index
llama = smoke(get("llama3.2-3b"))
m4 = meshes["1x4"]
eng = ServeEngine(llama, init_params(llama, 0, "cpu", mesh=m4), m4)
logits = torch.zeros(2, 128)
logits[0, 5] = 1.0                      # every block: global 5, 133, ...
if rank >= 2:
    logits[1, 7 if rank == 2 else 0] = 2.0  # global 263 and 384
RESULT = (y, z, w is x, back, same,
          sum(a.numel() for a in tree_leaves(blocks)),
          eng._argmax(logits).tolist())
"""


def test_constraint_executes_a_spec_on_the_mesh(pool):
    """``constraint`` on a tensor every process holds whole returns its
    block (batch rows by ``data``, heads by ``model``, as the reference's
    ``NamedSharding`` places them), the identity where the spec
    replicates; ``gather_full`` puts the blocks back;
    ``init_params(mesh=)`` gives each process the blocks of the
    single-device tree bit for bit (Qwen3-32B: split over both axes); the
    engine's greedy token over vocab blocks takes ``jnp.argmax``'s lowest
    index among equal maxima, within a block and across blocks."""
    outs = pool.run(CONSTRAINT_TASK)
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    whole = sum(m.meta.numel() for m in tree_leaves(
        param_specs(smoke(get("qwen3-32b")), {"data": 2})))
    for r, (y, z, same, back, same_init, n, tokens) in enumerate(outs):
        d, m = r // 2, r % 2
        assert torch.equal(y, x[2 * d:2 * d + 2, :, 3 * m:3 * m + 3])
        assert torch.equal(z, x[r:r + 1])
        assert same and torch.equal(back, x)
        assert same_init and n < whole / 2
        assert tokens == [5, 263]


# ---------------------------------------------------------------------------
# cache_specs and input_specs, in process
# ---------------------------------------------------------------------------

SPEC_MESHES = {"dp4": {"data": 4}, "dp2xtp2": {"data": 2, "model": 2},
               "pod2xdp2xtp2": {"pod": 2, "data": 2, "model": 2}}


class _SDS:
    """The reference's ``ShapeDtypeStruct`` with its sharding as a plain
    spec (what the rules give, without devices)."""

    def __init__(self, shape, dtype, sharding=None):
        self.shape, self.dtype, self.sharding = tuple(shape), dtype, sharding


def _reference_specs(monkeypatch):
    """The reference's ``input_specs`` with a stand-in mesh: its registry
    and optimizer build ``_SDS`` leaves whose sharding is the filtered
    spec."""
    import jax
    from repro.configs import registry as JR
    from repro.sharding import partition as JP
    from repro.train import optimizer as JO
    fake = types.SimpleNamespace(ShapeDtypeStruct=_SDS, tree=jax.tree)
    monkeypatch.setattr(JR, "jax", fake)
    monkeypatch.setattr(JO, "jax", fake)
    monkeypatch.setattr(
        JR, "sharding_for_shape",
        lambda shape, axes, mesh, rules=None: JP._filter_divisible(
            JP.spec_for(axes, mesh, rules), tuple(shape), mesh))
    return JR


def _jmesh(sizes: dict):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _plain(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in tuple(spec))


def _jleaves(tree) -> list:
    import jax
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, _SDS))


def _same(got, want, what):
    import jax.numpy as jnp
    gl, wl = tree_leaves(got), _jleaves(want)
    assert len(gl) == len(wl), what
    for g, w in zip(gl, wl):
        assert tuple(g.meta.shape) == w.shape, what
        assert str(g.meta.dtype).replace("torch.", "") == \
            jnp.dtype(w.dtype).name, what
        assert _plain(g.spec) == _plain(w.sharding or ()), (what, g.spec,
                                                             w.sharding)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_equal_the_references(arch, monkeypatch):
    """Every config at every run shape on ``data`` 4, 2 × 2 and 2 × 2 × 2:
    ``input_specs``' argument tuple (params, the optimizer state, the batch;
    the decode cache and position) and ``cache_specs`` equal to the
    reference's, leaf for leaf: shape, dtype and spec."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import SHAPES
    JR = _reference_specs(monkeypatch)
    for shape in sorted(SHAPES):
        for name, sizes in SPEC_MESHES.items():
            cfg, args = R.input_specs(arch, shape, sizes)
            jcfg, jargs = JR.input_specs(arch, shape, _jmesh(sizes))
            assert cfg.name == jcfg.name and len(args) == len(jargs)
            for i, (a, b) in enumerate(zip(args, jargs)):
                _same(a, b, (arch, shape, name, i))
            if SHAPES[shape].kind == "decode":
                _same(R.cache_specs(cfg, SHAPES[shape], sizes),
                      JR.cache_specs(jcfg, JSHAPES[shape], _jmesh(sizes)),
                      (arch, shape, name, "cache"))
    _, nopt = R.input_specs(arch, "train_4k", {"data": 4}, with_opt=False)
    assert len(nopt) == 2


def test_attention_modes_and_what_raises_in_process():
    """``attn_mode``, ``tp_size`` and ``head_sharded`` equal the reference's
    on stand-in meshes; nothing raises any more: the ``"batch"`` and
    ``"cp"`` modes execute (6 heads on a model axis of 4), and so do heads
    whose flat projection columns do not split over the axis (3 heads of
    18 on 4: whole weights) and GQA groups that do not line up with a
    process's heads (24 q and 8 kv heads on a model axis of 3, Llama 3.2
    3B's own: each local q head's kv head by an index map, the reference's
    GQA map ``q head // (q heads / kv heads)``); a mesh whose rules split
    nothing runs whole (None).  ``tests/test_torch_tp_families.py`` holds
    them on four processes to the reference."""
    import dataclasses
    from repro.models import attention as JA
    from repro.models import flash as JF
    from repro_torch.models import attention as A
    from repro_torch.models import flash as F
    from repro_torch.sharding import spmd
    for sizes in ({"data": 4}, {"data": 2, "model": 2}, {"model": 8},
                  {"pod": 2, "data": 2, "model": 2}, {"data": 1, "model": 3}):
        jm = _jmesh(sizes)
        for h in (1, 4, 6, 8, 24):
            assert A.tp_size(sizes) == JA.tp_size(jm)
            assert A.head_sharded(sizes, h) == JA.head_sharded(jm, h)
            for b in (1, 2, 8):
                assert F.attn_mode(sizes, h, b) == JF.attn_mode(jm, h, b)
    llama = smoke(get("llama3.2-3b"))
    six = dataclasses.replace(llama, n_heads=6)
    odd = dataclasses.replace(llama, n_heads=3, n_kv_heads=1, head_dim=18)
    gqa = dataclasses.replace(llama, n_heads=24, n_kv_heads=8)
    for cfg, sizes in ((six, {"data": 1, "model": 4}),
                       (odd, {"data": 1, "model": 4}),
                       (gqa, {"data": 1, "model": 3}),
                       (get("llama3.2-3b"), {"data": 1, "model": 3}),
                       (llama, {"data": 1, "model": 4})):
        assert spmd.check_supported(cfg, sizes, rules_for(cfg)) is True
    assert spmd.check_supported(llama, {"data": 4}, rules_for(llama)) is False
    assert spmd.kv_groups(4, 2, 4, 3) == (1, 2, None)
    assert spmd.kv_groups(24, 8, 2, 1) == (4, 8, None)
    for r in range(3):
        lo, hi, idx = spmd.kv_groups(24, 8, 3, r)
        assert [lo + i for i in idx] == [(8 * r + i) // 3 for i in range(8)]
    assert [spmd.span(10, 4, r) for r in range(4)] == [(0, 3), (3, 6),
                                                       (6, 8), (8, 10)]
