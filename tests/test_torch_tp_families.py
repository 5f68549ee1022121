"""The rest of the port's sharded execution against the JAX reference:
attention's ``"batch"`` and ``"cp"`` modes, the encoder-decoder and the
VLM's cross-attention, and MoE (experts on ``model``, Mixtral's
``expert_ffn``, routing per data shard).

Four gloo processes (one pool a module, ``test_torch_mesh.py``'s
``GlooPool``) against the reference on a forced 4-device CPU mesh (one
subprocess a config, started beside the pool, three at a time), for the
smoke Whisper large-v3 (encoder, decoder, cross K/V caches), Llama 3.2
Vision 90B (``s``/``x`` layers, the vision states; its ``("embed",
"data")`` FSDP override), DeepSeek-MoE 16B (experts on ``model``, shared
experts), Mixtral 8x22B (each expert's FFN on ``model``) and Jamba v0.1
(MoE every other layer beside Mamba2 and attention) on ``data 2 × model
2`` and ``data 1 × model 4``, DeepSeek-MoE on ``data 4`` (each process's
rows routed as a data shard, the aux loss's means all-reduced), a 6-head
Llama variant on ``1 × 4`` (6 heads on a model axis of 4: batch 4 runs the
``"batch"`` mode, batch 2 the ``"cp"`` mode; at 16 tokens and at 1024,
where ``cp`` goes through flash with a query offset), and 6-head variants
of the smoke Whisper in ``"batch"`` mode (its encoder, decoder and
cross-attention) and of the smoke VLM in ``"cp"`` mode with 6 vision
tokens (a cross cache the model axis does not divide, whole on each
process):

* serve: prefill's logits (random vision or audio inputs), each process's
  vocab block within 1e-4 of the largest of the reference's, and
  ``ServeEngine(mesh=)``'s greedy tokens over 8 decode steps equal to the
  reference engine's on the mesh;
* train: 3 ``Trainer`` steps from the reference's weights, the loss within
  1e-5 relative, each process's block within 1e-4 of the largest value of
  the reference's global leaf, the norm of each step's reduced gradient
  within 1e-4 relative.  As in ``test_torch_train.py::
  test_train_step_matches_reference``, an element whose clipped gradient
  at the first step is rounding noise (below 1e-6, 100 times AdamW's eps)
  moves by AdamW's normalized step whatever its size, so it is held within
  2 learning rates of each step taken: Jamba's 8 layers put the noise
  floor of its clipped gradients (f32 sums in other orders) near 2e-8,
  above eps, and a zero-initialized bias leaf is nothing but such steps.

Beside them: the aux loss's gradient on ``data 4`` (its means all-reduced
both ways, so the data-parallel mean gives the reference's gradient), the
flash plain versions with ``q_offset`` against rows of the reference's
``flash_attention`` of the whole sequence (forward and gradients, causal
and windowed), and ``spmd.check_supported`` over the registry on the
production meshes.  Parity levels: those of ``test_torch_tp.py``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get, smoke
from repro_torch.configs.registry import ARCH_IDS, param_specs, rules_for
from repro_torch.models.layers import tree_leaves
from repro_torch.sharding import partition as PP
from test_torch_harness import run_reference
from test_torch_mesh import GlooPool

#: the train level
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-4
#: ``test_torch_train.py``'s rule for a weight whose clipped gradient is
#: rounding noise: below FIRM_GRAD, within NOISE_LRS learning rates a step
FIRM_GRAD = 1e-6
NOISE_LRS = 2.0
#: the serve level
LOGIT_RTOL = 1e-4
#: ``tests/test_kernels.py``'s f32 flash tolerance
FLASH_ATOL = 2e-5

FAMILIES = {"whisper": "whisper-large-v3", "vlm": "llama-3.2-vision-90b",
            "deepseek": "deepseek-moe-16b", "mixtral": "mixtral-8x22b",
            "jamba": "jamba-v0.1-52b"}
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "dp4": (4, 1)}
#: (config tag, mesh, batch, tokens) of every case
CASES = ([(tag, m, 4, 16) for tag in FAMILIES for m in ("2x2", "1x4")]
         + [("deepseek", "dp4", 4, 16)]
         + [("llama6", "1x4", b, s) for s in (16, 1024) for b in (4, 2)]
         + [("whisper6", "1x4", 4, 16), ("vlm6", "1x4", 2, 16)])
#: the variants' (config, changes): 6 heads (1.5 a process on a model
#: axis of 4: 96 flat q columns), the VLM's vision tokens 6
VARIANTS = {"llama6": ("llama3.2-3b", {}), "whisper6": (FAMILIES["whisper"],
                                                        {}),
            "vlm6": (FAMILIES["vlm"], {"n_vision_tokens": 6})}
NEW, STEPS = 8, 3
#: one reference subprocess a config, this many at once
REFERENCE_WORKERS = 3


def _cfg(tag: str):
    if tag not in VARIANTS:
        return smoke(get(FAMILIES[tag]))
    arch, extra = VARIANTS[tag]
    c = smoke(get(arch))
    return dataclasses.replace(c, n_heads=6, n_kv_heads=2,
                               name=c.name + "-6h", **extra)


def _key(tag, mname, b, s) -> str:
    return f"{tag}_{mname}_{b}x{s}"


def _inputs(tag: str, b: int, s: int) -> dict:
    """The prompts and (random) modality inputs of a case."""
    cfg = _cfg(tag)
    rng = np.random.RandomState(b * 1000 + s)
    out = {"tokens": rng.randint(0, 512, (b, s)).astype(np.int32)}
    if cfg.n_vision_tokens:
        out["vision_embeds"] = rng.normal(
            0, 1, (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.n_audio_frames:
        out["audio_frames"] = rng.normal(
            0, 1, (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


REFERENCE_CODE = """
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get, smoke
from repro.configs.registry import rules_for
from repro.launch.mesh import make_test_mesh
from repro.models.model import init_params, logical_axes_tree
from repro.serve.engine import ServeEngine
from repro.sharding.partition import sharding_for_shape
from repro.train.loop import Trainer

assert jax.device_count() == 4

def config(tag):
    if tag not in VARIANTS:
        return smoke(get(FAMILIES[tag]))
    arch, extra = VARIANTS[tag]
    c = smoke(get(arch))
    return dataclasses.replace(c, n_heads=6, n_kv_heads=2,
                               name=c.name + "-6h", **extra)

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
for tag, mname, b, s in CASES:
    key = f"{tag}_{mname}_{b}x{s}"
    cfg = config(tag)
    d, m = MESHES[mname]
    mesh = make_test_mesh(d, m)
    p = place(init_params(cfg, 0), cfg, mesh)
    inputs = dict(np.load(OUT / f"inputs_{key}.npz.in"))
    eng = ServeEngine(cfg, p, mesh, max_len=s + NEW)
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    out = {"logits": eng._prefill(p, batch)[0]}
    out["tokens"] = eng.generate(inputs["tokens"], NEW).tokens
    t = Trainer(cfg, mesh, global_batch=b, seq_len=s,
                ckpt_dir=str(OUT / f"ck_{key}"))
    norms = []
    spy(t, norms)
    meta[key] = {"losses": [r["loss"] for r in t.run(STEPS)],
                 "norms": norms}
    for i, a in enumerate(jax.tree.leaves(t.params)):
        out[f"p{i}"] = np.asarray(a)
    save_arrays(OUT / f"run_{key}.npz", out)
(OUT / "meta.json").write_text(json.dumps(meta))
"""


def _by_config() -> dict:
    """The cases by config, Jamba's first: its reference compiles longest
    (about 100 s of the subprocesses' 250), so it starts at once."""
    out: dict = {"jamba": []}
    for case in CASES:
        out.setdefault(case[0], []).append(case)
    return out


@pytest.fixture(scope="module")
def init_weights(tmp_path_factory):
    """The reference's initial weights of each config (its ``init_params``
    in process: numpy draws), as ``init_<tag>.npz`` of leaves in order."""
    import jax
    from repro.configs import get as jget, smoke as jsmoke
    from repro.models.model import init_params as jinit
    out = tmp_path_factory.mktemp("tpf_init")
    for tag in _by_config():
        if tag in VARIANTS:
            arch, extra = VARIANTS[tag]
            cfg = dataclasses.replace(jsmoke(jget(arch)), n_heads=6,
                                      n_kv_heads=2, **extra)
        else:
            cfg = jsmoke(jget(FAMILIES[tag]))
        leaves = jax.tree.leaves(jinit(cfg, 0))
        np.savez(out / f"init_{tag}.npz",
                 **{str(i): np.asarray(a) for i, a in enumerate(leaves)})
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs, one subprocess a config, started in the
    background beside the pool."""
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ex = concurrent.futures.ThreadPoolExecutor(REFERENCE_WORKERS)
    futs = {}
    for tag, cases in _by_config().items():
        out = tmp_path_factory.mktemp(f"ref_tpf_{tag}")
        for t, mname, b, s in cases:
            with open(out / f"inputs_{_key(t, mname, b, s)}.npz.in",
                      "wb") as f:                      # not read back
                np.savez(f, **_inputs(t, b, s))
        code = (f"FAMILIES = {FAMILIES!r}\nMESHES = {MESHES!r}\n"
                f"VARIANTS = {VARIANTS!r}\n"
                f"CASES = {cases!r}\nNEW, STEPS = {NEW}, {STEPS}\n"
                + REFERENCE_CODE)
        futs[tag] = ex.submit(run_reference, code, out, 900, env)
    yield futs
    ex.shutdown(wait=True)


POOL_SETUP = """
import dataclasses
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
    local_shard, shard_params, sharding_for_shape,
)
import repro_torch.train.loop as loop_mod
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adamw_init
meshes = {"2x2": make_test_mesh(2, 2), "1x4": make_test_mesh(1, 4),
          "dp4": make_dp_mesh(4)}

def config(tag):
    if tag not in VARIANTS:
        return smoke(get(FAMILIES[tag]))
    arch, extra = VARIANTS[tag]
    c = smoke(get(arch))
    return dataclasses.replace(c, n_heads=6, n_kv_heads=2,
                               name=c.name + "-6h", **extra)

def whole_from(cfg, path):
    arrs = np.load(path)
    tmpl = init_params(cfg, 0, "cpu")
    idx = {id(t): i for i, t in enumerate(tree_leaves(tmpl))}
    return tree_map(lambda t: torch.from_numpy(np.array(arrs[str(idx[id(t)])]))
                    .to(t.dtype), tmpl)

def rows(x, mesh, cfg):
    spec = sharding_for_shape(x.shape, ("batch",) + (None,) * (x.ndim - 1),
                              mesh, rules_for(cfg))
    return torch.from_numpy(np.ascontiguousarray(local_shard(x, spec, mesh)))

def spy(t, norms):
    inner = t.step_fn
    def step(p, o, b):
        p, o, m = inner(p, o, b)
        norms.append(float(m["grad_norm"]))
        return p, o, m
    t.step_fn = step
"""

SERVE_TRAIN_TASK = """
RESULT = {}
for tag, mname, b, s in CASES:
    key = f"{tag}_{mname}_{b}x{s}"
    cfg, mesh = config(tag), meshes[mname]
    whole = whole_from(cfg, f"{INIT}/init_{tag}.npz")
    inputs = dict(np.load(f"{INPUTS}/{key}.npz"))
    params = shard_params(whole, logical_axes_tree(cfg), mesh, rules_for(cfg))
    with torch.inference_mode():
        logits = build_forward(cfg, "prefill")(
            params, {k: rows(v, mesh, cfg) for k, v in inputs.items()}, cfg,
            mesh)[0]
    eng = ServeEngine(cfg, params, mesh, max_len=s + NEW)
    tokens = eng.generate(inputs["tokens"], NEW).tokens
    t = Trainer(cfg, mesh, global_batch=b, seq_len=s,
                ckpt_dir=f"{ROOT}/ck_{key}")
    t.params = params
    t.opt_state = adamw_init(t.params)
    norms, steps = [], []
    spy(t, norms)
    real = loop_mod.adamw_update

    def record(grads, *a, **k):
        out = real(grads, *a, **k)
        if not steps:       # the first step's gradient, clipped
            clip = min(1.0, 1.0 / float(out[2]["grad_norm"]))
            first = [g.detach().abs() * clip for g in tree_leaves(grads)]
        else:
            first = None
        steps.append((float(out[2]["lr"]), first))
        return out

    loop_mod.adamw_update = record
    try:
        losses = [m["loss"] for m in t.run(STEPS)]
    finally:
        loop_mod.adamw_update = real
    RESULT[key] = dict(logits=logits, tokens=tokens, losses=losses,
                       norms=norms, sharded=t._dp.sharded,
                       lrs=[x[0] for x in steps], g0=steps[0][1],
                       params=[x.detach().clone()
                               for x in tree_leaves(t.params)])
"""


@pytest.fixture(scope="module")
def pool(tmp_path_factory, reference):
    p = GlooPool(tmp_path_factory.mktemp("gloo_tpf"))
    p.run(f"FAMILIES = {FAMILIES!r}\nVARIANTS = {VARIANTS!r}\n"
          + POOL_SETUP)
    yield p
    p.close()


@pytest.fixture(scope="module")
def served(pool, reference, init_weights, tmp_path_factory):
    """The pool's serve and train runs of every case (from the reference's
    weights, while the reference runs), and the reference's results by
    config."""
    inputs = tmp_path_factory.mktemp("tpf_in")
    for tag, mname, b, s in CASES:
        np.savez(inputs / f"{_key(tag, mname, b, s)}.npz",
                 **_inputs(tag, b, s))
    root = tmp_path_factory.mktemp("tpf_ck")
    outs = pool.run(
        f"INIT = {str(init_weights)!r}\nROOT = {str(root)!r}\n"
        f"INPUTS = {str(inputs)!r}\nCASES = {CASES!r}\n"
        f"NEW, STEPS = {NEW}, {STEPS}\n" + SERVE_TRAIN_TASK, timeout=600)
    return {tag: f.result() for tag, f in reference.items()}, outs


def _sizes(mname: str) -> dict:
    d, m = MESHES[mname]
    return {"data": d, "model": m}


def _coord(mname: str, r: int) -> dict:
    d, m = MESHES[mname]
    return {"data": r // m, "model": r % m}


def _block(x, spec, mname: str, r: int):
    return PP.local_shard(x, spec, _sizes(mname), _coord(mname, r))


def _close(got, want, rtol: float, what: str) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = float(np.abs(want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * top, f"{what}: {err} > {rtol} * {top}"


IDS = [_key(*c) for c in CASES]


@pytest.mark.parametrize("tag,mname,b,s", CASES, ids=IDS)
def test_serve_on_the_mesh_matches_the_reference(served, tag, mname, b, s):
    """Prefill's logits (each process's block of (rows, vocab)) within 1e-4
    of the largest of the reference's on the same mesh, and the engine's
    greedy tokens over 8 decode steps equal to the reference engine's, on
    every process."""
    refs, outs = served
    key = _key(tag, mname, b, s)
    want = refs[tag][f"run_{key}"]
    cfg = _cfg(tag)
    spec = PP.sharding_for_shape((b, cfg.padded_vocab), ("batch", "vocab"),
                                 _sizes(mname), rules_for(cfg))
    for r, out in enumerate(outs):
        got = out[key]
        assert got["sharded"]
        _close(got["logits"].numpy(), _block(want["logits"], spec, mname, r),
               LOGIT_RTOL, f"{key} process {r} logits")
        np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                      err_msg=f"{key} process {r}")


@pytest.mark.parametrize("tag,mname,b,s", CASES, ids=IDS)
def test_trainer_on_the_mesh_matches_the_reference(served, tag, mname, b, s):
    """Three ``Trainer`` steps from the reference's weights: the losses at
    the train level on every process, the norm of each step's reduced
    gradient within 1e-4 relative, and each process's block of every leaf
    within 1e-4 of the largest value of the reference's trained leaf,
    sliced as the rules split it (an element whose clipped first-step
    gradient is rounding noise within 2 learning rates a step: module
    docstring)."""
    refs, outs = served
    key = _key(tag, mname, b, s)
    meta = refs[tag]["meta"][key]
    want = refs[tag][f"run_{key}"]
    cfg = _cfg(tag)
    specs = [m.spec for m in tree_leaves(param_specs(cfg, _sizes(mname)))]
    for r, out in enumerate(outs):
        got = out[key]
        assert len(got["losses"]) == len(got["norms"]) == STEPS
        for a, w in zip(got["losses"], meta["losses"]):
            assert abs(a - w) <= LOSS_RTOL * abs(w), (r, got["losses"],
                                                      meta["losses"])
        for a, w in zip(got["norms"], meta["norms"]):
            assert abs(a - w) <= GRAD_NORM_RTOL * w, (r, got["norms"],
                                                      meta["norms"])
        assert len(got["params"]) == len(specs) == len(got["g0"])
        noise = NOISE_LRS * sum(got["lrs"])
        for j, (p, spec) in enumerate(zip(got["params"], specs)):
            w = want[f"p{j}"]
            blk = _block(w, spec, mname, r)
            assert tuple(p.shape) == blk.shape, (j, spec)
            top = float(np.abs(w).max())
            err = np.abs(p.numpy() - blk)
            firm = got["g0"][j].numpy() >= FIRM_GRAD
            assert float(err[firm].max(initial=0.0)) <= PARAM_RTOL * top, \
                (key, r, j, float(err[firm].max()), top)
            assert float(err.max()) <= max(PARAM_RTOL * top, noise), \
                (key, r, j, float(err.max()), noise)


AUX_TASK = """
from repro_torch.models import moe as M
from repro_torch.sharding import spmd
cfg = dataclasses.replace(smoke(get("deepseek-moe-16b")), rules_overrides=())
mesh = meshes["dp4"]
ctx = spmd.context(mesh, cfg)
p = {k: v[0] for k, v in init_params(cfg, 0, "cpu")["unit"][0]["moe"].items()
     if k != "shared"}
x = torch.from_numpy(np.random.RandomState(5).normal(
    0, 1, (8, 6, cfg.d_model)).astype(np.float32))
RESULT = {}
for name, fn in (("reduce_partial", ctx.reduce_partial), ("reduce",
                                                          ctx.reduce)):
    ctx.reduce_partial = fn
    try:
        router = p["router"].clone().requires_grad_(True)
        _, aux = M.moe_apply(dict(p, router=router), x[2 * rank:2 * rank + 2],
                             cfg.top_k, cfg.capacity_factor, ctx)
        (g,) = torch.autograd.grad(aux, router)
    finally:
        del ctx.reduce_partial
    # the data-parallel step's mean over the processes
    torch.distributed.all_reduce(g)
    RESULT[name] = (float(aux), g / 4)
router = p["router"].clone().requires_grad_(True)
_, aux = M.moe_apply(dict(p, router=router), x, cfg.top_k,
                     cfg.capacity_factor)
RESULT["one"] = (float(aux), torch.autograd.grad(aux, router)[0])
"""


def test_aux_loss_gradient_on_a_data_mesh(pool):
    """On ``data 4`` each process routes its 2 rows (the reference's 4 data
    shards of the 8) and the aux loss's means are all-reduced: the aux
    value on every process equals one device's over the whole batch, and
    the mean over the processes of the router's gradient of it equals one
    device's, because ``Spmd.reduce_partial`` sums the gradient of the
    means too; an all-reduce with the identity backward (``Spmd.reduce``)
    would give a quarter of it."""
    outs = pool.run(AUX_TASK)
    for out in outs:
        aux1, g1 = out["one"]
        for name in ("reduce_partial", "reduce"):
            assert out[name][0] == pytest.approx(aux1, rel=1e-6)
        top = float(g1.abs().max())
        assert top > 0
        assert float((out["reduce_partial"][1] - g1).abs().max()) <= \
            1e-5 * top
        assert float((4 * out["reduce"][1] - g1).abs().max()) <= 1e-5 * top


# ---------------------------------------------------------------------------
# in process: the flash plain versions with a query offset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_plain_with_q_offset_equals_rows_of_the_whole(causal, window):
    """``attention_ref`` / ``attention_bwd_ref`` (and the blocked versions
    the walker charges) on q rows [40, 100) of a 128-token sequence with
    ``q_offset`` 40, against those rows of the reference's
    ``flash_attention`` of the whole sequence: the output, and dq, dk, dv
    of a loss that reads only those rows, within ``test_kernels.py``'s f32
    tolerance; with offset 0 each gives what it gave without the
    argument, bit for bit."""
    import jax
    import jax.numpy as jnp
    from repro.models.flash import flash_attention as jflash
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    rng = np.random.RandomState(11)
    b, t, h, g, d, lo, hi = 2, 128, 4, 2, 16, 40, 100
    q, k, v = (rng.normal(0, 1, (b, t, n, d)).astype(np.float32)
               for n in (h, g, g))
    dout = np.zeros((b, t, h, d), np.float32)
    dout[:, lo:hi] = rng.normal(0, 1, (b, hi - lo, h, d))

    def loss(q, k, v):
        out = jflash(q, k, v, causal=causal, window=window, q_chunk=32,
                     kv_chunk=64)
        return (out * dout).sum(), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = np.asarray(want)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    qb, db = tq[:, lo:hi].contiguous(), torch.from_numpy(dout[:, lo:hi])
    out, lse = fops.flash_attention_fwd(qb, tk, tv, causal=causal,
                                        window=window, return_lse=True,
                                        q_offset=lo)
    np.testing.assert_allclose(out.numpy(), want[:, lo:hi], atol=FLASH_ATOL)
    blocked = fref.attention_blocked_ref(qb, tk, tv, causal, window, 16, 32,
                                         q_offset=lo)
    np.testing.assert_allclose(blocked.numpy(), want[:, lo:hi],
                               atol=FLASH_ATOL)
    dq, dk, dv = fops.flash_attention_bwd(qb, tk, tv, out, lse, db,
                                          causal=causal, window=window,
                                          q_offset=lo)
    bq, bk, bv = fref.attention_blocked_bwd_ref(qb, tk, tv, out, lse, db,
                                                causal, window, 16, 32,
                                                q_offset=lo)
    jq, jk, jv = (np.asarray(x) for x in grads)
    for got, w in ((dq, jq[:, lo:hi]), (dk, jk), (dv, jv), (bq, jq[:, lo:hi]),
                   (bk, jk), (bv, jv)):
        np.testing.assert_allclose(got.numpy(), w, atol=FLASH_ATOL)
    o0, l0 = fops.flash_attention_fwd(tq, tk, tv, causal=causal,
                                      window=window, return_lse=True)
    o1, l1 = fref.attention_ref(tq, tk, tv, causal=causal, window=window,
                                return_lse=True, q_offset=0)
    assert torch.equal(o0, o1) and torch.equal(l0, l1)
    full = torch.from_numpy(dout)
    assert all(torch.equal(a, c) for a, c in zip(
        fref.attention_bwd_ref(tq, tk, tv, o0, l0, full, causal=causal,
                               window=window),
        fops.flash_attention_bwd(tq, tk, tv, o0, l0, full, causal=causal,
                                 window=window, q_offset=0)))


# ---------------------------------------------------------------------------
# in process: what check_supported leaves
# ---------------------------------------------------------------------------

#: the acceptance meshes, and the production meshes (16 x 16, 2 x 16 x 16)
SUPPORTED_MESHES = ({"data": 4}, {"data": 2, "model": 2},
                    {"data": 1, "model": 4},
                    {"pod": 2, "data": 2, "model": 2},
                    {"data": 16, "model": 16},
                    {"pod": 2, "data": 16, "model": 16})


#: what is left (ROADMAP, queue 1): an SSM whose heads the model axis does
#: not divide, the 8 SSM heads of the smoke Mamba2 and Jamba on 16
LEFT = {("mamba2-2.7b-smoke", 16), ("jamba-v0.1-52b-smoke", 16)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_check_supported_raises_for_no_config_of_the_registry(arch):
    """Every config of the registry, smoke and full, runs on the mesh's
    SPMD context (or whole on each process, where nothing splits) on
    every acceptance and production mesh: ``check_supported`` answers True
    wherever a parameter splits or experts route across a data axis, and
    raises only for what ``LEFT`` names (the smoke configs' 8 SSM heads on
    a model axis of 16, naming item 12)."""
    from repro_torch.sharding import spmd
    for cfg in (get(arch), smoke(get(arch))):
        for sizes in SUPPORTED_MESHES:
            if (cfg.name, sizes.get("model", 1)) in LEFT:
                with pytest.raises(NotImplementedError,
                                   match="SSM heads.*item 12"):
                    spmd.check_supported(cfg, sizes, rules_for(cfg))
                continue
            got = spmd.check_supported(cfg, sizes, rules_for(cfg))
            want = spmd.shards_parameters(cfg, sizes, rules_for(cfg)) or \
                spmd.routes_rows(cfg, sizes)
            assert got is bool(want), (cfg.name, sizes)
