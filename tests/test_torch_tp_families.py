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
process); and one case of each kind the mesh does not divide
(``UNDIVIDED``: 2 SSM heads, 3 heads of 18 columns, 12
q / 3 kv heads, a 15 + 8 cache, Gemma 3's ring caches of a window of 6
beside its global cache of 24 and a cross cache of 12 frames on 1 × 4,
the FFN split over ``("model", "data")`` on 2 × 2, and DeepSeek's shards
across processes on ``pod 2 × data 3``: six gloo processes against the
reference on six forced devices, the other cases' reference on the first
four of them):

* serve: prefill's logits (random vision or audio inputs), each process's
  vocab block within 1e-4 of the largest of the reference's, and
  ``ServeEngine(mesh=)``'s greedy tokens over 8 decode steps equal to the
  reference engine's on the mesh (``STEPPED``: by the engine's steps by
  hand, and each decode step's logits held as prefill's are);
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

Beside them: bf16 DeepSeek-MoE's sharded prefill against one device, the
port's gap no larger than the reference's (``GAPS``); the aux loss's
gradient on ``data 4`` (its means all-reduced
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
from test_torch_harness import one_thread, run_reference
from test_torch_mesh import GlooPool

pytestmark = pytest.mark.usefixtures("one_thread")

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
#: each mesh's axis sizes, the first major (the reference builds it on its
#: first devices; the port on ranks 0 .. n - 1, ``dp4`` without a model axis)
MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "dp4": {"data": 4, "model": 1}, "pod2x3": {"pod": 2, "data": 3}}
#: the variants: (config, changes).  6 heads (1.5 a process on a model axis
#: of 4: 96 flat q columns), the VLM's vision tokens 6; then one a case
#: where the mesh does not divide a dimension (UNDIVIDED)
VARIANTS = {
    "llama6": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 2}),
    "whisper6": (FAMILIES["whisper"], {"n_heads": 6, "n_kv_heads": 2}),
    "vlm6": (FAMILIES["vlm"], {"n_heads": 6, "n_kv_heads": 2,
                               "n_vision_tokens": 6}),
    "mamba2h": ("mamba2-2.7b", {"ssm_head_dim": 64}),
    "llama3h": ("llama3.2-3b", {"n_heads": 3, "n_kv_heads": 1,
                                "head_dim": 18}),
    "gqa12": ("llama3.2-3b", {"n_heads": 12, "n_kv_heads": 3}),
    "llama": ("llama3.2-3b", {}),
    "whisper12": (FAMILIES["whisper"], {}),
    "moe6": (FAMILIES["deepseek"], {}),
    "mixed": ("llama3.2-3b", {"rules_overrides": (("ffn", ("model",
                                                           "data")),)}),
    "deepseek_bf16": (FAMILIES["deepseek"], {"dtype": "bfloat16"}),
    "gemma6": ("gemma3-4b", {"window": 6}),
}
#: where the mesh does not divide a dimension, one case a kind: 2 SSM heads
#: on a model axis of 4 (every head on each process); 3 heads of 18 (54
#: flat columns) on 4, batch 4 in the "batch" mode and batch 2 in the "cp"
#: mode (whole weights); 12 q and 3 kv heads on 4 (groups that do not line
#: up: each local head's kv head by an index map); a decode cache of 15 + 8
#: positions on 4 (whole on each process); Gemma 3's window of 6 on 4 with
#: a 16 + 8 context (its ring caches of 6 whole, its global cache of 24 split
#: to 6 a process: two layouts of one local length); Whisper's cross cache
#: of 12 frames (the config's 16); DeepSeek on pod 2 x data 3, whose 6 data
#: shards halve to 1 for a batch of 4 dealt in 2 blocks; the FFN's columns
#: split over ("model", "data") on 2 x 2
UNDIVIDED = [("mamba2h", "1x4", 2, 16), ("llama3h", "1x4", 4, 16),
             ("llama3h", "1x4", 2, 16), ("gqa12", "1x4", 2, 16),
             ("llama", "1x4", 2, 15), ("gemma6", "1x4", 2, 16),
             ("whisper12", "1x4", 2, 16),
             ("moe6", "pod2x3", 4, 16), ("mixed", "2x2", 4, 16)]
#: (config tag, mesh, batch, tokens) of every case
CASES = ([(tag, m, 4, 16) for tag in FAMILIES for m in ("2x2", "1x4")]
         + [("deepseek", "dp4", 4, 16)]
         + [("llama6", "1x4", b, s) for s in (16, 1024) for b in (4, 2)]
         + [("whisper6", "1x4", 4, 16), ("vlm6", "1x4", 2, 16)]
         + UNDIVIDED)
#: the audio frames of a case that serves other than the config's (its
#: cross cache laid out by ``init_cache(n_frames=)``; no train steps: the
#: trainer reads the config's frames)
FRAMES = {"whisper12": 12}
TRAIN_CASES = [c for c in CASES if c[0] not in FRAMES]
#: the cases served step by step, each decode step's logits held to the
#: reference's as prefill's are (the engine's steps, by hand)
STEPPED = ("whisper12", "gemma6")
#: bf16 DeepSeek-MoE on 2 x 2: the prefill's gap from one device's, in
#: both packages (ROADMAP queue 3, item 2)
GAPS = [("deepseek_bf16", "2x2", 4, 16)]
NEW, STEPS = 8, 3
#: one reference subprocess a config (the UNDIVIDED cases in one of their
#: own, on 6 devices; GAPS in their config's), this many at once
REFERENCE_WORKERS = 3


def _group(tag: str) -> str:
    """The reference subprocess a tag's cases run in."""
    if tag in {c[0] for c in UNDIVIDED}:
        return "undivided"
    return "deepseek" if tag == "deepseek_bf16" else tag


def _cfg(tag: str):
    if tag not in VARIANTS:
        return smoke(get(FAMILIES[tag]))
    arch, extra = VARIANTS[tag]
    c = smoke(get(arch))
    return dataclasses.replace(c, name=f"{c.name}-{tag}", **extra)


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
            0, 1, (b, FRAMES.get(tag, cfg.n_audio_frames),
                   cfg.d_model)).astype(np.float32)
    return out


REFERENCE_CODE = """
import dataclasses, json, math
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get, smoke
from repro.configs.registry import rules_for
from repro.launch.mesh import make_replay_mesh
from repro.models.model import (
    build_forward, init_cache, init_params, logical_axes_tree,
)
from repro.serve.engine import ServeEngine
from repro.sharding.partition import sharding_for_shape
from repro.train.loop import Trainer

assert jax.device_count() == DEVICES

def config(tag):
    if tag not in VARIANTS:
        return smoke(get(FAMILIES[tag]))
    arch, extra = VARIANTS[tag]
    c = smoke(get(arch))
    return dataclasses.replace(c, name=f"{c.name}-{tag}", **extra)

def mesh_of(mname):
    sizes = MESHES[mname]
    return make_replay_mesh(sizes,
                            devices=jax.devices()[:math.prod(sizes.values())])

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

def serve_steps(cfg, p, mesh, batch, n):
    # prefill (with the batch's frames, if any), its cache in the decode
    # buffers, then greedy decode steps: each step's logits
    pre = jax.jit(lambda p, b: build_forward(cfg, "prefill")(p, b, cfg, mesh))
    dec = jax.jit(lambda p, c, b, pos: build_forward(cfg, "decode")(
        p, c, b, pos, cfg, mesh))
    b, s = batch["tokens"].shape
    frames = batch["audio_frames"].shape[1] if "audio_frames" in batch else 0
    logits, pc = pre(p, batch)
    cache = jax.tree.map(ServeEngine._embed_cache, init_cache(
        cfg, b, s + n, frames), pc)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out, steps = [np.asarray(tok)], []
    for i in range(n - 1):
        lg, cache = dec(p, cache, {"tokens": tok[:, None]}, jnp.int32(s + i))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
        steps.append(np.asarray(lg))
    return logits, np.stack(out, axis=1), np.stack(steps)

meta = {}
for tag, mname, b, s in CASES:
    key = f"{tag}_{mname}_{b}x{s}"
    cfg = config(tag)
    mesh = mesh_of(mname)
    p = place(init_params(cfg, 0), cfg, mesh)
    inputs = dict(np.load(OUT / f"inputs_{key}.npz.in"))
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    if tag in STEPPED:
        logits, tokens, steps = serve_steps(cfg, p, mesh, batch, NEW)
        out = {"logits": logits, "tokens": tokens, "steps": steps}
        if tag in FRAMES:
            save_arrays(OUT / f"run_{key}.npz", out)
            continue
    else:
        eng = ServeEngine(cfg, p, mesh, max_len=s + NEW)
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
for tag, mname, b, s in GAPS:
    key = f"{tag}_{mname}_{b}x{s}"
    cfg = config(tag)
    params = init_params(cfg, 0)
    batch = {k: jnp.asarray(v) for k, v in
             np.load(OUT / f"inputs_{key}.npz.in").items()}
    fwd = build_forward(cfg, "prefill")
    mesh = mesh_of(mname)
    sharded = jax.jit(lambda p, b: fwd(p, b, cfg, mesh))(
        place(params, cfg, mesh), batch)[0]
    one = jax.jit(lambda p, b: fwd(p, b, cfg))(params, batch)[0]
    np.savez(OUT / f"gap_{key}.npz", mesh=np.asarray(sharded, np.float32),
             one=np.asarray(one, np.float32))
(OUT / "meta.json").write_text(json.dumps(meta))
"""


def _by_group() -> dict:
    """The cases (and GAPS) by reference subprocess, Jamba's first: its
    reference compiles longest (about 100 s of the subprocesses' 250), so
    it starts at once; the UNDIVIDED cases next."""
    out: dict = {"jamba": ([], []), "undivided": ([], [])}
    for i, cases in enumerate((CASES, GAPS)):
        for case in cases:
            out.setdefault(_group(case[0]), ([], []))[i].append(case)
    return out


def _config_tags() -> set:
    return {c[0] for c in CASES + GAPS}


@pytest.fixture(scope="module")
def init_weights(tmp_path_factory):
    """The reference's initial weights of each config (its ``init_params``
    in process: numpy draws), as ``init_<tag>.npz`` of leaves in order."""
    import jax
    from repro.configs import get as jget, smoke as jsmoke
    from repro.models.model import init_params as jinit
    out = tmp_path_factory.mktemp("tpf_init")
    for tag in sorted(_config_tags()):
        if tag in VARIANTS:
            arch, extra = VARIANTS[tag]
            cfg = dataclasses.replace(jsmoke(jget(arch)), **extra)
        else:
            cfg = jsmoke(jget(FAMILIES[tag]))
        leaves = jax.tree.leaves(jinit(cfg, 0))
        np.savez(out / f"init_{tag}.npz",
                 **{str(i): np.asarray(a) for i, a in enumerate(leaves)})
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs, one subprocess a config (the UNDIVIDED cases
    in one on 6 devices), started in the background beside the pool."""
    ex = concurrent.futures.ThreadPoolExecutor(REFERENCE_WORKERS)
    futs = {}
    for group, (cases, gaps) in _by_group().items():
        out = tmp_path_factory.mktemp(f"ref_tpf_{group}")
        for t, mname, b, s in cases + gaps:
            with open(out / f"inputs_{_key(t, mname, b, s)}.npz.in",
                      "wb") as f:                      # not read back
                np.savez(f, **_inputs(t, b, s))
        devices = 6 if group == "undivided" else 4
        env = {"XLA_FLAGS": "--xla_force_host_platform_device_count="
                            f"{devices}"}
        code = (f"FAMILIES = {FAMILIES!r}\nMESHES = {MESHES!r}\n"
                f"VARIANTS = {VARIANTS!r}\nFRAMES = {FRAMES!r}\n"
                f"STEPPED = {STEPPED!r}\n"
                f"CASES = {cases!r}\nGAPS = {gaps!r}\n"
                f"NEW, STEPS, DEVICES = {NEW}, {STEPS}, {devices}\n"
                + REFERENCE_CODE)
        futs[group] = ex.submit(run_reference, code, out, 900, env)
    yield futs
    ex.shutdown(wait=True)


POOL_SETUP = """
import dataclasses
import numpy as np, torch
from repro_torch.configs import get, smoke
from repro_torch.configs.registry import rules_for
from repro_torch.launch.mesh import (
    make_dp_mesh, make_replay_mesh, make_test_mesh,
)
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import (
    abstract_cache, build_forward, cache_logical_axes, init_cache,
    init_params, logical_axes_tree, params_from_numpy,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding.partition import (
    local_shard, shard_params, sharding_for_shape,
)
import repro_torch.train.loop as loop_mod
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adamw_init
if world == 4:
    meshes = {"2x2": make_test_mesh(2, 2), "1x4": make_test_mesh(1, 4),
              "dp4": make_dp_mesh(4)}
else:
    meshes = {"pod2x3": make_replay_mesh(MESHES["pod2x3"])}

def config(tag):
    if tag not in VARIANTS:
        return smoke(get(FAMILIES[tag]))
    arch, extra = VARIANTS[tag]
    c = smoke(get(arch))
    return dataclasses.replace(c, name=f"{c.name}-{tag}", **extra)

def whole_from(cfg, path):
    arrs = np.load(path)
    tmpl = init_params(cfg, 0, "cpu")
    idx = {id(t): i for i, t in enumerate(tree_leaves(tmpl))}

    def leaf(t):
        a = np.array(arrs[str(idx[id(t)])])
        if a.dtype.kind == "V":         # bfloat16, saved as raw 2-byte words
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a).to(t.dtype)

    return tree_map(leaf, tmpl)

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

def serve_steps(cfg, params, mesh, inputs, n):
    # prefill (with the inputs' frames, if any: their cross cache laid out
    # by init_cache(n_frames=)), then greedy decode steps (the engine's
    # steps): each step's logits
    eng = ServeEngine(cfg, params, mesh, max_len=inputs["tokens"].shape[1]
                      + n)
    b, s = inputs["tokens"].shape
    frames = inputs["audio_frames"].shape[1] if "audio_frames" in inputs \
        else 0
    shape = (cfg, b, s + n, frames)
    cache = init_cache(cfg, b, s + n, n_frames=frames, mesh=mesh)
    with torch.inference_mode():
        logits, pc = build_forward(cfg, "prefill")(
            params, {k: rows(v, mesh, cfg) for k, v in inputs.items()}, cfg,
            mesh)
        cache = tree_map(eng._rehome, cache, pc, cache_logical_axes(*shape),
                         abstract_cache(*shape))
        tok = eng._argmax(logits)
        out, steps = [tok], []
        for i in range(n - 1):
            lg, cache = build_forward(cfg, "decode")(
                params, cache, {"tokens": tok[:, None]}, s + i, cfg, mesh)
            tok = eng._argmax(lg)
            out.append(tok)
            steps.append(lg)
    return (logits, torch.stack(out, dim=1).numpy(), torch.stack(steps),
            eng.ctx is not None)
"""

SERVE_TRAIN_TASK = """
RESULT = {}
for tag, mname, b, s in CASES:
    key = f"{tag}_{mname}_{b}x{s}"
    cfg, mesh = config(tag), meshes[mname]
    whole = whole_from(cfg, f"{INIT}/init_{tag}.npz")
    inputs = dict(np.load(f"{INPUTS}/{key}.npz"))
    params = shard_params(whole, logical_axes_tree(cfg), mesh, rules_for(cfg))
    decoded = None
    if tag in STEPPED:
        logits, tokens, decoded, sharded = serve_steps(cfg, params, mesh,
                                                       inputs, NEW)
        if tag in FRAMES:
            RESULT[key] = dict(logits=logits, tokens=tokens, steps=decoded,
                               sharded=sharded)
            continue
    else:
        with torch.inference_mode():
            logits = build_forward(cfg, "prefill")(
                params, {k: rows(v, mesh, cfg) for k, v in inputs.items()},
                cfg, mesh)[0]
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
    RESULT[key] = dict(logits=logits, tokens=tokens, steps=decoded,
                       losses=losses, norms=norms, sharded=t._dp.sharded,
                       lrs=[x[0] for x in steps], g0=steps[0][1],
                       params=[x.detach().clone()
                               for x in tree_leaves(t.params)])
for tag, mname, b, s in GAPS:
    key = f"{tag}_{mname}_{b}x{s}"
    cfg, mesh = config(tag), meshes[mname]
    whole = whole_from(cfg, f"{INIT}/init_{tag}.npz")
    inputs = dict(np.load(f"{INPUTS}/{key}.npz"))
    params = shard_params(whole, logical_axes_tree(cfg), mesh, rules_for(cfg))
    fwd = build_forward(cfg, "prefill")
    with torch.inference_mode():
        sharded = fwd(params, {k: rows(v, mesh, cfg)
                               for k, v in inputs.items()}, cfg, mesh)[0]
        one = fwd(whole, {k: torch.from_numpy(v) for k, v in inputs.items()},
                  cfg)[0]
    RESULT[key] = dict(mesh=sharded.float(), one=one.float())
"""

#: the processes of each pool, and the meshes each runs
POOLS = {4: ("2x2", "1x4", "dp4"), 6: ("pod2x3",)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory, reference):
    """A gloo pool of each size (POOLS), started beside the reference."""
    pools = {}
    try:
        for n in POOLS:
            pools[n] = GlooPool(tmp_path_factory.mktemp(f"gloo_tpf{n}"), n)
            pools[n].run(f"FAMILIES = {FAMILIES!r}\nVARIANTS = {VARIANTS!r}"
                         f"\nMESHES = {MESHES!r}\n" + POOL_SETUP)
        yield pools
    finally:
        for p in pools.values():
            p.close()


@pytest.fixture(scope="module")
def served(pool, reference, init_weights, tmp_path_factory):
    """The pools' serve and train runs of every case (from the reference's
    weights, while the reference runs), each case's results a process, and
    the reference's results by subprocess."""
    inputs = tmp_path_factory.mktemp("tpf_in")
    for tag, mname, b, s in CASES + GAPS:
        np.savez(inputs / f"{_key(tag, mname, b, s)}.npz",
                 **_inputs(tag, b, s))
    root = tmp_path_factory.mktemp("tpf_ck")
    outs: dict = {}
    for n, meshes in POOLS.items():
        got = pool[n].run(
            f"INIT = {str(init_weights)!r}\nROOT = {str(root)!r}\n"
            f"INPUTS = {str(inputs)!r}\nFRAMES = {FRAMES!r}\n"
            f"STEPPED = {STEPPED!r}\n"
            f"CASES = {[c for c in CASES if c[1] in meshes]!r}\n"
            f"GAPS = {[c for c in GAPS if c[1] in meshes]!r}\n"
            f"NEW, STEPS = {NEW}, {STEPS}\n" + SERVE_TRAIN_TASK,
            timeout=600)
        for key in got[0]:
            outs[key] = [out[key] for out in got]
    refs = {group: f.result() for group, f in reference.items()}
    return refs, outs


def _sizes(mname: str) -> dict:
    return MESHES[mname]


def _coord(mname: str, r: int) -> dict:
    sizes = MESHES[mname]
    return dict(zip(sizes, (int(c) for c in np.unravel_index(
        r, tuple(sizes.values())))))


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
TRAIN_IDS = [_key(*c) for c in TRAIN_CASES]


@pytest.mark.parametrize("tag,mname,b,s", CASES, ids=IDS)
def test_serve_on_the_mesh_matches_the_reference(served, tag, mname, b, s):
    """Prefill's logits (each process's block of (rows, vocab)) within 1e-4
    of the largest of the reference's on the same mesh, and the engine's
    greedy tokens over 8 decode steps equal to the reference engine's, on
    every process; a ``STEPPED`` case's decode steps' logits as prefill's."""
    refs, outs = served
    key = _key(tag, mname, b, s)
    want = refs[_group(tag)][f"run_{key}"]
    cfg = _cfg(tag)
    spec = PP.sharding_for_shape((b, cfg.padded_vocab), ("batch", "vocab"),
                                 _sizes(mname), rules_for(cfg))
    for r, got in enumerate(outs[key]):
        assert got["sharded"]
        _close(got["logits"].numpy(), _block(want["logits"], spec, mname, r),
               LOGIT_RTOL, f"{key} process {r} logits")
        np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                      err_msg=f"{key} process {r}")
        if tag in STEPPED:
            assert got["steps"].shape[0] == want["steps"].shape[0] == NEW - 1
            for i, lg in enumerate(got["steps"]):
                _close(lg.numpy(), _block(want["steps"][i], spec, mname, r),
                       LOGIT_RTOL, f"{key} process {r} decode step {i}")


@pytest.mark.parametrize("tag,mname,b,s", TRAIN_CASES, ids=TRAIN_IDS)
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
    meta = refs[_group(tag)]["meta"][key]
    want = refs[_group(tag)][f"run_{key}"]
    cfg = _cfg(tag)
    specs = [m.spec for m in tree_leaves(param_specs(cfg, _sizes(mname)))]
    for r, got in enumerate(outs[key]):
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


def _whole_logits(blocks: list, spec, mname: str, shape) -> np.ndarray:
    """The whole logits from each process's block under ``spec``."""
    out = np.zeros(shape, np.float64)
    for r, blk in enumerate(blocks):
        idx = np.arange(np.prod(shape)).reshape(shape)
        out.reshape(-1)[_block(idx, spec, mname, r).reshape(-1)] = \
            np.asarray(blk, np.float64).reshape(-1)
    return out


@pytest.mark.parametrize("tag,mname,b,s", GAPS,
                         ids=[_key(*c) for c in GAPS])
def test_bf16_sharded_gap_no_larger_than_the_references(served, tag, mname,
                                                        b, s):
    """bf16 DeepSeek-MoE on 2 x 2 against one device, in both packages:
    the prefill logits' max|sharded - one device| as a share of the one
    device's largest.  The port's gap is no larger than the reference's
    own (ROADMAP queue 3, item 2): routing on a bf16 router product flips
    near-tied picks wherever the sums run in another order, in both."""
    refs, outs = served
    key = _key(tag, mname, b, s)
    cfg = _cfg(tag)
    want = refs[_group(tag)][f"gap_{key}"]
    spec = PP.sharding_for_shape((b, cfg.padded_vocab), ("batch", "vocab"),
                                 _sizes(mname), rules_for(cfg))
    got = outs[key]
    mesh = _whole_logits([g["mesh"].numpy() for g in got], spec, mname,
                         (b, cfg.padded_vocab))
    one = got[0]["one"].numpy().astype(np.float64)
    ref_gap = float(np.abs(want["mesh"] - want["one"]).max()
                    / np.abs(want["one"]).max())
    port_gap = float(np.abs(mesh - one).max() / np.abs(one).max())
    print(f"bf16 {key}: the port's gap {port_gap!r}, the reference's "
          f"{ref_gap!r}")
    assert port_gap <= ref_gap, (port_gap, ref_gap)


#: two decode caches of one local length on 1 x 4, laid out before either
#: decodes: (context, prompt) of each, the first split over model (24: 6 a
#: process), the second whole (6: the axis does not divide it)
LAYOUTS = ((24, 16), (6, 2))
LAYOUTS_TASK = """
from repro_torch.sharding import spmd
cfg = config("llama")
mesh = meshes["1x4"]
ctx = spmd.context(mesh, cfg)
whole = init_params(cfg, 0, "cpu")
prefill, decode = build_forward(cfg, "prefill"), build_forward(cfg, "decode")
toks = torch.from_numpy(np.random.RandomState(3).randint(
    0, 512, (2, max(n for n, _ in LAYOUTS))).astype(np.int32))
RESULT = {}
for name, m in (("mesh", mesh), ("one", None)):
    p = whole if m is None else shard_params(whole, logical_axes_tree(cfg),
                                             m, rules_for(cfg))
    args = () if m is None else (m,)
    caches = {}
    with torch.inference_mode():
        for n, plen in LAYOUTS:
            pre = prefill(p, {"tokens": toks[:, :plen]}, cfg, *args)[1]
            caches[n] = ServeEngine(cfg, p, m, device="cpu", max_len=n
                                    ).decode_cache(pre, 2)
        out = []
        for i in range(4):
            for n, plen in LAYOUTS:
                lg, caches[n] = decode(p, caches[n], {
                    "tokens": toks[:, plen + i:plen + i + 1]}, plen + i, cfg,
                    *args)
                out.append(lg if m is None else ctx.all_gather(lg, 1))
    RESULT[name] = torch.stack(out)
"""


def test_two_cache_layouts_of_one_local_length(pool):
    """Two decode caches on one mesh at once that hold the same length a
    process: one this process's block of a sequence split over ``model``,
    one whole because the axis does not divide it.  Each buffer carries its
    own global length, so stepping them in turn gives one device's logits
    (within 1e-4 of the largest) on every process, for both."""
    outs = pool[4].run(f"LAYOUTS = {LAYOUTS!r}\n" + LAYOUTS_TASK)
    for r, out in enumerate(outs):
        assert out["mesh"].shape == out["one"].shape
        for i, (a, w) in enumerate(zip(out["mesh"], out["one"])):
            _close(a.numpy(), w.numpy(), LOGIT_RTOL, f"process {r} step {i}")


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
    outs = pool[4].run(AUX_TASK)
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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_check_supported_raises_for_no_config_of_the_registry(arch):
    """Every config of the registry, smoke and full, runs on the mesh's
    SPMD context (or whole on each process, where nothing splits) on every
    acceptance and production mesh and on a model axis of 3:
    ``check_supported`` answers True wherever a parameter splits or
    experts route across a data axis (the smoke configs' 8 SSM heads on a
    model axis of 16 and Mamba2 2.7B's 80 on 3 too: every head on each
    process)."""
    from repro_torch.sharding import spmd
    for cfg in (get(arch), smoke(get(arch))):
        for sizes in SUPPORTED_MESHES + ({"data": 1, "model": 3},):
            got = spmd.check_supported(cfg, sizes, rules_for(cfg))
            want = spmd.shards_parameters(cfg, sizes, rules_for(cfg)) or \
                spmd.routes_rows(cfg, sizes)
            assert got is bool(want), (cfg.name, sizes)
