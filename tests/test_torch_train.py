"""The port's training path against the JAX reference's, on the same numpy
inputs and weights (carried across with ``params_from_numpy``), on the CPU
in f32: the loss head (``softmax_xent``, ``chunked_loss``), ``lm_loss`` and
every parameter's gradient on the smoke configs, AdamW (``adamw_update``,
``lr_schedule``, ``global_norm``), one training step, the data pipeline;
and port counterparts of ``tests/test_train_infra.py``: prefetch order,
checkpoint round trips, async save and gc, crash/resume, microbatching.

The reference's ``train/loop.py`` and ``train/checkpoint.py`` do not import
on this JAX (``src/repro/compat.py:127``), so the reference's step is
composed here from ``jax.value_and_grad(lm_loss)`` and ``adamw_update``.
Every tolerance is stated beside its test.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get, smoke as jax_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import (
    build_forward as jax_build_forward, init_params as jax_init_params,
)
from repro.train import data as jax_data
from repro.train import optimizer as JO
from repro_torch.configs import get, smoke
from repro_torch.models import layers as L
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import (
    build_forward, init_params, params_from_numpy,
)
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import Prefetcher, TokenDataset
from repro_torch.train.loop import (
    TrainOptions, Trainer, _InjectedFailure, _value_and_grad, make_train_step,
)

#: (arch, batch, seq): Llama and Gemma at 1024 tokens, so attention takes
#: the flash path (and Gemma's windowed layers the windowed backward)
ARCHS = [("llama3.2-3b", 1, 1024), ("mamba2-2.7b", 2, 64),
         ("gemma3-4b", 1, 1024)]
#: the MoE family (DeepSeek at 1024 tokens, through flash; Mixtral's
#: windows; Jamba's SSM, attention and alternate MoE layers: the smoke
#: configs drop no token) and the encoder-decoder, with the data
#: pipeline's random audio frames
ZOO_ARCHS = [("deepseek-moe-16b", 1, 1024), ("mixtral-8x22b", 2, 40),
             ("jamba-v0.1-52b", 2, 64), ("whisper-large-v3", 2, 24)]
#: loss: f32 sums of the same terms in other orders (XLA against torch)
LOSS_RTOL = 1e-5
#: each gradient leaf within GRAD_RTOL of its largest |reference| value:
#: f32 products and sums in other orders through a few layers, measured at
#: most 2e-6 on these configs; a wrong mask, a dropped term or a gradient
#: of the wrong leaf is off by O(1)
GRAD_RTOL = 1e-4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _setup(arch: str, batch: int, seq: int, **overrides):
    """The reference's smoke config, weights and a batch, and the port's."""
    jcfg = dataclasses.replace(jax_smoke(jax_get(arch)), **overrides)
    cfg = dataclasses.replace(smoke(get(arch)), **overrides)
    jparams = jax_init_params(jcfg, 0)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    ds = TokenDataset(cfg.vocab, seq, batch, seed=3)
    data = {**ds.batch_at(0), **ds.extras(cfg)}
    return jcfg, cfg, jparams, params, data


def _leaf_close(got: torch.Tensor, want, rtol: float, what: str) -> float:
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    err = float(np.abs(_np(got) - want).max())
    assert err <= rtol * top, f"{what}: {err} > {rtol} * {top}"
    return err / top if top else 0.0


# ---------------------------------------------------------------------------
# the loss head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8, 32])
def test_chunked_loss_value_and_grads_match_reference(chunk):
    """chunk 0 and chunk = s take the whole sequence at once, chunk 8 four
    checkpointed chunks; value within LOSS_RTOL, gradients of x and of the
    table within 1e-5 of their largest value (f32 sums in other orders)."""
    rng = np.random.RandomState(chunk)
    b, s, d, v = 2, 32, 16, 64
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    labels = rng.randint(0, v, (b, s)).astype(np.int32)
    want, (wx, wt) = jax.value_and_grad(JL.chunked_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels), chunk)
    tx, tt = (torch.from_numpy(a).requires_grad_(True) for a in (x, table))
    got = L.chunked_loss(tx, tt, torch.from_numpy(labels), chunk)
    gx, gt = torch.autograd.grad(got, (tx, tt))
    assert float(want) > 1.0
    assert abs(float(got.detach()) - float(want)) <= LOSS_RTOL * float(want)
    _leaf_close(gx, wx, 1e-5, "d loss / d x")
    _leaf_close(gt, wt, 1e-5, "d loss / d table")


def test_softmax_xent_matches_reference():
    rng = np.random.RandomState(1)
    logits = (4 * rng.normal(0, 1, (3, 5, 40))).astype(np.float32)
    labels = rng.randint(0, 40, (3, 5)).astype(np.int32)
    want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), 40)
    got = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,batch,seq", ARCHS + ZOO_ARCHS)
def test_lm_loss_and_grads_match_reference(arch, batch, seq):
    jcfg, cfg, jparams, params, data = _setup(arch, batch, seq)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    want, wgrads = jax.value_and_grad(jax_build_forward(jcfg, "loss"))(
        jparams, jbatch, jcfg)
    loss_fn = build_forward(cfg, "loss")
    got, grads = _value_and_grad(lambda p, b: loss_fn(p, b, cfg), params,
                                 {k: torch.from_numpy(v)
                                  for k, v in data.items()})
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    wleaves = jax.tree.leaves(wgrads)
    gleaves = tree_leaves(grads)
    assert len(wleaves) == len(gleaves)
    worst = max(_leaf_close(g, w, GRAD_RTOL, f"{arch} leaf {i}")
                for i, (g, w) in enumerate(zip(gleaves, wleaves)))
    print(f"{arch}: loss {float(got):.6f} vs {float(want):.6f}, worst grad "
          f"leaf {worst:.3g} of its largest value")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_remat_and_loss_chunk_leave_grads_unchanged(arch):
    """Checkpointed units recompute the same forward, so the gradients are
    equal bit for bit; the chunked loss head sums in another order, within
    1e-6 of each leaf's largest value."""
    seq = 64
    out = {}
    for remat, chunk in ((False, 0), (True, 0), (True, 16)):
        _, cfg, _, params, data = _setup(arch, 2, seq, remat=remat,
                                         loss_chunk=chunk)
        loss_fn = build_forward(cfg, "loss")
        out[(remat, chunk)] = _value_and_grad(
            lambda p, b: loss_fn(p, b, cfg), params,
            {k: torch.from_numpy(v) for k, v in data.items()})
    base_loss, base = out[(False, 0)]
    loss, grads = out[(True, 0)]
    assert torch.equal(loss, base_loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                 tree_leaves(base)))
    loss, grads = out[(True, 16)]
    assert abs(float(loss) - float(base_loss)) <= 1e-6 * float(base_loss)
    for a, b in zip(tree_leaves(grads), tree_leaves(base)):
        _leaf_close(a, _np(b), 1e-6, "chunked head")


def test_loss_path_keeps_the_parameters():
    """The loss and its backward leave the parameters as they were and
    not requiring grad, on each smoke config (64 tokens)."""
    for arch, batch, _ in ARCHS:
        _, cfg, _, params, data = _setup(arch, batch, 64)
        before = tree_map(torch.clone, params)
        loss_fn = build_forward(cfg, "loss")
        _value_and_grad(lambda p, b: loss_fn(p, b, cfg), params,
                        {k: torch.from_numpy(v) for k, v in data.items()})
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                     tree_leaves(before)))
        assert not any(t.requires_grad for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_tree(seed: int):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
            "stack": rng.normal(0, 1, (2, 3, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32)}


def test_lr_schedule_and_global_norm_match_reference():
    cfg = O.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    jcfg = JO.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 60):
        want = float(JO.lr_schedule(jnp.int32(step), jcfg))
        got = float(O.lr_schedule(torch.tensor(step, dtype=torch.int32), cfg))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    tree = _opt_tree(0)
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(O.global_norm(tree_map(torch.from_numpy, tree)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    """Three steps on f32 leaves of 1, 2 and 3 dims (decay on the last two
    only), clipped (clip 1) and not (clip 100): parameters and moments
    within 1e-6 of their largest value, the metrics within 1e-6 relative
    (the same f32 arithmetic; XLA may fuse it into other roundings)."""
    cfg = O.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        grad_clip=clip)
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, _opt_tree(0))
    tp = tree_map(torch.from_numpy, _opt_tree(0))
    jst, tst = JO.adamw_init(jp), O.adamw_init(tp)
    for i in range(3):
        g = _opt_tree(10 + i)
        jp, jst, jm = JO.adamw_update(jax.tree.map(jnp.asarray, g), jp, jst,
                                      jcfg)
        tp, tst, tm = O.adamw_update(tree_map(torch.from_numpy, g), tp, tst,
                                     cfg)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    for got, want in ((tp, jp), (tst["mu"], jst["mu"]),
                      (tst["nu"], jst["nu"])):
        for key in want:
            _leaf_close(got[key], want[key], 1e-6, key)


def test_adamw_keeps_bf16_leaves_and_updates_in_place():
    tp = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = O.adamw_init(tp)
    ptr = tp["w"].data_ptr()
    # lr 0.1: a step of 3e-4 would round back to 1.0 in bf16
    out, st, _ = O.adamw_update({"w": torch.full((4, 4), 0.5)}, tp, st,
                                O.AdamWConfig(lr=0.1, warmup_steps=1))
    assert out["w"].dtype == torch.bfloat16 and out["w"].data_ptr() == ptr
    assert st["mu"]["w"].dtype == torch.float32
    assert float(out["w"].float().max()) < 1.0


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,batch,seq", [ARCHS[0], ARCHS[1]])
def test_train_step_matches_reference(arch, batch, seq):
    """make_train_step against jax.value_and_grad(lm_loss) + adamw_update
    composed: loss within LOSS_RTOL, gradient norm within 1e-5, lr exact.
    AdamW's first step moves a weight by lr g / (|g| + eps), about lr times
    the sign of g: where the clipped |g| is at least 1e-6 (100 eps) that
    step changes by at most lr eps / |g| times g's relative error, so the
    updated weights are held within 1e-3 lr of the reference's there;
    where g is rounding noise the step is not defined to better than its
    own size, and the weights are held within 2 lr."""
    jcfg, cfg, jparams, params, data = _setup(arch, batch, seq)
    ocfg = O.AdamWConfig(lr=1e-2, warmup_steps=1)
    jocfg = JO.AdamWConfig(lr=1e-2, warmup_steps=1)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    wloss, wgrads = jax.value_and_grad(JT.lm_loss)(jparams, jbatch, jcfg)
    wparams, _, wm = JO.adamw_update(wgrads, jparams, JO.adamw_init(jparams),
                                     jocfg)
    step = make_train_step(cfg, opt_cfg=ocfg, device="cpu")
    params, _, m = step(params, O.adamw_init(params), data)
    assert abs(float(m["loss"]) - float(wloss)) <= LOSS_RTOL * float(wloss)
    gn = float(wm["grad_norm"])
    assert float(m["grad_norm"]) == pytest.approx(gn, rel=1e-5)
    lr = float(m["lr"])
    assert lr == pytest.approx(1e-2, rel=1e-6)
    clip = min(1.0, 1.0 / gn)
    worst = {True: 0.0, False: 0.0}
    for got, want, g in zip(tree_leaves(params), jax.tree.leaves(wparams),
                            jax.tree.leaves(wgrads)):
        err = np.abs(_np(got) - np.asarray(want, np.float32))
        firm = np.abs(np.asarray(g, np.float32)) * clip >= 1e-6
        for key in (True, False):
            sel = err[firm == key]
            if sel.size:
                worst[key] = max(worst[key], float(sel.max()))
    print(f"{arch}: worst |port - reference| after one step: "
          f"{worst[True] / lr:.3g} lr where |g| >= 1e-6, "
          f"{worst[False] / lr:.3g} lr elsewhere")
    assert worst[True] <= 1e-3 * lr
    assert worst[False] <= 2 * lr


# ---------------------------------------------------------------------------
# data, checkpoints, the trainer (tests/test_train_infra.py:41-122)
# ---------------------------------------------------------------------------


def test_token_dataset_is_the_references():
    mine = TokenDataset(1000, 16, 4, seed=7)
    ref = jax_data.TokenDataset(1000, 16, 4, seed=7)
    for step in (0, 1, 42):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(mine.batch_at(43)["tokens"],
                              mine.batch_at(42)["tokens"])


def test_prefetcher_order():
    ds = TokenDataset(100, 8, 2)
    pf = Prefetcher(ds, start_step=5)
    try:
        for want in (5, 6, 7):
            step, batch = next(pf)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          ds.batch_at(want)["tokens"])
    finally:
        pf.close()


def test_checkpoint_roundtrip_with_bf16_leaves(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "nest": {"b": torch.ones((4,), dtype=torch.int32),
                      "w": torch.randn(3, 5).to(torch.bfloat16)},
             "t": (torch.zeros(2), torch.full((2,), 3.0))}
    mgr.save(3, state, {"step": 3})
    step, got, extra = mgr.restore(state, device="cpu")
    assert step == 3 and extra["step"] == 3
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(got["t"], tuple)
    import json
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["nest/w"]["dtype"] == "bfloat16"
    assert set(manifest["leaves"]) == {"a", "nest/b", "nest/w", "t/[0]",
                                       "t/[1]"}


def _bf16_values() -> torch.Tensor:
    return torch.tensor([[1.0, -2.5, 0.1], [3.0e38, -0.0, 1e-40]]
                        ).to(torch.bfloat16)


def test_checkpoint_bf16_leaf_is_the_references_file(tmp_path):
    """A bf16 leaf is written byte for byte as the reference writes it:
    ``np.save`` of the same values as an ml_dtypes bfloat16 array."""
    import ml_dtypes
    w = _bf16_values()
    CheckpointManager(tmp_path).save(1, {"w": w, "a": torch.ones(3)})
    want = tmp_path / "want.npy"
    np.save(want, w.float().numpy().astype(ml_dtypes.bfloat16))
    got = (tmp_path / "step_00000001" / "w.npy").read_bytes()
    assert got == want.read_bytes()
    assert np.load(want).dtype.str == "|V2"


def test_checkpoint_restores_reference_and_uint16_bf16_files(tmp_path):
    """The port restores a bf16 leaf from the reference's file (2-byte
    voids under an ml_dtypes header) and from the ``uint16`` file that
    earlier versions of the port wrote, to the same bits."""
    import json
    import ml_dtypes
    w = _bf16_values()
    bits = w.view(torch.int16).numpy()
    files = {"ref": w.float().numpy().astype(ml_dtypes.bfloat16),
             "uint16": bits.view(np.uint16)}
    for step, (name, arr) in enumerate(files.items(), start=1):
        d = tmp_path / f"step_{step:08d}"
        d.mkdir()
        np.save(d / "w.npy", arr)
        (d / "manifest.json").write_text(json.dumps({
            "step": step, "extra": {}, "leaves": {"w": {
                "file": "w.npy", "shape": list(w.shape),
                "dtype": "bfloat16"}}}))
        _, got, _ = CheckpointManager(tmp_path).restore(
            {"w": torch.zeros_like(w)}, step=step, device="cpu")
        assert got["w"].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                      bits, err_msg=name)


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"a": torch.zeros((8,))}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, {"a": state["a"] + s})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    _, got, _ = mgr.restore(state, step=4, device="cpu")
    assert torch.equal(got["a"], state["a"] + 4)
    with pytest.raises(KeyError):
        mgr.restore({"missing": torch.zeros(1)}, device="cpu")


@pytest.mark.parametrize("seq", [16, 1024])
def test_trainer_crash_resume_bitwise(tmp_path, seq):
    """Failure injection and restore reproduce the uninterrupted run
    exactly (deterministic data and checkpointed state).  At 1024 tokens
    attention takes the flash path, and the step runs with the default
    number of CPU threads: the whole step must be reproducible, not only
    the checkpoint."""
    cfg = smoke(get("llama3.2-3b"))
    t1 = Trainer(cfg, global_batch=4, seq_len=seq, ckpt_dir=tmp_path / "a",
                 device="cpu")
    log1 = t1.run(6, ckpt_every=2)
    t2 = Trainer(cfg, global_batch=4, seq_len=seq, ckpt_dir=tmp_path / "b",
                 device="cpu")
    crashed = []

    def inject(step):
        if step == 4 and not crashed:
            crashed.append(1)
            raise _InjectedFailure("simulated node loss")

    log2 = t2.run(6, ckpt_every=2, failure_injector=inject)
    assert crashed
    l1 = {m["step"]: m["loss"] for m in log1}
    l2 = {m["step"]: m["loss"] for m in log2}
    for s in range(6):
        assert l1[s] == l2[s], s
    for a, b in zip(tree_leaves(t1.params), tree_leaves(t2.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(t1.opt_state), tree_leaves(t2.opt_state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-large-v3"])
def test_trainer_crash_resume_bitwise_moe_and_encdec(tmp_path, arch):
    """The same for the MoE family (the routing and the expert dispatch in
    the step) and the encoder-decoder (the data pipeline's frames ride
    along with every batch)."""
    cfg = smoke(get(arch))
    t1 = Trainer(cfg, global_batch=2, seq_len=16, ckpt_dir=tmp_path / "a",
                 device="cpu")
    log1 = t1.run(4, ckpt_every=2)
    t2 = Trainer(cfg, global_batch=2, seq_len=16, ckpt_dir=tmp_path / "b",
                 device="cpu")
    crashed = []

    def inject(step):
        if step == 3 and not crashed:
            crashed.append(1)
            raise _InjectedFailure("simulated node loss")

    log2 = t2.run(4, ckpt_every=2, failure_injector=inject)
    assert crashed
    l1 = {m["step"]: m["loss"] for m in log1}
    l2 = {m["step"]: m["loss"] for m in log2}
    assert len(log2) > len(log1) and l1 == l2
    for a, b in zip(tree_leaves(t1.params), tree_leaves(t2.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(t1.opt_state), tree_leaves(t2.opt_state)):
        assert torch.equal(a, b)


def test_value_and_grad_is_bitwise_reproducible_at_1024_tokens():
    """Two equal gradient computations on the smoke Llama at 4 x 1024
    tokens, with the default number of CPU threads, give the same bits in
    every leaf.  The embedding's backward was the one that did not: plain
    indexing's backward is an accumulating ``index_put_`` that adds in
    parallel in no fixed order above its grain size (``embed`` differed by
    up to 9.3e-10 of a largest 8.4e-3, the other leaves were equal)."""
    cfg = smoke(get("llama3.2-3b"))
    params = init_params(cfg, 0, "cpu")
    loss_fn = build_forward(cfg, "loss")
    batch = {k: torch.from_numpy(v) for k, v in
             TokenDataset(cfg.vocab, 1024, 4, seed=3).batch_at(0).items()}
    (l1, g1), (l2, g2) = (
        _value_and_grad(lambda p, b: loss_fn(p, b, cfg), params, batch)
        for _ in range(2))
    assert torch.equal(l1, l2)
    leaves1, leaves2 = tree_leaves(g1), tree_leaves(g2)
    assert len(leaves1) == 11
    for i, (a, b) in enumerate(zip(leaves1, leaves2)):
        assert torch.equal(a, b), (i, float((a - b).abs().max()))


def test_trainer_microbatching_equivalence(tmp_path):
    """Two microbatches of 2 against one batch of 4: the mean of the two
    means is the batch mean, so the losses agree to f32 rounding (1e-5
    relative; the reference's test allows 2e-2)."""
    cfg = smoke(get("llama3.2-3b"))
    t1 = Trainer(cfg, global_batch=4, seq_len=16, ckpt_dir=tmp_path / "mb1",
                 device="cpu")
    t2 = Trainer(cfg, global_batch=4, seq_len=16, ckpt_dir=tmp_path / "mb2",
                 options=TrainOptions(num_microbatches=2), device="cpu")
    for a, b in zip(t1.run(3), t2.run(3)):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)


def test_mesh_paths_wait_for_the_mesh_slice(tmp_path):
    """What still raises ``NotImplementedError`` naming item 12: the
    config and mesh pairs the sharded execution does not run (3 heads of
    18 on a ``model`` axis of 4, whose flat columns do not split over it;
    a Mamba2 variant with 2 SSM heads on a ``model`` axis of 4); a mesh
    given as a plain geometry, not a DeviceMesh, raises ``TypeError``
    after the sharding check, which Llama on 2 × 2 passes since the
    tensor-parallel slice and Mixtral's experts on 1 × 4, DeepSeek's
    routing and override on dp 4, Whisper on a ``model`` axis of 2, 4
    heads on a ``model`` axis of 8 (the ``"batch"`` or ``"cp"`` mode) and a
    config that routes experts on a data size over 1 since the MoE slice
    (``tests/test_torch_tp.py`` and ``tests/test_torch_tp_families.py``
    run them on four processes).  What runs since
    the data-parallel slice: ``grad_compression="int8"`` is ignored by
    ``make_train_step``, as the reference ignores it (the same loss bits),
    and on a one-process gloo group the manual int8 DP step trains and
    ``Trainer.reshard`` moves a trainer between a mesh and no mesh."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_dp_mesh, make_test_mesh
    from repro_torch.train import loop
    from repro_torch.train.compression import init_error_state
    cfg = smoke(get("llama3.2-3b"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(cfg, mesh={"data": 2, "model": 2}, device="cpu")
    mamba = dataclasses.replace(smoke(get("mamba2-2.7b")), ssm_head_dim=64)
    odd = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1, head_dim=18)
    for c, sizes, what in (
            (odd, {"data": 1, "model": 4}, "column blocks"),
            (mamba, {"data": 1, "model": 4}, "SSM heads")):
        with pytest.raises(NotImplementedError, match="item 12") as e:
            make_train_step(c, sizes, device="cpu")
        assert what in str(e.value), (c.name, str(e.value))
    for arch, sizes in (("deepseek-moe-16b", {"data": 4}),
                        ("mixtral-8x22b", {"data": 1, "model": 4}),
                        ("whisper-large-v3", {"data": 1, "model": 2}),
                        ("llama3.2-3b", {"data": 1, "model": 8})):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make_train_step(smoke(get(arch)), sizes, device="cpu")
    moe = dataclasses.replace(smoke(get("mixtral-8x22b")), rules_overrides=())
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(moe, {"data": 2}, ckpt_dir=tmp_path, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(cfg, mesh={"data": 4}, device="cpu")
    with pytest.raises(TypeError, match="not a mesh"):
        loop.make_manual_dp_train_step(cfg, object())
    batch = TokenDataset(cfg.vocab, 8, 2, seed=1).batch_at(0)
    losses = []
    for opt in ("none", "int8"):
        step = make_train_step(cfg, options=TrainOptions(
            grad_compression=opt), device="cpu")
        params = init_params(cfg, 0, "cpu")
        losses.append(float(step(params, O.adamw_init(params),
                                 batch)[2]["loss"]))
    assert losses[0] == losses[1]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        params = init_params(cfg, 0, "cpu")
        step = loop.make_manual_dp_train_step(cfg, make_dp_mesh(1))
        opt, err = O.adamw_init(params), init_error_state(params)
        got = [float(step(params, opt, err, batch)[3]["loss"])
               for _ in range(3)]
        assert got[0] == losses[0] and got[2] < got[0]
        assert any(float(e.abs().max()) > 0 for e in tree_leaves(err))
        t = Trainer(cfg, make_test_mesh(1, 1), global_batch=2, seq_len=8,
                    ckpt_dir=tmp_path / "t", device="cpu")
        t.run(1)
        t.reshard(None)
        assert t.active and t.mesh is None and t.step == 1
        t.run(1)
        t.reshard(make_dp_mesh(1))
        t.run(1)
        assert t.step == 3 and len(t.metrics_log) == 3
    finally:
        dist.destroy_process_group()
