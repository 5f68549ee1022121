"""The VLM (llama-3.2-vision-90b) in the port against the JAX reference.

The reference's smoke config of Llama 3.2 Vision 90B: four ``s`` layers
(global causal self-attention) and one ``x`` layer (self-attention, then
cross-attention to 8 vision tokens), f32, weights carried across with
``params_from_numpy``.  ``ServeEngine.generate`` feeds zero vision
embeddings, as the reference's engine does; with zeros every
cross-attention output is 0, so the logits tests also feed seeded N(0, 1)
``vision_embeds`` (the data pipeline's draw), which the prefill's cross K/V
cache carries into the decode steps.  A 1024-token prompt sends the
self-attention and the ``x`` layer's cross-attention (1024 queries against
8 keys, unmasked) through the flash path.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get, smoke as jax_smoke
from repro.models.model import (
    build_forward as jax_build_forward, init_cache as jax_init_cache,
    init_params as jax_init_params,
)
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get, smoke
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import (
    build_forward, init_abstract, init_cache, init_params, params_from_numpy,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.data import TokenDataset
from repro_torch.train.loop import _value_and_grad
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "llama-3.2-vision-90b"
#: prompt lengths: a short one through the direct attention, and
#: FLASH_MIN_SEQ, where both attentions take the flash path
SEQS = (16, 1024)
BATCH = 2
N_NEW = 6
#: f32 logits, port against reference (tests/test_torch_serve.py: sums in
#: other orders through a few layers; a wrong mask, position or cache slot
#: moves them by O(0.1))
F32_ATOL = 1e-4
#: loss and gradient leaves (tests/test_torch_train.py)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _setup(seed: int = 0):
    """The configs and the reference's weights in both packages, kept for
    the module: every test reads them and none writes them."""
    jc, tc = jax_smoke(jax_get(ARCH)), smoke(get(ARCH))
    jp = jax_init_params(jc, seed)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _prompts(cfg, seq: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, (BATCH, seq)).astype(np.int32)


def _vision(cfg, b: int = BATCH, seed: int = 5) -> np.ndarray:
    """Seeded N(0, 1) vision embeddings, as ``TokenDataset.extras`` draws."""
    return np.random.RandomState(seed).normal(
        0, 1, (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def test_config_is_the_vlm():
    cfg = smoke(get(ARCH))
    assert cfg.family == "vlm" and cfg.n_vision_tokens == 8
    assert set(cfg.layer_kinds()) == {"s", "x"}
    assert cfg.layer_kinds().count("x") == 1


def test_params_from_numpy_carries_every_leaf():
    """Every leaf of the reference's tree, the cross-attention's ``xattn``
    and ``ln_x`` and the ``vision_norm`` among them, arrives value for
    value, in the port's tree of the same structure."""
    jc, tc, jp, tp = _setup()
    want = jax.tree.map(np.asarray, jp)
    got = tree_map(_np, tp)
    assert set(got) == set(want) and "vision_norm" in got
    assert {"xattn", "ln_x"} <= set(got["unit"][4])
    assert "xattn" not in got["unit"][0]
    wl, gl = jax.tree.leaves(want), tree_leaves(got)
    assert len(wl) == len(gl) == len(tree_leaves(init_params(tc, 0, "cpu")))
    for w, g in zip(wl, gl):
        assert w.shape == g.shape
        np.testing.assert_array_equal(g, w.astype(np.float32))


def test_full_config_builds_on_meta():
    """The published config no longer raises: its 100 layers as meta
    tensors, 89.6 B parameters (20 units of four ``s`` and one ``x``)."""
    cfg = get(ARCH)
    params = init_abstract(cfg)
    n = sum(t.numel() for t in tree_leaves(params))
    assert params["vision_norm"].shape == (cfg.d_model,)
    assert params["unit"][4]["xattn"]["wq"].shape == (20, 8192, 8192)
    assert 89.5e9 < n < 89.7e9, n
    cache = init_cache(cfg, 4, 2080, "meta")
    assert cache["unit"][4]["xk"].shape == (20, 4, 1601, 8, 128)
    assert cache["unit"][4]["self"].k.shape == (20, 4, 2080, 8, 128)


@functools.lru_cache(maxsize=None)
def _jax_engine(seq: int) -> JaxServeEngine:
    """The reference's engine at a prompt length, kept for the module: its
    jitted prefill and decode also run :func:`_jax_trace`, so each
    compiles once for a shape."""
    jc, _, jp, _ = _setup()
    return JaxServeEngine(jc, jp, max_len=seq + N_NEW)


@pytest.mark.parametrize("seq", SEQS)
def test_generate_gives_the_reference_tokens(seq):
    jc, tc, jp, tp = _setup()
    prompts = _prompts(jc, seq)
    want = _jax_engine(seq).generate(prompts, N_NEW)
    got = ServeEngine(tc, tp, device="cpu", max_len=seq + N_NEW).generate(
        prompts, N_NEW)
    assert got.tokens.shape == (BATCH, N_NEW)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def _jax_trace(jc, jp, prompts, vision, n_steps):
    """The reference's prefill and greedy decode logits, through its
    engine's jitted steps (:func:`_jax_engine`)."""
    b, plen = prompts.shape
    engine = _jax_engine(plen)
    logits, pre = engine._prefill(jp, {"tokens": jnp.asarray(prompts),
                                       "vision_embeds": jnp.asarray(vision)})
    cache = jax.tree.map(JaxServeEngine._embed_cache,
                         jax_init_cache(jc, b, plen + n_steps), pre)
    out = [np.asarray(logits, np.float32)]
    for i in range(n_steps):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        logits, cache = engine._decode(jp, cache, {"tokens": tok},
                                       jnp.int32(plen + i))
        out.append(np.asarray(logits, np.float32))
    return out


def _port_trace(tc, tp, prompts, vision, n_steps):
    b, plen = prompts.shape
    prefill, decode = build_forward(tc, "prefill"), build_forward(tc, "decode")
    logits, pre = prefill(tp, {"tokens": torch.from_numpy(prompts),
                               "vision_embeds": torch.from_numpy(vision)}, tc)
    cache = tree_map(ServeEngine._embed_cache,
                     init_cache(tc, b, plen + n_steps, "cpu"), pre)
    out = [_np(logits)]
    for i in range(n_steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        logits, cache = decode(tp, cache, {"tokens": tok}, plen + i, tc)
        out.append(_np(logits))
    return out


@pytest.mark.parametrize("seq", SEQS)
def test_prefill_and_decode_logits_match_reference(seq):
    """Random vision embeddings: the prefill's logits (through the ``x``
    layer's cross-attention) and each greedy decode step's (through the
    cached cross K/V) within F32_ATOL of the reference's."""
    jc, tc, jp, tp = _setup()
    prompts, vision = _prompts(jc, seq), _vision(jc)
    want = _jax_trace(jc, jp, prompts, vision, N_NEW)
    got = _port_trace(tc, tp, prompts, vision, N_NEW)
    zero = _port_trace(tc, tp, prompts, np.zeros_like(vision), 0)
    assert np.abs(zero[0] - got[0]).max() > 10 * F32_ATOL, \
        "the vision states must move the logits"
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (BATCH, jc.padded_vocab)
        assert np.abs(w).max() > 0.5, "logits too small to compare"
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_ATOL,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("seq", SEQS)
def test_lm_loss_and_grads_match_reference(seq):
    """The loss with the data pipeline's vision embeddings within
    LOSS_RTOL, and every gradient leaf (``vision_norm``, ``xattn`` and
    ``ln_x`` among them) within GRAD_RTOL of its largest value."""
    jc, tc, jp, tp = _setup()
    ds = TokenDataset(tc.vocab, seq, 1 if seq > 16 else BATCH, seed=3)
    data = {**ds.batch_at(0), **ds.extras(tc)}
    assert data["vision_embeds"].shape[1:] == (8, tc.d_model)
    want, wgrads = jax.value_and_grad(jax_build_forward(jc, "loss"))(
        jp, {k: jnp.asarray(v) for k, v in data.items()}, jc)
    loss_fn = build_forward(tc, "loss")
    got, grads = _value_and_grad(lambda p, b: loss_fn(p, b, tc), tp,
                                 {k: torch.from_numpy(v)
                                  for k, v in data.items()})
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    wl, gl = jax.tree.leaves(wgrads), tree_leaves(grads)
    assert len(wl) == len(gl)
    assert float(np.abs(np.asarray(wgrads["vision_norm"])).max()) > 0
    for i, (g, w) in enumerate(zip(gl, wl)):
        w = np.asarray(w, np.float32)
        top = float(np.abs(w).max())
        err = float(np.abs(_np(g) - w).max())
        assert err <= GRAD_RTOL * top, f"leaf {i}: {err} > {GRAD_RTOL} * {top}"


def test_prefill_decode_consistency_with_random_vision():
    """A prefill of half the prompt continued by decode steps gives the
    full prefill's last logits, with random vision embeddings (a cross
    cache written from the wrong states, or not read, is off by O(1)); a
    replay of the prompt by decode steps from an empty cache gives the
    prefill's logits with zero embeddings (an empty cross cache is what
    zero embeddings give)."""
    cfg = smoke(get(ARCH))
    _, _, _, params = _setup()
    prompts = _prompts(cfg, 24)
    full = torch.from_numpy(prompts)
    vision = torch.from_numpy(_vision(cfg))
    prefill, decode = build_forward(cfg, "prefill"), build_forward(cfg, "decode")
    want, _ = prefill(params, {"tokens": full, "vision_embeds": vision}, cfg)
    split = 12
    logits, pre = prefill(params, {"tokens": full[:, :split],
                                   "vision_embeds": vision}, cfg)
    cache = tree_map(ServeEngine._embed_cache,
                     init_cache(cfg, BATCH, 24, "cpu"), pre)
    for i in range(split, 24):
        logits, cache = decode(params, cache, {"tokens": full[:, i:i + 1]}, i,
                               cfg)
    np.testing.assert_allclose(_np(logits), _np(want), rtol=0, atol=F32_ATOL)
    other, _ = prefill(params, {"tokens": full, "vision_embeds": vision * 0},
                       cfg)
    assert np.abs(_np(other) - _np(want)).max() > 10 * F32_ATOL

    cache = init_cache(cfg, BATCH, 32, "cpu")
    for i in range(8):
        logits, cache = decode(params, cache, {"tokens": full[:, i:i + 1]}, i,
                               cfg)
    want, _ = prefill(params, {"tokens": full[:, :8],
                               "vision_embeds": vision * 0}, cfg)
    np.testing.assert_allclose(_np(logits), _np(want), rtol=0, atol=F32_ATOL)


def test_vision_states_cast_to_the_config_dtype():
    """f32 embeddings (the data pipeline's) into a bf16 model are cast
    before the norm, as the encoder-decoder's frames are; without vision
    embeddings there are no vision states."""
    cfg = dataclasses.replace(smoke(get(ARCH)), dtype="bfloat16")
    params = init_params(cfg, 0, "cpu")
    v = torch.from_numpy(_vision(cfg))
    assert T.vision_states(params, {"tokens": None}, cfg) is None
    got = T.vision_states(params, {"vision_embeds": v}, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == v.shape
