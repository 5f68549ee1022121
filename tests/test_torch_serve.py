"""Slice 2 of the port as a whole: ``ServeEngine.generate`` (prefill →
caches → greedy decode) against the JAX reference's, on the same weights
(carried across with ``params_from_numpy``) and the same prompts.

The configs are the reference's smoke configs of Llama 3.2 3B (a
1024-token prompt, so prefill attention takes the flash path), Mamba2 2.7B
(the chunked SSD with its diagonal-block kernel) and Gemma 3 4B (sliding
windows, qk-norm, ring caches); of the MoE family, DeepSeek-MoE 16B
(shared experts), Mixtral 8x22B (windows) and Jamba (SSM and attention
layers, MoE on every other one); and Whisper large-v3 (the
encoder-decoder: ``generate`` feeds the reference engine's zero audio
frames, the logits tests random ones).  They run in f32 on the CPU, where
the port takes its kernels' plain versions.  The smoke configs' capacity
factor (8) drops no token; ``tests/test_torch_moe.py`` holds the drops.
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
    init_cache as jax_init_cache, init_params as jax_init_params,
)
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get, smoke
from repro_torch.models.layers import tree_map
from repro_torch.models.model import (
    build_forward, init_cache, params_from_numpy,
)
from repro_torch.serve.engine import ServeEngine
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

#: prompt length per config: Llama's reaches FLASH_MIN_SEQ; Gemma's is
#: longer than its smoke window (16), so local layers prefill into rings
PROMPTS = {"llama3.2-3b": 1024, "mamba2-2.7b": 64, "gemma3-4b": 40,
           "deepseek-moe-16b": 64, "mixtral-8x22b": 40,
           "jamba-v0.1-52b": 64, "whisper-large-v3": 24}
N_NEW = 6
BATCH = 2
#: f32 logits, port against reference: the two sum in other orders (f32
#: matmuls, cumsum, exp) through two layers; measured at most 1.55e-6 on
#: logits up to 2.1, so 1e-4 leaves room and still fails any slip in the
#: algorithm (a wrong mask or position moves them by O(0.1))
F32_ATOL = 1e-4
#: bf16 logits: the two round at other places (both round P to bf16 in
#: flash attention, but the reference also rounds each 1024-key block's P·V
#: to bf16, and its SSD path rounds C·Bᵀ to bf16, where the port keeps both
#: in f32), each rounding a relative 2^-8, carried through two layers; held
#: as a share of max|logits| (measured at most 0.91% for Llama and 1.35%
#: for Mamba2)
BF16_RTOL = 2.0 ** -4


def _configs(arch: str, dtype: str | None = None):
    jc, tc = jax_smoke(jax_get(arch)), smoke(get(arch))
    if dtype is not None:
        jc = dataclasses.replace(jc, dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _setup(arch: str, dtype: str | None = None, seed: int = 0):
    """The configs, the reference's weights in both packages and the
    prompts; kept for the module, as every test reads them and none
    writes them."""
    jc, tc = _configs(arch, dtype)
    jp = jax_init_params(jc, seed)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.RandomState(seed + 1).randint(
        0, jc.vocab, (BATCH, PROMPTS[arch])).astype(np.int32)
    return jc, tc, jp, tp, prompts


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _frames(cfg, b: int, seed: int = 5) -> np.ndarray | None:
    """Random audio frames for an encoder-decoder's prefill (None for the
    other families)."""
    if not cfg.n_audio_frames:
        return None
    return np.random.RandomState(seed).normal(
        0, 1, (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def _batch(tokens, frames, to):
    out = {"tokens": tokens}
    if frames is not None:
        out["audio_frames"] = to(frames)
    return out


@functools.lru_cache(maxsize=None)
def _jax_engine(arch: str, dtype: str | None = None) -> JaxServeEngine:
    """The reference's engine for a config, kept for the module: its jitted
    prefill and decode also run :func:`_jax_trace`, so each compiles once
    for a shape."""
    jc, _, jp, _, prompts = _setup(arch, dtype)
    return JaxServeEngine(jc, jp, max_len=prompts.shape[1] + N_NEW)


@pytest.mark.parametrize("arch", list(PROMPTS))
def test_generate_gives_the_reference_tokens(arch):
    jc, tc, jp, tp, prompts = _setup(arch)
    plen = prompts.shape[1]
    want = _jax_engine(arch).generate(prompts, N_NEW)
    got = ServeEngine(tc, tp, device="cpu", max_len=plen + N_NEW).generate(
        prompts, N_NEW)
    assert got.tokens.shape == (BATCH, N_NEW)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prefill_sec > 0 and got.tokens_per_sec > 0


def _logits_trace(prefill, decode, init, params, prompts, n_steps, to_np,
                  tok_of):
    """Prefill logits and every greedy decode step's logits."""
    b, plen = prompts.shape
    logits, pre = prefill(params, prompts)
    cache = init(b, plen + n_steps, pre)
    out = [to_np(logits)]
    for i in range(n_steps):
        tok = tok_of(logits)
        logits, cache = decode(params, cache, tok, plen + i)
        out.append(to_np(logits))
    return out


def _jax_trace(jc, jp, prompts, n_steps, engine):
    """The reference's prefill and greedy decode logits, through
    ``engine``'s jitted steps."""
    frames = _frames(jc, prompts.shape[0])

    def prefill(p, t):
        return engine._prefill(p, _batch(t, frames, jnp.asarray))

    def decode(p, c, t, pos):
        return engine._decode(p, c, {"tokens": t}, pos)

    def init(b, n, pre):
        return jax.tree.map(JaxServeEngine._embed_cache,
                            jax_init_cache(jc, b, n), pre)

    return _logits_trace(
        lambda p, x: prefill(p, jnp.asarray(x)),
        lambda p, c, t, pos: decode(p, c, t, jnp.int32(pos)), init, jp,
        prompts, n_steps, lambda x: np.asarray(x, np.float32),
        lambda lg: jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None])


def _port_trace(tc, tp, prompts, n_steps):
    frames = _frames(tc, prompts.shape[0])
    prefill = build_forward(tc, "prefill")
    decode = build_forward(tc, "decode")

    def init(b, n, pre):
        return tree_map(ServeEngine._embed_cache,
                        init_cache(tc, b, n, "cpu"), pre)

    return _logits_trace(
        lambda p, x: prefill(p, _batch(torch.from_numpy(x), frames,
                                       torch.from_numpy), tc),
        lambda p, c, t, pos: decode(p, c, {"tokens": t}, pos, tc), init, tp,
        prompts, n_steps, _np,
        lambda lg: torch.argmax(lg, dim=-1).to(torch.int32)[:, None])


@pytest.mark.parametrize("arch", list(PROMPTS))
def test_prefill_and_decode_logits_match_reference(arch):
    jc, tc, jp, tp, prompts = _setup(arch)
    want = _jax_trace(jc, jp, prompts, N_NEW, _jax_engine(arch))
    got = _port_trace(tc, tp, prompts, N_NEW)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (BATCH, jc.padded_vocab)
        assert np.abs(w).max() > 0.5, "logits too small to compare"
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_ATOL,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_bf16_logits_match_reference(arch):
    """The smoke configs in bf16, the dtype of the full configs on the card
    (Llama's 1024-token prompt through flash, Mamba2's through the SSD)."""
    jc, tc, jp, tp, prompts = _setup(arch, "bfloat16")
    want = _jax_trace(jc, jp, prompts, 3, _jax_engine(arch, "bfloat16"))
    got = _port_trace(tc, tp, prompts, 3)
    for step, (g, w) in enumerate(zip(got, want)):
        top = np.abs(w).max()
        assert top > 0.5, "logits too small to compare"
        err = np.abs(g - w).max()
        print(f"{arch} bf16 step {step}: max|port - reference| = {err:.4g}, "
              f"max|reference| = {top:.4g} ({100 * err / top:.2f}%)")
        assert err <= BF16_RTOL * top, (step, err, top)


@pytest.mark.parametrize("arch", list(PROMPTS))
def test_prefill_decode_consistency(arch):
    """Greedy next token from prefill == decode-step replay of the prompt
    from an empty cache (the port's counterpart of tests/test_models.py::
    test_smoke_prefill_decode_consistency), and a prefill of part of the
    prompt continued by decode steps gives the full prefill's logits.  An
    encoder-decoder's replay from an empty cache holds zero cross K/V, which
    is what zero audio frames (the serve engine's) give; the split prefill
    carries random frames' cross K/V into the decode steps."""
    cfg = smoke(get(arch))
    _, _, _, params, prompts = _setup(arch)
    b, s = BATCH, 8
    toks = torch.from_numpy(prompts[:, :s])
    prefill = build_forward(cfg, "prefill")
    decode = build_forward(cfg, "decode")
    zeros = _frames(cfg, b)
    zeros = None if zeros is None else np.zeros_like(zeros)
    logits_p, _ = prefill(params, _batch(toks, zeros, torch.from_numpy), cfg)
    cache = init_cache(cfg, b, 32, "cpu")
    for i in range(s):
        logits_d, cache = decode(params, cache, {"tokens": toks[:, i:i + 1]},
                                 i, cfg)
    np.testing.assert_allclose(_np(logits_d), _np(logits_p), rtol=0,
                               atol=F32_ATOL)

    full = torch.from_numpy(prompts)
    split = prompts.shape[1] // 2
    frames = _frames(cfg, b)
    want, _ = prefill(params, _batch(full, frames, torch.from_numpy), cfg)
    logits, pre = prefill(params, _batch(full[:, :split], frames,
                                         torch.from_numpy), cfg)
    cache = tree_map(ServeEngine._embed_cache,
                     init_cache(cfg, b, prompts.shape[1], "cpu"), pre)
    for i in range(split, prompts.shape[1]):
        logits, cache = decode(params, cache, {"tokens": full[:, i:i + 1]}, i,
                               cfg)
    np.testing.assert_allclose(_np(logits), _np(want), rtol=0, atol=F32_ATOL)
