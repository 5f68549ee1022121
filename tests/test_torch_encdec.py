"""Cross-attention and ``models/encdec.py`` against the JAX reference's, on
the same inputs and weights, on the CPU: ``cross_attention`` at a query of
``FLASH_MIN_SEQ`` tokens or more (the flash path without a mask, s != t,
where the port takes its kernel's plain version) and below it (``_sdpa``),
with the decode-time ``kv=`` cache; ``encode``; the decode cache's
structure; and the Whisper smoke config in bf16 with the data pipeline's
f32 frames, on which the reference's loss raises and the port casts the
frames to the config's dtype.
The smoke config's serve and train parity is in ``test_torch_serve.py``
and ``test_torch_train.py``.

Tolerances: f32 against f32 within 2e-5 absolute on O(1) outputs (other
summation orders); bf16 within 2^-4 of the largest value.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get, smoke as jax_smoke
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models.model import (
    abstract_cache as jax_abstract_cache, build_forward as jax_build_forward,
    init_params as jax_init_params,
)
from repro_torch.configs import get, smoke
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import attention as A
from repro_torch.models import encdec as E
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import (
    abstract_cache, build_forward, params_from_numpy,
)
from repro_torch.train.data import TokenDataset
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 2e-5
BF16_RTOL = 2.0 ** -4
ARCH = "whisper-large-v3"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got: torch.Tensor, want, atol: float = ATOL) -> None:
    want = np.asarray(want, np.float32)
    assert np.abs(want).max() > 0.1, "output too small to compare"
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def _weights(seed, d, h, g, hd, qk_norm):
    rng = np.random.RandomState(seed)
    p = {"wq": rng.normal(0, d ** -0.5, (d, h * hd)),
         "wk": rng.normal(0, d ** -0.5, (d, g * hd)),
         "wv": rng.normal(0, d ** -0.5, (d, g * hd)),
         "wo": rng.normal(0, (h * hd) ** -0.5, (h * hd, d))}
    if qk_norm:
        p["q_norm"] = rng.normal(0, 0.1, (hd,))
        p["k_norm"] = rng.normal(0, 0.1, (hd,))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


@pytest.mark.parametrize("s,t,qk_norm", [
    (1024, 300, False),      # flash, unmasked, s != t (s >= FLASH_MIN_SEQ)
    (1100, 1500, True),      # flash, both ragged, t > s
    (64, 300, False),        # _sdpa
    (64, 40, True),
])
def test_cross_attention_matches_reference(s, t, qk_norm):
    d, h, g, hd, b = 64, 4, 2, 16, 2
    jp, tp = _weights(s + t, d, h, g, hd, qk_norm)
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    enc = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    kw = dict(n_heads=h, n_kv=g, head_dim=hd)
    want = JA.cross_attention(jp, jnp.asarray(x), jnp.asarray(enc), **kw)
    fops.reset_counts()
    got = A.cross_attention(tp, _t(x), _t(enc), **kw)
    _close(got, want)
    # the CPU takes the plain version: nothing launches
    assert fops.LAUNCHES["flash_fwd"] == 0
    # the decode-time short-circuit with the projected K/V
    wk, wv = JA.cross_kv(jp, jnp.asarray(enc), g, hd)
    gk, gv = A.cross_kv(tp, _t(enc), g, hd)
    _close(gk, wk)
    _close(gv, wv)
    got = A.cross_attention(tp, _t(x[:, :1]), None, kv=(gk, gv), **kw)
    want = JA.cross_attention(jp, jnp.asarray(x[:, :1]), None, kv=(wk, wv),
                              **kw)
    _close(got, want)


def _setup(dtype: str | None = None, **overrides):
    jc, tc = jax_smoke(jax_get(ARCH)), smoke(get(ARCH))
    if dtype is not None:
        overrides["dtype"] = dtype
    jc = dataclasses.replace(jc, **overrides)
    tc = dataclasses.replace(tc, **overrides)
    jp = jax_init_params(jc, 0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("n_frames", [16, 1100])
def test_encode_matches_reference(n_frames):
    """The encoder on random frames: 16 (the smoke config's), and 1100,
    which sends its self-attention through the unmasked flash path."""
    jc, tc, jp, tp = _setup(n_audio_frames=n_frames)
    frames = np.random.RandomState(2).normal(
        0, 1, (2, n_frames, jc.d_model)).astype(np.float32)
    want = JE.encode(jp, jnp.asarray(frames), jc)
    got = E.encode(tp, _t(frames), tc)
    _close(got, want)


def test_decode_cache_has_the_reference_structure():
    """init_cache's leaves (self K/V at the context, cross K/V of the
    frames) in the reference's order, shapes and dtypes, at the smoke and
    the full width (meta)."""
    for jc, tc in ((jax_smoke(jax_get(ARCH)), smoke(get(ARCH))),
                   (jax_get(ARCH), get(ARCH))):
        want = [(tuple(a.shape), np.dtype(a.dtype).name)
                for a in jax.tree.leaves(jax_abstract_cache(jc, 4, 448))]
        got = [(tuple(a.shape), str(a.dtype).removeprefix("torch."))
               for a in tree_leaves(abstract_cache(tc, 4, 448))]
        assert got == want
        assert got[0] == ((tc.n_layers, 4, tc.n_audio_frames,
                           tc.n_kv_heads, tc.hd), tc.dtype)


def test_bf16_frames_are_cast_where_the_reference_raises():
    """The data pipeline's frames are f32 and the weights bf16.  jnp
    promotes the products to f32, and the reference's decoder scan raises
    (its carry turns from bf16 to f32 at the first cross-attention).  The
    port casts the frames to the config's dtype: its loss on f32 frames
    equals its loss on the frames cast to bf16 bit for bit, and that is
    the reference's loss on the bf16 frames within 2^-4 relative."""
    jc, tc, jp, tp = _setup("bfloat16")
    ds = TokenDataset(tc.vocab, 24, 2, seed=3)
    data = {**ds.batch_at(0), **ds.extras(tc)}
    assert data["audio_frames"].dtype == np.float32
    jloss = jax_build_forward(jc, "loss")
    with pytest.raises(TypeError, match="carry"):
        jloss(jp, {k: jnp.asarray(v) for k, v in data.items()}, jc)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    jb["audio_frames"] = jb["audio_frames"].astype(jnp.bfloat16)
    want = float(jloss(jp, jb, jc))
    loss = build_forward(tc, "loss")
    tb = {k: _t(v) for k, v in data.items()}
    got = loss(tp, tb, tc)
    tb["audio_frames"] = tb["audio_frames"].to(torch.bfloat16)
    assert torch.equal(got, loss(tp, tb, tc))
    assert abs(float(got) - want) <= BF16_RTOL * abs(want)
