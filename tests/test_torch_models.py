"""The port's model modules against the JAX reference's, on the same inputs
and weights (carried across with ``params_from_numpy``): norms, RoPE,
prefill attention (flash dispatch and ``_sdpa``), decode attention
(absolute and ring caches), the chunked SSD and the Mamba2 mixer, the
chunked SSD against the literal recurrence, and the weight carry-across
and init rules (the MoE and encoder-decoder trees too; ``moe_apply`` is in
``test_torch_moe.py``, cross-attention in ``test_torch_encdec.py``).  All
in f32 on the CPU."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get, smoke as jax_smoke
from repro.models import attention as JA
from repro.models import ssm as JS
from repro.models.layers import rms_norm as jax_rms_norm, rope as jax_rope
from repro.models.model import (
    init_abstract as jax_init_abstract, init_params as jax_init_params,
)
from repro_torch.configs import get, smoke
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.layers import (
    Param, init_tree, rms_norm, rope, tree_leaves, tree_map,
)
from repro_torch.models.model import init_params, params_from_numpy

#: f32 against f32, rounding-level differences of other libraries (matmul
#: and reduction orders, exp, sin/cos); every case also checks that its
#: output is O(1)
ATOL = 2e-5
ARCHS = ["llama3.2-3b", "mamba2-2.7b", "gemma3-4b"]
#: the MoE family and the encoder-decoder
ZOO_ARCHS = ["deepseek-moe-16b", "mixtral-8x22b", "jamba-v0.1-52b",
             "whisper-large-v3"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got: torch.Tensor, want, atol: float = ATOL) -> None:
    want = np.asarray(want, np.float32)
    assert np.abs(want).max() > 0.1, "output too small to compare"
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2, 12, 4, 16)).astype(np.float32)
    w = rng.normal(0, 0.1, (16,)).astype(np.float32)
    _close(rms_norm(_t(x), _t(w)), jax_rms_norm(jnp.asarray(x), jnp.asarray(w)),
           1e-6)
    pos = np.broadcast_to(np.arange(100, 112), (2, 12)).astype(np.int32)
    for theta in (1e4, 5e5):
        _close(rope(_t(x), _t(pos), theta),
               jax_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-5)


def _attn_weights(seed, d, h, g, hd, qk_norm):
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


@pytest.mark.parametrize("s,window,qk_norm", [
    (1024, None, False),     # flash dispatch (s >= FLASH_MIN_SEQ)
    (1024, 16, True),        # flash with a sliding window
    (64, None, False),       # _sdpa
    (64, 16, True),
])
def test_attention_matches_reference(s, window, qk_norm):
    d, h, g, hd, b = 64, 4, 2, 16, 2
    jp, tp = _attn_weights(s, d, h, g, hd, qk_norm)
    x = np.random.RandomState(1).normal(0, 1, (b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    kw = dict(n_heads=h, n_kv=g, head_dim=hd, theta=1e4, window=window)
    want, (wk, wv) = JA.attention(jp, jnp.asarray(x), jnp.asarray(pos), **kw)
    got, (gk, gv) = A.attention(tp, _t(x), _t(pos), **kw)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("cache_len,window", [
    (24, None),     # absolute cache
    (24, 12),       # absolute cache, windowed mask
    (8, 8),         # ring buffer: slot = pos % window
])
def test_decode_attention_matches_reference(cache_len, window):
    d, h, g, hd, b = 64, 4, 2, 16, 2
    jp, tp = _attn_weights(7, d, h, g, hd, True)
    rng = np.random.RandomState(2)
    kw = dict(n_heads=h, n_kv=g, head_dim=hd, theta=1e4, window=window)
    jc = JA.init_cache(b, cache_len, g, hd, jnp.float32)
    tc = A.init_cache(b, cache_len, g, hd, torch.float32, "cpu")
    for pos in range(20):
        x = rng.normal(0, 1, (b, 1, d)).astype(np.float32)
        want, jc = JA.decode_attention(jp, jnp.asarray(x), jc, jnp.int32(pos),
                                       **kw)
        got, tc = A.decode_attention(tp, _t(x), tc, pos, **kw)
        _close(got, want)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


def _ssd_inputs(seed, b, l, h, p, n, g):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (b, l, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.1, (b, l, h)).astype(np.float32),
            -rng.uniform(0.1, 1.0, (h,)).astype(np.float32),
            rng.normal(0, 1, (b, l, g, n)).astype(np.float32),
            rng.normal(0, 1, (b, l, g, n)).astype(np.float32))


@pytest.mark.parametrize("l,chunk,g", [(64, 16, 1), (32, 8, 2), (24, 24, 1)])
def test_ssd_chunked_matches_reference(l, chunk, g):
    ins = _ssd_inputs(l, 2, l, 4, 16, 16, g)
    want, wfin = JS.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk,
                                return_final=True)
    got, gfin = S.ssd_chunked(*(_t(a) for a in ins), chunk, return_final=True)
    _close(got, want, 1e-4)
    _close(gfin, wfin, 1e-4)


def test_ssm_apply_and_decode_match_reference():
    cfg = smoke(get("mamba2-2.7b"))
    jcfg = jax_smoke(jax_get("mamba2-2.7b"))
    jparams = jax_init_params(jcfg, 3)
    jp = jax.tree.map(lambda a: a[0], jparams["unit"][0]["mixer"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    # non-trivial a_log, dt_bias and norm weights (their init is 0)
    rng = np.random.RandomState(4)
    for k in ("a_log", "dt_bias", "norm_w"):
        v = rng.normal(0, 0.5, np.shape(jp[k])).astype(np.float32)
        jp[k], tp[k] = jnp.asarray(v), _t(v)
    kw = dict(head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
              n_groups=cfg.ssm_groups, expand=cfg.ssm_expand)
    x = rng.normal(0, 1, (2, 32, cfg.d_model)).astype(np.float32)
    want, wc = JS.ssm_apply(jp, jnp.asarray(x), chunk=cfg.ssm_chunk,
                            return_cache=True, **kw)
    got, gc = S.ssm_apply(tp, _t(x), chunk=cfg.ssm_chunk, return_cache=True,
                          **kw)
    _close(got, want, 1e-4)
    _close(gc["state"], wc["state"], 1e-4)
    _close(gc["conv"], wc["conv"], 1e-5)
    for step in range(3):
        xs = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
        want, wc = JS.ssm_decode(jp, jnp.asarray(xs), wc, **kw)
        got, gc = S.ssm_decode(tp, _t(xs), gc, **kw)
        _close(got, want, 1e-4)
    _close(gc["state"], wc["state"], 1e-4)


def _recurrence(x, dt, a, bm, cm):
    """The literal state-space recurrence in float64 (state (b,h,p,n))."""
    b, l, h, p = x.shape
    state = np.zeros((b, h, p, bm.shape[-1]))
    ys = []
    for i in range(l):
        da = np.exp(dt[:, i] * a)
        state = state * da[..., None, None] + \
            (dt[:, i][..., None] * x[:, i])[..., None] * bm[:, i][:, :, None, :]
        ys.append(np.einsum("bhpn,bhn->bhp", state, cm[:, i]))
    return np.stack(ys, axis=1), state


def test_ssd_chunked_vs_sequential_recurrence():
    """Chunked SSD (dual form) == literal state-space recurrence (the
    port's counterpart of tests/test_kernels.py:60-82)."""
    x, dt, a, bm, cm = _ssd_inputs(0, 1, 64, 4, 16, 16, 1)
    y = S.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), chunk=16).numpy()
    want, _ = _recurrence(x, dt, a, bm, cm)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(y, want, atol=1e-3)


def test_ssd_prefill_state_matches_decode():
    """Prefill's returned SSM state == the state after the recurrence
    (tests/test_kernels.py:85-97)."""
    x, dt, a, bm, cm = _ssd_inputs(1, 1, 32, 2, 8, 8, 1)
    _, final = S.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), chunk=8,
                             return_final=True)
    _, state = _recurrence(x, dt, a, bm, cm)
    np.testing.assert_allclose(final.numpy(), state, atol=1e-4)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _configs(arch, dtype):
    jc, tc = jax_smoke(jax_get(arch)), smoke(get(arch))
    return (dataclasses.replace(jc, dtype=dtype),
            dataclasses.replace(tc, dtype=dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + ZOO_ARCHS)
def test_params_from_numpy_is_bit_identical(arch, dtype):
    jc, _ = _configs(arch, dtype)
    jp = jax.tree.map(np.asarray, jax_init_params(jc, 5))
    tp = params_from_numpy(jp, "cpu")
    want, got = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(want) == len(got)
    n_bf16 = 0
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        if w.dtype.name == "bfloat16":
            n_bf16 += 1
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    assert (n_bf16 > 0) == (dtype == "bfloat16")


def _abstract(tree):
    """(shape, dtype name) leaves of the reference's abstract tree."""
    return [(tuple(s.shape), np.dtype(s.dtype).name)
            for s in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS + ZOO_ARCHS)
def test_init_params_has_the_reference_structure(arch):
    """Smoke config, drawn on the CPU; full config on the meta device (no
    memory): the reference's leaves in the reference's order, with its
    shapes and dtypes."""
    for jc, tc, dev in ((jax_smoke(jax_get(arch)), smoke(get(arch)), "cpu"),
                        (jax_get(arch), get(arch), "meta")):
        got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for t in tree_leaves(init_params(tc, 0, dev))]
        assert got == _abstract(jax_init_abstract(jc))


def test_init_params_follows_the_materialize_rule():
    cfg = smoke(get("llama3.2-3b"))
    p = init_params(cfg, 0, "cpu")
    assert torch.equal(p["final_norm"], torch.zeros(cfg.d_model))
    wq = p["unit"][0]["attn"]["wq"]            # (n_units, d, h * hd)
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    again = init_params(cfg, 0, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))
    other = init_params(cfg, 1, "cpu")
    assert not torch.equal(p["embed"], other["embed"])
    # a leaf of at most one dim is ones times its scale; stacked leaves
    # have two dims and are drawn, as in the reference
    one = init_tree({"w": Param((3,), ("embed",), scale=2.0,
                                dtype="bfloat16")}, 0, "cpu")["w"]
    assert one.dtype == torch.bfloat16 and torch.equal(one.float(),
                                                       torch.full((3,), 2.0))
    assert tree_map(lambda t: t.device.type, p)["embed"] == "cpu"


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError):
        init_params(smoke(get(arch)), 0, "cpu")
