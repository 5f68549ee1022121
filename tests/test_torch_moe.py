"""``models/moe.py`` against the JAX reference's ``moe_apply`` on the CPU,
at the published capacity factor 1.25, where experts overflow and picks
are dropped (the smoke configs' factor 8 never drops: their serve and
train parity is in ``test_torch_serve.py`` and ``test_torch_train.py``).

The reference's dispatch writes every dropped pick to its expert's last
slot with ``.at[].set`` on duplicate indices, and XLA on the CPU applies
the updates in order, so the kept pick in that slot is overwritten: an
over-full expert serves ``cap - 1`` tokens.  The port states that clobber
explicitly; these tests hold its output, aux loss, gradients and dispatch
maps to the reference's, including the emptied slot, top-k order on ties
and the decode step's capacity of 1.

Tolerances: f32 against f32 within 1e-5 of the largest output (other
summation orders); bf16 at DeepSeek's full width within 2^-4 of the
largest output (both round the expert products to bf16 at other places).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as M

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -4
#: share of tokens whose top-k choice differs between the two bf16 router
#: products at DeepSeek's width (both round the logits to bf16; a near-tie
#: may flip).  Measured 0 of 512 (1 logit in 4,700 differs by one bf16
#: step); 1% is 5 tokens.
ROUTING_FLIP_SHARE = 0.01


def _params(rng, d, e, f, n_shared=0, router_scale=1.0):
    p = {"router": (router_scale * rng.normal(0, 1, (d, e))).astype(
            np.float32),
         "wi": rng.normal(0, d ** -0.5, (e, d, f)).astype(np.float32),
         "wg": rng.normal(0, d ** -0.5, (e, d, f)).astype(np.float32),
         "wo": rng.normal(0, f ** -0.5, (e, f, d)).astype(np.float32)}
    if n_shared:
        p["shared"] = {
            "wi": rng.normal(0, d ** -0.5, (d, f * n_shared)).astype(
                np.float32),
            "wg": rng.normal(0, d ** -0.5, (d, f * n_shared)).astype(
                np.float32),
            "wo": rng.normal(0, f ** -0.5, (f * n_shared, d)).astype(
                np.float32)}
    return p


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _both(p, x, k, cf=1.25):
    jy, jaux = JM.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), k,
                            cf)
    ty, taux = M.moe_apply(_torch(p), torch.from_numpy(x), k, cf)
    return np.asarray(jy), float(jaux), ty.numpy(), float(taux)


def _ref_dispatch(p, x, k, cf):
    """The reference's routing and dispatch maps, ``moe.py:68-106`` with
    one data shard, run in jnp (the function returns only y and aux)."""
    xf = jnp.asarray(x).reshape(1, -1, x.shape[-1])
    tl = xf.shape[1]
    e = p["router"].shape[-1]
    logits = (xf @ jnp.asarray(p["router"]).astype(xf.dtype)).astype(
        jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    cap = int(max(1, round(tl * k / e * cf)))
    flat_e = expert_idx.reshape(1, tl * k)
    flat_tok = jnp.broadcast_to(jnp.repeat(jnp.arange(tl), k)[None],
                                (1, tl * k))
    order = jnp.argsort(flat_e, axis=-1)
    se = jnp.take_along_axis(flat_e, order, axis=-1)
    stok = jnp.take_along_axis(flat_tok, order, axis=-1)
    onehot = jax.nn.one_hot(se, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1, se[..., None],
                              axis=2)[..., 0]
    keep = pos < cap
    slot = se * cap + jnp.where(keep, pos, cap - 1)
    rows = jnp.arange(1)[:, None]
    tok = jnp.zeros((1, e * cap), jnp.int32).at[rows, slot].set(
        jnp.where(keep, stok, 0))
    ok = jnp.zeros((1, e * cap), bool).at[rows, slot].set(keep)
    inv_slot = jnp.zeros((1, tl * k), jnp.int32).at[rows, order].set(slot)
    inv_ok = jnp.zeros((1, tl * k), bool).at[rows, order].set(keep)
    return {"experts": flat_e, "cap": cap, "tok": tok, "ok": ok,
            "inv_slot": inv_slot, "inv_ok": inv_ok}


def _check_dispatch(p, x, k, cf=1.25):
    want = _ref_dispatch(p, x, k, cf)
    xf = torch.from_numpy(x).reshape(1, -1, x.shape[-1])
    got = M.route(_torch(p), xf, k, cf)
    assert got["cap"] == want["cap"]
    for key in ("experts", "tok", "ok", "inv_slot", "inv_ok"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    return got


def _close(got, want, rtol, what=""):
    top = float(np.abs(want).max())
    assert top > 0.1, "output too small to compare"
    err = float(np.abs(got - want).max())
    assert err <= rtol * top, f"{what}: {err} > {rtol} * {top}"


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([1, 3, 3, 2, 3, 0], np.float32)
    vals, idx = M.top_k(torch.from_numpy(x), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [1, 2, 4]
    assert vals.tolist() == np.asarray(jv).tolist()


def test_capacity_is_the_references():
    """Python's round, floored at 1: DeepSeek's decode step (b 4, one token
    each, top 6 of 64, cf 1.25) rounds 0.47 to 0 and takes 1 slot."""
    assert M.capacity(4, 6, 64, 1.25) == 1
    assert M.capacity(8192, 6, 64, 1.25) == 960
    assert M.capacity(6, 2, 4, 1.25) == 4
    assert M.capacity(384, 6, 64, 64 / 6) == 384


def test_capacity_drop_empties_the_last_kept_slot():
    """6 tokens, 4 experts, top 2, a router that sends every token to
    experts 0 and 1, cap 4: tokens 0-2 get both experts' output; token 3
    is kept (position 3 < 4) but its slot is emptied by the dropped picks
    of tokens 4-5, so it gets 0, as do the dropped tokens."""
    rng = np.random.RandomState(0)
    d, e, f = 8, 4, 16
    p = _params(rng, d, e, f)
    p["router"] = np.zeros((d, e), np.float32)
    p["router"][0, 0], p["router"][0, 1] = 2.0, 1.5
    x = rng.normal(0, 1, (1, 6, d)).astype(np.float32)
    x[..., 0] = 5.0
    jy, jaux, ty, taux = _both(p, x, 2)
    _close(ty, jy, F32_RTOL)
    assert taux == pytest.approx(jaux, rel=F32_RTOL)
    served = np.abs(jy[0]).max(axis=-1) > 0
    assert served.tolist() == [True, True, True, False, False, False]
    assert (np.abs(ty[0]).max(axis=-1) > 0).tolist() == served.tolist()
    r = _check_dispatch(p, x, 2)
    assert r["cap"] == 4
    # both experts over-full: their slot 3 emptied, the kept pick keeps
    # its inverse entry (ok) and gathers the zero row's output
    assert r["emptied"].reshape(e, 4)[:, 3].tolist() == [True, True, False,
                                                         False]
    assert int(r["inv_ok"].sum()) == 8


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_drops_in_several_experts_match_reference(seed):
    """64 tokens (b 2 x 32), 8 experts, top 2, shared experts, a router
    biased toward experts 0-2: several experts overflow at cf 1.25."""
    rng = np.random.RandomState(seed)
    d, e, f = 16, 8, 24
    p = _params(rng, d, e, f, n_shared=2)
    p["router"][0, :3] += 3.0
    x = rng.normal(0, 1, (2, 32, d)).astype(np.float32)
    x[..., 0] += 2.0
    jy, jaux, ty, taux = _both(p, x, 2)
    _close(ty, jy, F32_RTOL)
    assert taux == pytest.approx(jaux, rel=F32_RTOL)
    r = _check_dispatch(p, x, 2)
    assert int(r["emptied"].sum()) >= 2, "several experts overflow"
    assert int((~r["inv_ok"]).sum()) >= 2, "picks are dropped"


def test_equal_router_logits_match_reference():
    """A zero router: every prob equal, so top-k takes experts 0..k-1 by
    the tie rule, both experts overflow, and output and aux agree."""
    rng = np.random.RandomState(4)
    d, e, f = 8, 6, 16
    p = _params(rng, d, e, f, n_shared=1)
    p["router"] = np.zeros((d, e), np.float32)
    x = rng.normal(0, 1, (2, 10, d)).astype(np.float32)
    jy, jaux, ty, taux = _both(p, x, 3)
    _close(ty, jy, F32_RTOL)
    assert taux == pytest.approx(jaux, rel=F32_RTOL) and jaux == \
        pytest.approx(e * (1 / e), rel=1e-6)
    r = _check_dispatch(p, x, 3)
    assert set(r["experts"].flatten().tolist()) == {0, 1, 2}


def test_decode_step_has_capacity_one():
    """b 4, one token each, top 6 of 64 experts at cf 1.25: cap 1, so an
    expert that two picks choose serves nobody, in both packages."""
    rng = np.random.RandomState(5)
    d, e, f = 16, 64, 8
    p = _params(rng, d, e, f, n_shared=2)
    # two tokens share their first choice
    x = rng.normal(0, 1, (4, 1, d)).astype(np.float32)
    x[1] = x[0] + 0.01 * rng.normal(0, 1, (1, d))
    jy, jaux, ty, taux = _both(p, x, 6)
    _close(ty, jy, F32_RTOL)
    assert taux == pytest.approx(jaux, rel=F32_RTOL)
    r = _check_dispatch(p, x, 6)
    assert r["cap"] == 1 and int(r["emptied"].sum()) >= 1


def test_gradients_with_drops_match_reference():
    """d/d(x, router, experts, shared) of sum(y * w) + aux at cf 1.25 with
    drops: each within 1e-4 of its largest value (the train parity level)."""
    rng = np.random.RandomState(6)
    d, e, f = 16, 8, 24
    p = _params(rng, d, e, f, n_shared=1, router_scale=3.0)
    x = rng.normal(0, 1, (2, 16, d)).astype(np.float32)
    w = rng.normal(0, 1, (2, 16, d)).astype(np.float32)

    def jloss(pp, xx):
        y, aux = JM.moe_apply(pp, xx, 2, 1.25)
        return jnp.sum(y * w) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x))
    tp = jax.tree.map(lambda a: a.requires_grad_(True), _torch(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.moe_apply(tp, tx, 2, 1.25)
    loss = (y * torch.from_numpy(w)).sum() + aux
    leaves = jax.tree.leaves(tp) + [tx]
    tg = torch.autograd.grad(loss, leaves)
    want = jax.tree.leaves(jg[0]) + [jg[1]]
    assert len(want) == len(tg)
    for i, (g, wg) in enumerate(zip(tg, want)):
        _close(g.numpy(), np.asarray(wg), 1e-4, f"leaf {i}")


def _bits(a: np.ndarray) -> tuple[jnp.ndarray, torch.Tensor]:
    """One f32 array as bf16 in both packages, with the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


def test_deepseek_width_layer_in_bf16():
    """One MoE layer at DeepSeek-MoE 16B's full width (d 2048, 64 experts
    of 1408, 2 shared, top 6) in bf16 on 512 tokens at cf 1.25 (cap 60):
    the output within 2^-4 of its largest value, and at most 1% of the
    tokens routed differently (the bf16 router logits of the two products
    may flip a near-tie)."""
    rng = np.random.RandomState(7)
    d, e, f, k = 2048, 64, 1408, 6
    # the model's fan-in init of the router (std d^-0.5): logits O(1)
    p32 = _params(rng, d, e, f, n_shared=2, router_scale=d ** -0.5)
    jp, tp = {}, {}
    for key, a in p32.items():
        if key == "router":
            jp[key], tp[key] = jnp.asarray(a), torch.from_numpy(a)
        elif key == "shared":
            pairs = {kk: _bits(v) for kk, v in a.items()}
            jp[key] = {kk: v[0] for kk, v in pairs.items()}
            tp[key] = {kk: v[1] for kk, v in pairs.items()}
        else:
            jp[key], tp[key] = _bits(a)
    del p32
    jx, tx = _bits(rng.normal(0, 1, (2, 256, d)).astype(np.float32))
    jy, jaux = JM.moe_apply(jp, jx, k, 1.25)
    with torch.inference_mode():
        ty, taux = M.moe_apply(tp, tx, k, 1.25)
        got = M.route(tp, tx.reshape(1, 512, d), k, 1.25)
    # the reference's routing in bf16 (moe.py:68-70) on the same input
    logits = (jx.reshape(1, 512, d) @ jp["router"].astype(jnp.bfloat16)
              ).astype(jnp.float32)
    _, ref_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flips = np.any(np.asarray(ref_idx).reshape(512, k)
                   != got["experts"].numpy().reshape(512, k), axis=-1)
    share = float(flips.mean())
    err = float(np.abs(ty.float().numpy() - np.asarray(jy, np.float32)
                       ).max())
    print(f"DeepSeek width, bf16: routing differs for {share:.2%} of 512 "
          f"tokens; max|port - reference| {err:.4g} of max|reference| "
          f"{float(np.abs(np.asarray(jy, np.float32)).max()):.4g}")
    assert got["cap"] == 60
    assert share <= ROUTING_FLIP_SHARE
    _close(ty.float().numpy(), np.asarray(jy, np.float32), BF16_RTOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-2)
