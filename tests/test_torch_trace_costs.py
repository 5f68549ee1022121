"""The port's cost walker on the model zoo against the reference's jaxpr
walker: the softmax rules, the blocked flash that meta tensors are costed
as, the unit scans, and the ``_model_costs`` rows of the smoke and full
configs.  The reference's walker, models and registry import in-process.

Parity levels: the softmax rules and the blocked flash forward and
backward exact per column.  ``_model_costs``: the columns in ``EQUAL``
exact; every other column differs for a reason logged in ROADMAP §3, and
both sides are pinned at their logged values (``REF_COSTS``,
``PORT_COSTS``), so a drift on either side fails."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.tracer import compute_cost as jax_cost
from repro.models import flash as jflash
from repro_torch.configs import get, smoke
from repro_torch.configs.registry import _model_costs
from repro_torch.core import tracer
from repro_torch.core.tracer import compute_cost
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd.ref import ssd_diag_ref
from repro_torch.models.flash import flash_attention
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# column indices: tensor FLOPs, element ops, bytes, transcendentals,
# gathered elements, scan steps
MXU, VPU, BYTES, TRANS, GATHER, SCAN = range(6)


def _t(shape, dtype="float32", requires_grad=False):
    return torch.empty(shape, dtype=getattr(torch, dtype),
                       requires_grad=requires_grad)


def _j(shape, dtype="float32"):
    return jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))


# ---------------------------------------------------------------------------
# softmax
# ---------------------------------------------------------------------------

SOFTMAX_SHAPES = [((2, 3, 5), -1), ((4, 7), 0), ((3, 2, 6, 9), 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,dim", SOFTMAX_SHAPES)
@pytest.mark.parametrize("fn", ["softmax", "log_softmax"])
def test_softmax_rules_match_jax(fn, shape, dim, dtype):
    """``aten._softmax``/``_log_softmax`` charge what ``jax.nn.softmax``/
    ``log_softmax`` charge on JAX 0.9, and forward plus backward what their
    VJPs charge (softmax: one exp an element, the VJP's pow(-2) a row)."""
    jf = getattr(jax.nn, fn)
    tf = getattr(torch, fn)
    x = _j(shape, dtype)
    np.testing.assert_array_equal(
        compute_cost(lambda x: tf(x, dim), _t(shape, dtype)),
        jax_cost(lambda x: jf(x, axis=dim), x))

    def vjp(x, g):
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(tf(x, dim), x, g)

    np.testing.assert_array_equal(
        compute_cost(vjp, _t(shape, dtype), _t(shape, dtype)),
        jax_cost(lambda x, g: jax.vjp(lambda y: jf(y, axis=dim), x)[1](g),
                 x, x))


def test_softmax_charges_one_exp_an_element():
    got = compute_cost(lambda x: torch.softmax(x, -1), _t((4, 24, 8192)))
    assert got[TRANS] == 4 * 24 * 8192


# ---------------------------------------------------------------------------
# the blocked flash of meta tensors
# ---------------------------------------------------------------------------

#: (b, s, h, g, d), causal, window, q_chunk, kv_chunk, dtype
FLASH_CASES = [
    ((2, 16, 8, 4, 32), False, None, 8, 8, "float32"),      # flash-ring's
    ((1, 256, 8, 4, 64), True, None, 64, 128, "bfloat16"),
    ((1, 256, 8, 4, 64), True, 48, 32, 64, "bfloat16"),     # K/V strips
    ((2, 64, 4, 2, 16), True, 12, 16, 16, "float32"),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_blocked_flash_costs_what_the_reference_charges(case):
    (b, s, h, g, d), causal, win, qc, kc, dt = case
    q, kv, lse = (b, s, h, d), (b, s, g, d), (b, s, h)
    want = jax_cost(lambda q, k, v: jflash.flash_attention(
        q, k, v, causal=causal, window=win, q_chunk=qc, kv_chunk=kc),
        _j(q, dt), _j(kv, dt), _j(kv, dt))
    got = compute_cost(lambda q, k, v: flash_attention(
        q, k, v, causal=causal, window=win, q_chunk=qc, kv_chunk=kc),
        _t(q, dt), _t(kv, dt), _t(kv, dt))
    np.testing.assert_array_equal(got, want)
    want = jax_cost(lambda q, k, v, o, l, do: jflash._flash_bwd(
        causal, win, qc, kc, None, (q, k, v, o, l), do),
        _j(q, dt), _j(kv, dt), _j(kv, dt), _j(q, dt), _j(lse), _j(q, dt))
    got = compute_cost(lambda q, k, v, o, l, do: fops.flash_attention_bwd(
        q, k, v, o, l, do, causal=causal, window=win, q_chunk=qc,
        kv_chunk=kc), _t(q, dt), _t(kv, dt), _t(kv, dt), _t(q, dt),
        _t(lse), _t(q, dt))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    (1, 40, 4, 1, 16, True, None, 16, 8),        # padded q and k
    (2, 64, 4, 2, 16, True, 12, 16, 16),          # strips
    (2, 16, 8, 4, 32, False, None, 8, 8),
    (1, 48, 4, 2, 16, True, 20, 16, 16),
], ids=str)
def test_blocked_flash_is_attention_ref(case):
    """attention_blocked_ref and its backward compute attention_ref and
    attention_bwd_ref (f32, within f32 rounding of sums in other orders)."""
    b, s, h, g, d, causal, win, qc, kc = case
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, h, d, generator=gen)
    k, v = (torch.randn(b, s, g, d, generator=gen) for _ in range(2))
    do = torch.randn(b, s, h, d, generator=gen)
    o, lse = fref.attention_blocked_ref(q, k, v, causal, win, qc, kc,
                                        return_lse=True)
    o2, lse2 = fref.attention_ref(q, k, v, causal=causal, window=win,
                                  return_lse=True)
    torch.testing.assert_close(o, o2, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, lse2, rtol=0, atol=1e-5)
    got = fref.attention_blocked_bwd_ref(q, k, v, o2, lse2, do, causal, win,
                                         qc, kc)
    want = fref.attention_bwd_ref(q, k, v, o2, lse2, do, causal=causal,
                                  window=win)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)


def test_meta_branches_launch_nothing():
    """On meta tensors the kernel wrappers return meta outputs of the
    kernels' shapes and dtypes and launch nothing, forward, LSE, backward
    and the SSD block with its autograd Function alike."""
    fops.reset_counts()
    sops.reset_counts()
    m = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(2, 1024, 8, 64, **m)
    k = torch.empty(2, 1024, 2, 64, **m)
    out, lse = fops.flash_attention_fwd(q, k, k, return_lse=True)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (2, 1024, 8) and lse.dtype == torch.float32
    dq, dk, dv = fops.flash_attention_bwd(q, k, k, out, lse, q)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert dq.dtype == dk.dtype == torch.bfloat16 and dq.device.type == "meta"
    xs = [torch.empty(2, 4, 64, 8, 16, **m),
          torch.empty(2, 4, 64, 8, device="meta"),
          torch.empty(2, 4, 64, 8, device="meta"),
          torch.empty(2, 4, 64, 1, 32, **m), torch.empty(2, 4, 64, 1, 32, **m)]
    y = sops.ssd_diag_block(*xs, 8, torch.float32)
    assert y.shape == xs[0].shape and y.dtype == torch.float32
    leaves = [x.requires_grad_(True) for x in xs]
    grads = torch.autograd.grad(sops.ssd_diag(*leaves, 8).float().sum(),
                                leaves)
    assert [g.shape for g in grads] == [x.shape for x in xs]
    assert fops.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}
    assert sops.LAUNCHES == {"ssd_diag": 0, "ssd_diag_bwd": 0}


# ---------------------------------------------------------------------------
# unit scans and the _model_costs rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "llama3.2-3b"])
def test_slicing_the_unit_stack_costs_nothing(arch):
    """A decode step's cost grows by the same amount with every unit: the
    slices of the stacked parameters and caches cost no bytes (before the
    unit scan, each slice was charged the whole stack)."""
    cost = {}
    for n in (2, 4, 8):
        cfg = dataclasses.replace(smoke(get(arch)), n_layers=n)
        cost[n] = np.asarray(_model_costs(cfg, ("decode",))["decode"])
    per_unit = (cost[4] - cost[2]) / 2
    np.testing.assert_array_equal(cost[8] - cost[4], 4 * per_unit)
    assert per_unit[SCAN] == 1


#: the reference's live ``_model_costs`` (smoke: b 2, s 8, decode cache
#: 32; full: b 4, s 2048, decode cache 8192) on JAX 0.9
REF_COSTS = {
    'qwen3-8b smoke train': [10420224, 377271, 7239536, 10161, 0, 4],
    'qwen3-8b smoke prefill': [2555904, 66578, 1771528, 2354, 0, 2],
    'qwen3-8b smoke decode': [458752, 19684, 1087784, 708, 8192, 2],
    'mamba2-2.7b smoke train': [9363456, 720809, 12202596, 10896, 6400, 8],
    'mamba2-2.7b smoke prefill': [2203648, 159880, 3689464, 2688, 1280, 4],
    'mamba2-2.7b smoke decode': [369664, 33150, 1239448, 58, 0, 2],
    'gemma3-4b smoke train': [24969216, 759960, 15671448, 15622, 0, 2],
    'gemma3-4b smoke prefill': [7405568, 187902, 4122380, 7030, 0, 1],
    'gemma3-4b smoke decode': [1073152, 42671, 1994455, 1480, 14336, 1],
    'llama3.2-3b smoke train': [10420224, 332599, 6810400, 9969, 0, 4],
    'llama3.2-3b smoke prefill': [2555904, 53650, 1664216, 2162, 0, 2],
    'llama3.2-3b smoke decode': [458752, 18012, 1073208, 684, 8192, 2],
    'llama3.2-3b full prefill': [51955076431872, 85345180256, 1017161969134,
                                 11349995008, 448, 700],
    'llama3.2-3b full decode': [36974886912, 2040376304, 21664003646,
                                22052608, 1879048192, 28],
    'mamba2-2.7b full prefill': [44917800828928, 121585374464,
                                 1604641719566, 10822530048, 1376256, 576],
    'mamba2-2.7b full decode': [21952462848, 521791500, 11306227390, 26116,
                                0, 64],
    'deepseek-moe-16b smoke train': [45858816, 751520, 18200034, 10161,
                                     1280, 4],
    'deepseek-moe-16b smoke prefill': [14368768, 199756, 5422428, 2290,
                                       1280, 2],
    'whisper-large-v3 smoke prefill': [9240576, 197654, 4385976, 10614, 0,
                                       4],
    'whisper-large-v3 smoke decode': [540672, 20986, 1200544, 946, 8192, 2],
    'deepseek-moe-16b full prefill': [49307902279680, 77972886476,
                                      931572271654, 7601073664, 8946112,
                                      700],
    'deepseek-moe-16b full decode': [47861202944, 3882570972, 58435118998,
                                     14719744, 3758102656, 28],
    'whisper-large-v3 full prefill': [35604468858880, 199691249248,
                                      2124913235398, 29630479072, 512,
                                      2176],
    'whisper-large-v3 full decode': [14433648640, 2859400844, 21241436478,
                                     24830404, 2684354560, 32],
    'llama-3.2-vision-90b smoke train': [22609920, 584623, 13303200, 14518,
                                         0, 2],
    'llama-3.2-vision-90b smoke prefill': [6750208, 137318, 3554004, 5926,
                                           0, 1],
    'llama-3.2-vision-90b smoke decode': [987136, 44876, 1910564, 1774,
                                          20480, 1],
    'llama-3.2-vision-90b full prefill': [1520432196878336, 959796433228,
                                          11185103259754, 129249307396,
                                          1600, 2900],
    'llama-3.2-vision-90b full decode': [825961742336, 8301169452,
                                         241409605262, 218028524,
                                         6710886400, 20],
}
#: the port's, at its logged values (ROADMAP §3)
PORT_COSTS = {
    'qwen3-8b smoke train': [10420224, 384245, 8223852, 10962, 8208, 4],
    'qwen3-8b smoke prefill': [2555904, 66306, 1765972, 2354, 0, 2],
    'qwen3-8b smoke decode': [458752, 11446, 1062068, 708, 0, 2],
    'mamba2-2.7b smoke train': [9043968, 706931, 12535180, 13280, 9488, 6],
    'mamba2-2.7b smoke prefill': [2203648, 140576, 3645532, 2688, 1280, 4],
    'mamba2-2.7b smoke decode': [369664, 33140, 1234436, 58, 0, 2],
    'gemma3-4b smoke train': [24969216, 771809, 17941972, 16406, 8208, 2],
    'gemma3-4b smoke prefill': [7405568, 187118, 4107148, 7030, 0, 1],
    'gemma3-4b smoke decode': [1073152, 28106, 1955636, 1480, 0, 1],
    'llama3.2-3b smoke train': [10420224, 337141, 7779612, 10578, 8208, 4],
    'llama3.2-3b smoke prefill': [2555904, 53570, 1662260, 2162, 0, 2],
    'llama3.2-3b smoke decode': [458752, 9798, 1048404, 684, 0, 2],
    'llama3.2-3b full prefill': [51955076431872, 85344713312, 1017158753546,
                                 11349995008, 448, 700],
    'llama3.2-3b full decode': [36974886912, 161327716, 17911860218,
                                22052608, 0, 28],
    'mamba2-2.7b full prefill': [44917800828928, 113120342528,
                                 1435476535818, 10822530048, 1376256, 576],
    'mamba2-2.7b full decode': [21952462848, 521790984, 11332592826, 26116,
                                0, 64],
    'deepseek-moe-16b smoke train': [45858816, 696500, 27948090, 10738,
                                     10068, 4],
    'deepseek-moe-16b smoke prefill': [14368768, 201652, 5737278, 2290,
                                       1732, 2],
    'whisper-large-v3 smoke prefill': [9240576, 197350, 4377812, 10614, 0,
                                       4],
    'whisper-large-v3 smoke decode': [540672, 12768, 1174628, 946, 0, 2],
    'deepseek-moe-16b full prefill': [49307902279680, 77907190508,
                                      921363498454, 7601073664, 42435064,
                                      700],
    'deepseek-moe-16b full decode': [47861202944, 124448684, 50932488030,
                                     14719744, 22680, 28],
    'whisper-large-v3 full prefill': [35604468858880, 198096223104,
                                      2124903597914, 29630479072, 512,
                                      2176],
    'whisper-large-v3 full decode': [14433648640, 175045704, 15881296314,
                                     24830404, 0, 32],
    'llama-3.2-vision-90b smoke train': [22609920, 589721, 15444824, 14710,
                                         8208, 2],
    'llama-3.2-vision-90b smoke prefill': [6750208, 137110, 3548144, 5926,
                                           0, 1],
    'llama-3.2-vision-90b smoke decode': [987136, 24342, 1847236, 1774, 0,
                                          1],
    'llama-3.2-vision-90b full prefill': [1520432196878336, 959459072072,
                                          11185079378962, 129249307396,
                                          1600, 2900],
    'llama-3.2-vision-90b full decode': [825961742336, 1590281568,
                                         227999566554, 218028524, 0, 20],
}
#: columns exactly equal: tensor FLOPs, transcendentals and scan steps of
#: every prefill and decode; the train rows' tensor FLOPs and scan steps
#: but Mamba2's (ROADMAP §3: the SSD backward recomputes the block, and
#: autograd skips the gradients of a one-chunk recurrence)
EQUAL = {k: ((MXU, SCAN) if k.endswith("train") else (MXU, TRANS, SCAN))
         for k in PORT_COSTS}
EQUAL["mamba2-2.7b smoke train"] = ()
for k in PORT_COSTS:
    if not k.endswith("train") and REF_COSTS[k][GATHER] == \
            PORT_COSTS[k][GATHER]:
        EQUAL[k] += (GATHER,)


def _row(key, costs_fn, get_fn, smoke_fn):
    arch, size, kind = key.split()
    if size == "smoke":
        return costs_fn(smoke_fn(get_fn(arch)), (kind,))[kind]
    return costs_fn(get_fn(arch), (kind,), b=4, s=2048)[kind]


@pytest.mark.parametrize("key", sorted(PORT_COSTS))
def test_model_costs_against_reference(key):
    """Each row of both walkers at its pinned value, and the claimed
    columns equal."""
    port = [int(v) for v in _row(key, _model_costs, get, smoke)]
    ref = [int(v) for v in _row(key, jreg._model_costs, jreg.get,
                                jreg.smoke)]
    assert ref == REF_COSTS[key]
    assert port == PORT_COSTS[key]
    for col in EQUAL[key]:
        assert port[col] == ref[col], (key, col)


def test_llama_decode_transcendentals_include_the_softmax():
    """22,052,608 = b 4 x 24 heads x 8192 keys x 28 layers of softmax exp,
    plus RoPE's; before the softmax rule the port charged 32,512."""
    row = PORT_COSTS["llama3.2-3b full decode"]
    assert row[TRANS] == 4 * 24 * 8192 * 28 + 32512


def _train_identity(cfg, b, s) -> tuple[float, float]:
    """(train FLOPs, the identity's right side) of one config, where

        train = 4 (P - U) + 4 s U + 0.5 L A + L D - n_units W

    with P the prefill, U the last position's unembedding, A one layer's
    flash forward (0 without attention), D one layer's SSD diagonal block
    (its backward recomputes it; 0 without SSM layers) and W the unit's
    last projection (the MLP's w_o, or the mixer's out_proj), whose
    output no backward op saves, so remat's recompute stops before it."""
    p = _model_costs(cfg, ("prefill", "train"), b=b, s=s)
    u = 2 * b * cfg.d_model * cfg.padded_vocab
    a = d = 0.0
    kinds = cfg.layer_kinds()
    if "g" in kinds or "l" in kinds:
        q, kv = (b, s, cfg.n_heads, cfg.hd), (b, s, cfg.n_kv_heads, cfg.hd)
        dt = cfg.dtype
        a = compute_cost(flash_attention, _t(q, dt), _t(kv, dt),
                         _t(kv, dt))[MXU]
        w = 2 * b * s * cfg.d_ff * cfg.d_model
    if "m" in kinds:
        d_in, c = cfg.ssm_expand * cfg.d_model, s // cfg.ssm_chunk
        h = d_in // cfg.ssm_head_dim
        x = (b, c, cfg.ssm_chunk)
        d = compute_cost(lambda *t: ssd_diag_ref(*t, h // cfg.ssm_groups,
                                                 torch.float32),
                         _t(x + (h, cfg.ssm_head_dim), cfg.dtype),
                         _t(x + (h,)), _t(x + (h,)),
                         _t(x + (cfg.ssm_groups, cfg.ssm_state), cfg.dtype),
                         _t(x + (cfg.ssm_groups, cfg.ssm_state),
                            cfg.dtype))[MXU]
        w = 2 * b * s * d_in * cfg.d_model
    n = cfg.n_layers
    want = (4 * (p["prefill"][MXU] - u) + 4 * s * u + 0.5 * n * a + n * d
            - n * w)
    return p["train"][MXU], want


@pytest.mark.parametrize("arch,s", [("llama3.2-3b", 1024),
                                    ("mamba2-2.7b", 64)])
def test_train_cost_identity_against_the_ports_prefill(arch, s):
    """The reference cannot walk a full-width train step on JAX 0.9 (its
    walker meets a ``custom_lin`` without a jaxpr: ROADMAP §3), so the
    port's train step is held to its own prefill: the identity of
    :func:`_train_identity` holds exactly, with remat on and the loss
    chunked (both as at full width; 1024 tokens take the flash path).
    On the H100, chip_smoke walks the full-width steps."""
    cfg = dataclasses.replace(smoke(get(arch)), remat=True, loss_chunk=16)
    got, want = _train_identity(cfg, 2, s)
    assert got == want


def test_walking_a_full_width_step_launches_nothing():
    fops.reset_counts()
    sops.reset_counts()
    cost = _model_costs(get("llama3.2-3b"), ("prefill",), b=4, s=2048)
    assert cost["prefill"][MXU] == PORT_COSTS["llama3.2-3b full prefill"][0]
    assert fops.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}
    assert sops.LAUNCHES == {"ssd_diag": 0, "ssd_diag_bwd": 0}
    assert tracer.active_walker() is None
