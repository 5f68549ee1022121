"""Flash-attention and SSD kernels of the port: plain versions against the
JAX reference's oracles on ``tests/test_kernels.py``'s sweeps, the
gradients (``models/flash.py::flash_attention`` on the CPU against
``jax.grad`` of the reference's custom VJP, ``ssd_chunked`` against
``jax.grad`` of the reference's einsum path), the wrappers' dispatch rules,
and the limits that hold the CUDA kernels to their plain versions
(``repro_torch/kernels/tolerance.py``): an emulation of the flash kernels'
arithmetic passes them, and the same with a planted fault (a dropped key
tile or a stale maximum in the forward; a skipped key tile or a dropped D
term in the backward) fails them.  The CUDA kernels
themselves are tested in ``tests/test_torch_cuda.py``, which imports no JAX
so that it runs on a card.

Every case asserts that its reference output is O(1), so that no
tolerance is vacuous."""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention_fwd as jax_flash_fwd,
)
from repro.models import flash as jax_flash
from repro.models import ssm as jax_ssm
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.ssd.ref import ssd_diag_ref as jax_ssd_diag_ref
from repro_torch.kernels import tolerance
from repro_torch.kernels.flash_attention import ops as fops, ref as fref
from repro_torch.kernels.ssd import ops as sops, ref as sref
from repro_torch.models import flash as tflash
from repro_torch.models import ssm as tssm
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

#: tests/test_kernels.py:16-36, with its tolerances
FLASH_SWEEP = [
    (1, 256, 4, 2, 64, None, True),
    (2, 256, 2, 2, 128, 128, True),
    (1, 384, 4, 1, 64, None, True),
    (1, 512, 2, 1, 64, None, False),
]
FLASH_ATOL = {np.float32: 2e-5, "bfloat16": 2e-2}
#: tests/test_kernels.py:39-57 (r = 12 is the reference wrapper's slabbing
#: case) and its tolerance
SSD_SWEEP = [
    (1, 2, 32, 1, 4, 16, 16),
    (2, 2, 16, 2, 8, 8, 32),
    (1, 1, 64, 1, 12, 16, 16),
]
SSD_ATOL = 2e-4
def _flash_inputs(seed, b, s, h, g, d):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (b, s, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, s, g, d)).astype(np.float32),
            rng.normal(0, 1, (b, s, g, d)).astype(np.float32))


def _jax_flash_want(q, k, v, causal, win, dtype):
    """The reference oracle in its own layout (heads expanded, (bh,s,d))."""
    b, s, h, d = q.shape
    r = h // k.shape[2]

    def lay(x, rep):
        x = np.repeat(x, rep, axis=2).transpose(0, 2, 1, 3)
        return jnp.asarray(x.reshape(b * h, s, d), dtype)

    out = jax_attention_ref(lay(q, 1), lay(k, r), lay(v, r), causal=causal,
                            window=win)
    return np.asarray(out, np.float32).reshape(b, h, s, d).transpose(0, 2, 1, 3)


def _torch(x: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,s,h,g,d,win,causal", FLASH_SWEEP)
def test_flash_plain_matches_jax_oracle(b, s, h, g, d, win, causal, dtype):
    q, k, v = _flash_inputs(s + d, b, s, h, g, d)
    want = _jax_flash_want(q, k, v, causal, win,
                           jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    got = fref.attention_ref(_torch(q, dtype), _torch(k, dtype),
                             _torch(v, dtype), causal=causal, window=win)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    top = float(np.abs(want).max())
    print(f"max|want| = {top:.3g}")
    assert top > 0.3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=FLASH_ATOL[dtype])


def test_flash_plain_matches_pallas_kernel_interpreted():
    """The reference's Pallas kernel itself (interpret mode on the CPU)."""
    q, k, v = _flash_inputs(7, 1, 256, 4, 2, 64)
    want = np.asarray(jax_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, window=64))
    got = fops.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   window=64).numpy()
    assert np.abs(want).max() > 0.3
    np.testing.assert_allclose(got, want, rtol=0, atol=FLASH_ATOL[np.float32])


def test_flash_window_is_ignored_without_causal():
    """As in the Pallas kernel: the window bounds only causal rows."""
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(3, 1, 64, 2, 1, 16))
    assert torch.equal(fref.attention_ref(q, k, v, causal=False, window=8),
                       fref.attention_ref(q, k, v, causal=False))
    assert not torch.equal(fref.attention_ref(q, k, v, window=8),
                           fref.attention_ref(q, k, v))


def _ssd_inputs(seed, b, c, q, g, r, p, n):
    """tests/test_kernels.py's distributions."""
    rng = np.random.RandomState(seed)
    h = g * r
    x = rng.normal(0, 1, (b, c, q, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (b, c, q, h)).astype(np.float32)
    adt = -rng.uniform(0.01, 0.5, (b, c, q, h)).astype(np.float32)
    cum = np.cumsum(adt, axis=2, dtype=np.float32)
    bm = rng.normal(0, 1, (b, c, q, g, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, c, q, g, n)).astype(np.float32)
    return x, dt, cum, bm, cm


@pytest.mark.parametrize("in_dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,c,q,g,r,p,n", SSD_SWEEP)
def test_ssd_plain_matches_jax_oracle(b, c, q, g, r, p, n, in_dtype):
    """Both output dtypes: x's (the TPU kernel's contract) and f32 (what
    ``ssd_chunked`` asks for, as the reference's einsum path keeps)."""
    x, dt, cum, bm, cm = _ssd_inputs(q + r, b, c, q, g, r, p, n)
    jdt = jnp.bfloat16 if in_dtype == "bfloat16" else jnp.float32
    grouped = (jnp.asarray(x.reshape(b, c, q, g, r, p), jdt),
               jnp.asarray(dt.reshape(b, c, q, g, r)),
               jnp.asarray(cum.reshape(b, c, q, g, r)),
               jnp.asarray(bm, jdt), jnp.asarray(cm, jdt))
    want = jax_ssd_diag_ref(*grouped)
    want_f32 = jax_ssd_diag_ref(grouped[0].astype(jnp.float32), *grouped[1:3],
                                grouped[3].astype(jnp.float32),
                                grouped[4].astype(jnp.float32))
    ins = (_torch(x, in_dtype), torch.from_numpy(dt), torch.from_numpy(cum),
           _torch(bm, in_dtype), _torch(cm, in_dtype))
    got = sops.ssd_diag_block(*ins, r)
    got_f32 = sops.ssd_diag_block(*ins, r, out_dtype=torch.float32)
    assert got.dtype == ins[0].dtype and got_f32.dtype == torch.float32
    top = float(np.abs(np.asarray(want_f32)).max())
    print(f"max|want| = {top:.3g}")
    assert top > 0.3
    shape = (b, c, q, g * r, p)
    np.testing.assert_allclose(got_f32.numpy(),
                               np.asarray(want_f32).reshape(shape), rtol=0,
                               atol=SSD_ATOL)
    # x's dtype: the same f32 values rounded once (bf16: within one ulp)
    tol = SSD_ATOL if in_dtype == np.float32 else 2.0 ** -8 * top
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32).reshape(shape),
                               rtol=0, atol=tol)


def test_ssd_plain_masks_the_exponent_before_exp():
    """For j > i, cum_i - cum_j is positive and exp overflows; the masked
    entries must give 0, not 0 * inf = NaN."""
    x, dt, cum, bm, cm = _ssd_inputs(0, 1, 1, 16, 1, 2, 8, 8)
    cum = (np.arange(16, dtype=np.float32)[None, None, :, None] * -20.0
           ).repeat(2, axis=3)
    y = sref.ssd_diag_ref(*(torch.from_numpy(a) for a in (x, dt, cum, bm, cm)),
                          2)
    assert torch.isfinite(y).all()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    fops.reset_counts()
    sops.reset_counts()
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(1, 1, 64, 2, 1, 16))
    assert torch.equal(fops.flash_attention_fwd(q, k, v),
                       fref.attention_ref(q, k, v))
    ins = [torch.from_numpy(a) for a in _ssd_inputs(1, 1, 2, 8, 1, 2, 16, 16)]
    assert torch.equal(sops.ssd_diag_block(*ins, 2), sref.ssd_diag_ref(*ins, 2))
    assert fops.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}
    assert sops.LAUNCHES == {"ssd_diag": 0}


def test_non_cpu_non_cuda_tensors_raise():
    """No fallback: only CPU tensors take the plain version, and only meta
    tensors (all of them: the cost walker's) its costed form; meta inputs
    mixed with CPU ones raise."""
    q = torch.empty(1, 64, 2, 16, device="meta")
    k = torch.empty(1, 64, 1, 16)
    with pytest.raises(ValueError):
        fops.flash_attention_fwd(q, k, k)
    x = torch.empty(1, 1, 8, 2, 16, device="meta")
    dt = torch.empty(1, 1, 8, 2, device="meta")
    bm = torch.empty(1, 1, 8, 1, 16)
    with pytest.raises(ValueError):
        sops.ssd_diag_block(x, dt, dt, bm, bm, 2)


def _flash_kernel_emulation(q, k, v, *, causal=True, window=None, tile=128,
                            mutant=None):
    """The bf16 kernel's tile loop in PyTorch (kernel.cu::flash_fwd_bf16_
    kernel): 128-key tiles in order (64 before the kernel's redesign), the running maximum m and sum l in f32,
    P = exp(s - m) rounded to bf16 for P·V at the tile's running maximum,
    the accumulator rescaled by exp(m_old - m_new) between tiles.

    ``mutant`` plants a fault: "drop_tile" skips the tile of keys from s/2
    for every row past it; "stale_max" does not rescale the accumulator when
    the running maximum grows (l still is)."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, g, h // g, d)
    m = torch.full((b, g, h // g, s, 1), fref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, h // g, s, d))
    i = torch.arange(s)[:, None]
    for k0 in range(0, t, tile):
        kt, vt = k[:, k0:k0 + tile].float(), v[:, k0:k0 + tile]
        sc = torch.einsum("bsgrd,btgd->bgrst", qg, kt) * (1 / math.sqrt(d))
        j = torch.arange(k0, k0 + kt.shape[1])[None, :]
        seen = j <= i
        if window is not None:
            seen = seen & (j > i - window)
        if mutant == "drop_tile" and k0 == s // 2:
            seen = seen & (i < k0 + tile)
        if causal:
            sc = torch.where(seen, sc, fref.NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if mutant != "stale_max":
            acc = acc * corr
        acc = acc + torch.einsum("bgrst,btgd->bgrsd",
                                 p.to(torch.bfloat16).float(), vt.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


@pytest.mark.parametrize("window", [None, 512])
def test_flash_limits_pass_the_kernels_loop_and_fail_its_mutants(window):
    """At the depth of the Llama 3.2 3B prefill (s 2048, d 128; fewer
    heads): late causal rows average about 2048 values, so their outputs
    are about 30 times smaller than row 0's; a limit taken from max|plain|
    would pass a kernel that drops 128 of their keys.  The per-element limit
    passes the faithful tile loop and fails both planted faults by far."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _flash_inputs(11, 1, 2048, 4, 2, 128))
    want = fref.attention_ref(q, k, v, causal=True, window=window)
    rms = want.float().square().mean(-1).sqrt()
    assert float(rms[0, 0].max()) > 10 * float(rms[0, -64:].mean())
    worst = {}
    for mutant in (None, "drop_tile", "stale_max"):
        got = _flash_kernel_emulation(q, k, v, window=window, mutant=mutant)
        worst[mutant] = tolerance.kernel_excess("flash_fwd", got, want)
    print(f"window {window}: worst error over its limit {worst}")
    assert worst[None] <= 0.5, "the faithful loop passes with room"
    assert worst["drop_tile"] > 20 and worst["stale_max"] > 20


@pytest.mark.parametrize("b,s,h,g,d,win,causal", FLASH_SWEEP)
def test_flash_plain_rounds_p_like_the_kernel(b, s, h, g, d, win, causal):
    """bf16: the plain version and the kernel's tile loop differ only in
    the maximum at which P is rounded, within the kernel's limit (f32: see
    test_flash_plain_matches_jax_oracle)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _flash_inputs(s + d, b, s, h, g, d))
    got = _flash_kernel_emulation(q, k, v, causal=causal, window=win)
    want = fref.attention_ref(q, k, v, causal=causal, window=win)
    assert float(want.float().abs().max()) > 0.3
    assert tolerance.kernel_excess("flash_fwd", got, want) <= 1


def test_tolerance_limit_is_per_element():
    """ulps at |want| plus a share of the row's RMS; a zero row allows no
    error."""
    want = torch.tensor([[1.0, 0.5, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]],
                        dtype=torch.bfloat16)
    lim = tolerance.limit(want, 2, 0.5)
    rms = math.sqrt((1 + 0.25) / 4)
    assert lim[0, 0] == pytest.approx(2 * 2 ** -7 + 0.5 * rms)
    assert lim[0, 1] == pytest.approx(2 * 2 ** -8 + 0.5 * rms)
    assert float(lim[1].max()) < 1e-30
    assert tolerance.excess(want, want, 2, 0.5) == 0
    assert tolerance.excess(want + 0.01, want, 0, 1e-3) > 1


@pytest.mark.parametrize("tile", [64, 128])
def test_flash_kernel_loop_passes_at_either_key_tile(tile):
    """The limits do not depend on the kernel's key tile: the faithful loop
    passes them with 64-key tiles (the first kernel) and 128-key tiles (the
    wgmma kernel), windowed and ragged."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _flash_inputs(13, 1, 1000, 4, 2, 64))
    for window in (None, 300):
        want = fref.attention_ref(q, k, v, window=window)
        got = _flash_kernel_emulation(q, k, v, window=window, tile=tile)
        assert tolerance.kernel_excess("flash_fwd", got, want) <= 0.5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _ssd_tensor_core_emulation(xc, dtc, cum, bc, cc, r, mode):
    """The SSD kernel's arithmetic (ssd/kernel.cu) in PyTorch for bf16
    x, B, C and an f32 output: S = C B^T in f32 (exact bf16 products),
    A = S o exp(masked decay) o dt_j in f32, then Y = A x on the tensor
    cores as ``mode`` gives it: "split" (the kernel: A split into TF32 hi
    and lo, x exact in TF32, lo.x + hi.x), "tf32" (hi.x alone) or "bf16_m"
    (M = S o exp(decay) rounded to bf16, times dt x in f32)."""
    b, c, q, h, p = xc.shape
    g = bc.shape[3]
    s = torch.einsum("bcqgn,bckgn->bcgqk", cc.float(), bc.float())
    cumg = cum.float().reshape(b, c, q, g, r)
    dec = cumg[:, :, :, None] - cumg[:, :, None]              # (b,c,q,k,g,r)
    iq = torch.arange(q)
    seen = (iq[:, None] >= iq[None, :])[:, :, None, None]
    m = s.permute(0, 1, 3, 4, 2)[..., None] * torch.exp(
        torch.where(seen, dec, -torch.inf))
    dt = dtc.float().reshape(b, c, 1, q, g, r)
    x = xc.float().reshape(b, c, q, g, r, p)

    def prod(a, z):
        return torch.einsum("bcqkgr,bckgrp->bcqgrp", a, z)

    if mode == "bf16_m":
        y = prod(m.to(torch.bfloat16).float(), dt.reshape(b, c, q, g, r, 1) * x)
    else:
        a = m * dt
        hi = _tf32(a)
        y = prod(hi, x)
        if mode == "split":
            y = prod(_tf32(a - hi), x) + y
    return y.reshape(b, c, q, h, p)


def test_ssd_split_tf32_holds_the_f32_limit_and_one_rounding_does_not():
    """At a Mamba2 2.7B block (one chunk of 256, 80 heads of 64, state 128,
    bf16 in): the kernel's split TF32 product lies within the ssd_diag f32
    limit (4 ulps plus 2^-14 of the row's RMS); one TF32 rounding, or M
    rounded to bf16, misses it by more than 10 times."""
    x, dt, cum, bm, cm = _ssd_inputs(17, 1, 1, 256, 1, 80, 64, 128)
    ins = (_torch(x, "bfloat16"), torch.from_numpy(dt), torch.from_numpy(cum),
           _torch(bm, "bfloat16"), _torch(cm, "bfloat16"))
    want = sref.ssd_diag_ref(*ins, 80, out_dtype=torch.float32)
    assert float(want.abs().max()) > 0.3
    worst = {mode: tolerance.kernel_excess(
        "ssd_diag", _ssd_tensor_core_emulation(*ins, 80, mode), want)
        for mode in ("split", "tf32", "bf16_m")}
    print(f"worst error over the f32 limit {worst}")
    assert worst["split"] <= 0.5
    assert worst["tf32"] > 10 and worst["bf16_m"] > 10


def _split3(a: torch.Tensor, z: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, a, z)`` as 3xTF32 on the tensor cores computes it: each
    f32 operand split into TF32 hi + lo, the lo . lo product dropped."""
    ah, zh = _tf32(a), _tf32(z)
    al, zl = _tf32(a - ah), _tf32(z - zh)
    return (torch.einsum(eq, al, zh) + torch.einsum(eq, ah, zl)
            + torch.einsum(eq, ah, zh))


#: the score C_0 . B_0 the test below builds: its terms sum to about 13
CANCELLED = 0.002


def test_ssd_f32_limit_holds_where_c_dot_b_cancels():
    """f32 inputs (the smoke configs), and one score C_0 . B_0 of 0.002
    against sum |c b| of about 13: row 0 of each head is that score times
    dt_0 x_0, small, while the dot product's rounding is set by its terms.
    The plain f32 version lies within the limit of the exact (f64) value,
    and so does the kernel's 3xTF32 arithmetic; without the tensor floor
    the plain version itself missed the row limit (as it did on an H100
    input, at 1.06 times)."""
    b, c, q, g, r, p, n = 1, 1, 8, 1, 8, 16, 16
    x, dt, cum, bm, cm = _ssd_inputs(23, b, c, q, g, r, p, n)
    b0, c0 = bm[0, 0, 0, 0].astype(np.float64), cm[0, 0, 0, 0].astype(
        np.float64)
    c0 = c0 - (c0 @ b0 - CANCELLED) / (b0 @ b0) * b0
    cm[0, 0, 0, 0] = c0.astype(np.float32)
    assert np.abs(cm[0, 0, 0, 0] * bm[0, 0, 0, 0]).sum() > 8
    ins = [torch.from_numpy(a) for a in (x, dt, cum, bm, cm)]
    want = sref.ssd_diag_ref(*ins, r)
    # ssd_diag_ref computes in f32: the exact value from f64 terms
    s64 = torch.einsum("bcqgn,bckgn->bcgqk", ins[4].double(), ins[3].double())
    cum64 = ins[2].double().reshape(b, c, q, g, r)
    dec = cum64[:, :, :, None] - cum64[:, :, None]
    iq = torch.arange(q)
    seen = (iq[:, None] >= iq[None, :])[:, :, None, None]
    m = s64.permute(0, 1, 3, 4, 2)[..., None] * torch.exp(
        torch.where(seen, dec, -torch.inf))
    a = m * ins[1].double().reshape(b, c, 1, q, g, r)
    eq = "bcqkgr,bckgrp->bcqgrp"
    xs = ins[0].double().reshape(b, c, q, g, r, p)
    ex = torch.einsum(eq, a, xs).reshape(b, c, q, g * r, p)
    # the kernel's arithmetic: 3xTF32 scores, split A times split x
    s3 = _split3(ins[4], ins[3], "bcqgn,bckgn->bcgqk")
    m3 = s3.permute(0, 1, 3, 4, 2)[..., None] * torch.exp(
        torch.where(seen, dec.float(), -torch.inf))
    a3 = m3 * ins[1].reshape(b, c, 1, q, g, r)
    kern = _split3(a3, ins[0].reshape(b, c, q, g, r, p), eq).reshape(
        b, c, q, g * r, p)
    tol = tolerance.KERNEL_TOL[("ssd_diag", torch.float32)]
    plain = tolerance.excess(want, ex.float(), *tol)
    emul = tolerance.excess(kern, want, *tol)
    row_only = tolerance.excess(want, ex.float(), *tol[:2])
    print(f"plain vs exact {plain:.3g} (row limit alone {row_only:.3g}), "
          f"3xTF32 vs plain {emul:.3g}")
    assert plain <= 0.5 and emul <= 0.5
    assert row_only > 1, "the row limit alone misses the cancelling row"


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -11)])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                                 -(1.0 + 2.0 ** -9)]


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

#: tests/test_flash_model.py:12-18 (GQA, window, causal and not, s != t)
FLASH_GRAD_CASES = [
    (2, 512, 512, 8, 4, 64, None, True),
    (2, 512, 512, 8, 2, 32, 128, True),
    (1, 1500, 1500, 4, 4, 32, None, False),
    (2, 256, 1601, 8, 4, 32, None, False),
    (2, 1024, 1024, 6, 3, 32, 192, True),
]


@pytest.mark.parametrize("b,s,t,h,g,d,win,causal", FLASH_GRAD_CASES)
def test_flash_attention_grads_match_reference(b, s, t, h, g, d, win, causal):
    """The port's flash attention on the CPU (plain forward with LSE, then
    ``attention_bwd_ref``) against ``jax.grad`` of the reference's custom
    VJP on the loss sum(out^2): each gradient within 2e-4 of its largest
    value, tests/test_flash_model.py's limit."""
    rng = np.random.RandomState(s + t + d)
    q = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, g, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, g, d)).astype(np.float32)

    def f_ref(q, k, v):
        return (jax_flash.flash_attention(q, k, v, causal=causal, window=win,
                                          q_chunk=128, kv_chunk=256) ** 2).sum()

    want = jax.grad(f_ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tflash.flash_attention(*leaves, causal=causal, window=win)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for gt, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 1e-3       # the comparison is relative to it
        np.testing.assert_allclose(gt.numpy() / scale, w / scale, atol=2e-4)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_ref_is_autograd_of_attention_ref(causal, window, dtype):
    """f32: the direct backward equals autograd of the plain forward within
    1e-5 of each gradient's largest value.  bf16: the forward rounds P for
    P V and the backward rounds P and dS for the products that take them,
    so the two agree to bf16 rounding, 2^-6 of the largest value."""
    rng = np.random.RandomState(3)
    b, s, t, h, g, d = 2, 96, 96, 6, 2, 32
    ins = [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
           .to(dtype).requires_grad_(True)
           for shape in ((b, s, h, d), (b, t, g, d), (b, t, g, d))]
    out, lse = fref.attention_ref(*ins, causal=causal, window=window,
                                  return_lse=True)
    dout = torch.from_numpy(rng.normal(0, 1, out.shape).astype(np.float32)
                            ).to(dtype)
    want = torch.autograd.grad(out, ins, dout)
    got = fref.attention_bwd_ref(*(x.detach() for x in ins), out.detach(),
                                 lse.detach(), dout, causal=causal,
                                 window=window)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    for gt, w in zip(got, want):
        assert gt.dtype == w.dtype == dtype
        top = float(w.float().abs().max())
        assert top > 0.1
        assert float((gt.float() - w.float()).abs().max()) <= tol * top


def test_flash_lse_is_the_rows_logsumexp():
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(4, 1, 100, 4, 2, 16))
    _, lse = fops.flash_attention_fwd(q, k, v, window=30, return_lse=True)
    scores, _ = fref._scores(q, k, True, 30)
    want = torch.logsumexp(scores, dim=-1).permute(0, 3, 1, 2).reshape(lse.shape)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def test_flash_without_grad_takes_the_forward_alone():
    """Under no_grad (the serve path) or without inputs that need a
    gradient, flash_attention is the forward wrapper: same output, no LSE."""
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(5, 1, 64, 2, 1, 16))
    want = fops.flash_attention_fwd(q, k, v)
    assert torch.equal(tflash.flash_attention(q, k, v), want)
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        out = tflash.flash_attention(qg, k, v)
    assert out.grad_fn is None and torch.equal(out, want)
    out = tflash.flash_attention(qg, k, v)
    assert out.grad_fn is not None and torch.equal(out.detach(), want)


def test_ssd_chunked_grads_match_reference():
    """``ssd_chunked`` (its diagonal block through the SSD autograd
    Function) against ``jax.grad`` of the reference's einsum path, f32, on
    the loss sum(y * w) for a fixed random w: every input's gradient within
    1e-5 of its largest value."""
    rng = np.random.RandomState(0)
    b, l, h, p, n, g, chunk = 2, 32, 4, 8, 16, 2, 8
    x = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (b, l, h)).astype(np.float32)
    a = -rng.uniform(0.1, 1.0, (h,)).astype(np.float32)
    bm = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    w = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)

    def f_ref(*ins):
        return (jax_ssm.ssd_chunked(*ins[:3], ins[3], ins[4], chunk,
                                    kernel="xla") * w).sum()

    want = jax.grad(f_ref, argnums=tuple(range(5)))(
        *map(jnp.asarray, (x, dt, a, bm, cm)))
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, dt, a, bm, cm)]
    y = tssm.ssd_chunked(*leaves, chunk)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    for name, gt, wt in zip(("x", "dt", "a", "B", "C"), got, want):
        wt = np.asarray(wt)
        top = float(np.abs(wt).max())
        assert top > 0.1, name
        err = float(np.abs(gt.numpy() - wt).max())
        assert err <= 1e-5 * top, (name, err, top)


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """A chunk of 256 with dt·a near -1 a step puts exp of the masked
    exponent far past f32's range (cum spans about -180): masking before
    exp keeps the gradient finite."""
    rng = np.random.RandomState(1)
    ins = [torch.from_numpy(v) for v in _ssd_inputs(2, 1, 1, 256, 1, 2, 8, 8)]
    ins[2] = torch.cumsum(torch.full((1, 1, 256, 2), -0.7), dim=2)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    y = sops.ssd_diag(*leaves, 2, torch.float32)
    gy = torch.from_numpy(rng.normal(0, 1, y.shape).astype(np.float32))
    for gt in torch.autograd.grad(y, leaves, gy):
        assert torch.isfinite(gt).all()


# ---------------------------------------------------------------------------
# the backward kernel's limits
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def _flash_bwd_emulation(q, k, v, out, lse, dout, *, causal=True,
                         window=None, mutant=None):
    """The bf16 backward kernel's arithmetic (flash_attention/backward.cu)
    in PyTorch: S = Q K^T summed in another order than the plain version's
    (f64, rounded to f32), P = exp2(S scale log2e - lse log2e) in f32, D in
    f32, dS = P (dP - D) scale, P and dS rounded to bf16, and dK, dV
    accumulated in f32 over each query head's 64-row q tiles, dQ over
    128-key tiles, in the kernels' order.  ``mutant`` plants a fault:
    "skip_key_tile" (the dK/dV CTA of the 128 keys holding t/2 walks no q
    tile, so its dK, dV stay 0) or "drop_d" (D taken as 0)."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    r = h // g
    scale = 1 / math.sqrt(d)
    qg = q.double().reshape(b, s, g, r, d)
    sc = torch.einsum("bsgrd,btgd->bgrst", qg, k.double()).float()
    lse2 = (lse.float() * LOG2E).reshape(b, s, g, r).permute(0, 2, 3, 1)
    p = torch.exp2(sc * (scale * LOG2E) - lse2[..., None])
    if causal:
        p = torch.where(fref._mask(s, t, window, q.device), p, 0.0)
    do = dout.double().reshape(b, s, g, r, d)
    dvec = (do * out.double().reshape(b, s, g, r, d)).sum(-1).float()
    if mutant == "drop_d":
        dvec = torch.zeros_like(dvec)
    dp = torch.einsum("bsgrd,btgd->bgrst", do, v.double()).float()
    ds = p * (dp - dvec.permute(0, 2, 3, 1)[..., None]) * scale
    p16, ds16 = p.to(torch.bfloat16).double(), ds.to(torch.bfloat16).double()
    dk = torch.zeros(b, t, g, d)
    dv = torch.zeros(b, t, g, d)
    for rr in range(r):
        for q0 in range(0, s, 64):
            rows = slice(q0, q0 + 64)
            dv += torch.einsum("bgst,bsgd->btgd", p16[:, :, rr, rows],
                               do[:, rows, :, rr]).float()
            dk += torch.einsum("bgst,bsgd->btgd", ds16[:, :, rr, rows],
                               qg[:, rows, :, rr]).float()
    if mutant == "skip_key_tile":
        k0 = (t // 2) // 128 * 128
        dk[:, k0:k0 + 128] = 0
        dv[:, k0:k0 + 128] = 0
    dq = torch.zeros(b, s, g, r, d)
    for k0 in range(0, t, 128):
        dq += torch.einsum("bgrst,btgd->bsgrd", ds16[..., k0:k0 + 128],
                           k.double()[:, k0:k0 + 128]).float()
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("window", [None, 512])
def test_flash_bwd_limits_pass_the_kernels_arithmetic_and_fail_its_mutants(
        window):
    """At the depth of Llama 3.2 3B training (s 2048, d 128; fewer heads,
    GQA groups of 3): the kernel's arithmetic within the flash_bwd limit,
    a skipped key tile and a dropped D term far outside it (the card tests
    plant the same faults in the CUDA source)."""
    rng = np.random.RandomState(21)
    q, k, v, dout = (torch.from_numpy(rng.normal(0, 1, shape)
                                      .astype(np.float32)).to(torch.bfloat16)
                     for shape in ((1, 2048, 6, 128), (1, 2048, 2, 128),
                                   (1, 2048, 2, 128), (1, 2048, 6, 128)))
    out, lse = fref.attention_ref(q, k, v, window=window, return_lse=True)
    want = fref.attention_bwd_ref(q, k, v, out, lse, dout, window=window)
    worst = {}
    for mutant in (None, "skip_key_tile", "drop_d"):
        got = _flash_bwd_emulation(q, k, v, out, lse, dout, window=window,
                                   mutant=mutant)
        worst[mutant] = max(tolerance.kernel_excess("flash_bwd", g, w)
                            for g, w in zip(got, want))
    print(f"window {window}: worst error over its limit {worst}")
    assert worst[None] <= 0.5, "the kernel's arithmetic passes with room"
    assert worst["skip_key_tile"] > 20 and worst["drop_d"] > 20


@pytest.mark.parametrize("b,s,h,g,d,win", [(1, 1024, 4, 2, 64, None),
                                           (2, 512, 8, 2, 128, 128)])
def test_flash_bf16_grads_differ_from_the_reference_by_rounding(b, s, h, g, d,
                                                                win):
    """Port difference 4 (ROADMAP section 3): in bf16 the port rounds P and
    dS to bf16 before the products that take them, where the reference
    keeps them in f32 (and rounds S = Q K^T to bf16, the einsum's output
    type).  On bf16 inputs the two backwards' gradients lie within 2^-6 of
    the largest |reference| value (measured: at most 0.65%); a wrong mask
    or a dropped term is off by O(1)."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d)))
    w = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)

    def f_ref(q, k, v):
        out = jax_flash.flash_attention(q, k, v, causal=True, window=win)
        return (out.astype(jnp.float32) * w).sum()

    want = jax.grad(f_ref, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
              for x in (q, k, v)]
    out = tflash.flash_attention(*leaves, causal=True, window=win)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                              leaves)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        wt = np.asarray(wt, np.float32)
        top = float(np.abs(wt).max())
        err = float(np.abs(gt.float().numpy() - wt).max())
        print(f"{name}: max|port - reference| {err:.4g} of {top:.4g}")
        assert top > 0.5 and err <= 2.0 ** -6 * top


def test_ssd_chunked_grads_are_finite_where_the_references_are_not():
    """At Mamba2 2.7B's chunk of 256 with its init (a = -1, dt about 0.7)
    the decay exponent of a masked pair reaches about 180, past f32's exp
    range: the reference's einsum path takes exp before the mask, so its
    gradients of dt and a are NaN (0 * inf); the port masks first and its
    gradients are finite (ROADMAP section 3)."""
    rng = np.random.RandomState(0)
    b, l, h, p, n, g = 1, 256, 2, 8, 8, 1
    x = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)
    dt = np.full((b, l, h), 0.7, np.float32)
    a = -np.ones((h,), np.float32)
    bm = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    want = jax.grad(lambda *i: jax_ssm.ssd_chunked(*i, 256, kernel="xla")
                    .sum(), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, dt, a, bm, cm)))
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, dt, a, bm, cm)]
    got = torch.autograd.grad(tssm.ssd_chunked(*leaves, 256).sum(), leaves)
    assert [bool(np.isfinite(np.asarray(w)).all()) for w in want] == \
        [True, False, False, True, True]
    assert all(torch.isfinite(t).all() for t in got)
