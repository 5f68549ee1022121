"""The port's CUDA kernels (``mxu_iter``, ``stream_iter``, ``flash_fwd``,
``flash_bwd``, ``ssd_diag``, ``ssd_diag_bwd``) against their plain
versions, on a CUDA card (every test here skips without one); the SSD
gradient against plain autograd.  Imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_cuda.py

The flash and SSD kernels are held element by element to
``tolerance.KERNEL_TOL``, ``mxu_iter`` to sqrt(reps) bf16 ulps of its
largest output.  Faults planted in copies of their sources must fail that
limit by more than 10 times at the main path's shapes: a dropped key tile
and an accumulator that is not rescaled when the running maximum grows
(flash, Llama 3.2 3B prefill), a skipped key tile in dK/dV and the D term
dropped (the flash backward, Llama 3.2 3B training), a skipped key block
and plain TF32, the low part's product dropped (SSD, Mamba2 2.7B prefill),
a skipped row block of dX and the column sums of d(cum) dropped (the SSD
backward, Mamba2 2.7B training), one of a product's eight k-steps dropped
and the last turn skipped (``mxu_iter``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import blocks
from repro_torch.kernels import tolerance
from repro_torch.kernels.flash_attention import ops as fops, ref as fref
from repro_torch.kernels.proxy_blocks import ops as bops, ref as bref
from repro_torch.kernels.ssd import ops as sops, ref as sref
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

#: tests/test_kernels.py's sweeps, the smoke shapes, ragged lengths and the
#: main path's shapes (Llama 3.2 3B and Mamba2 2.7B prefill at batch 4,
#: 2048-token prompts)
FLASH_CASES = [
    (1, 256, 4, 2, 64, None, True), (2, 256, 2, 2, 128, 128, True),
    (1, 384, 4, 1, 64, None, True), (1, 512, 2, 1, 64, None, False),
    (2, 1024, 4, 2, 16, 16, True), (1, 77, 4, 2, 16, None, True),
    (2, 300, 4, 2, 32, None, True), (1, 1000, 2, 1, 64, None, False),
    (4, 2048, 24, 8, 128, None, True)]
SSD_CASES = [
    (1, 2, 32, 1, 4, 16, 16), (2, 2, 16, 2, 8, 8, 32), (1, 1, 64, 1, 12, 16, 16),
    (2, 4, 8, 1, 8, 16, 16), (4, 8, 256, 1, 80, 64, 128)]
#: faults planted in the bf16 flash kernel, as (text, replacement)
FLASH_MUTANTS = {
    # skip the tile of keys from s/2 for every query tile past it
    "drop_tile": ("      const int k0 = jt * kTile;\n",
                  "      const int k0 = jt * kTile;\n"
                  "      if (k0 == s / 2 && q0 >= k0 + kTile) {\n"
                  "        mbar_arrive(&empty[st]);\n"
                  "        continue;\n"
                  "      }\n"),
    # keep the accumulator at the old maximum's scale
    "stale_max": ("#pragma unroll\n"
                  "      for (int j = 0; j < D / 2; ++j) oacc[j] *= (j & 2) ? "
                  "corr1 : corr0;\n", ""),
}
#: the backward's cases as (b, s, t, h, g, d, window, causal): head dims 64
#: and 128, GQA groups of 1 and 3, windows, full attention, s != t, ragged
#: lengths, the smoke shapes (d 16) and Llama 3.2 3B training at batch 4
FLASH_BWD_CASES = [
    (1, 256, 256, 4, 4, 64, None, True), (2, 300, 300, 6, 2, 128, None, True),
    (1, 512, 512, 3, 1, 64, 128, True), (1, 384, 200, 4, 2, 64, None, False),
    (1, 200, 384, 4, 4, 128, None, False), (1, 300, 500, 6, 2, 64, None, True),
    (2, 1024, 1024, 4, 2, 16, 16, True), (1, 1000, 1000, 2, 1, 32, 300, True),
    (4, 2048, 2048, 24, 8, 128, None, True)]
#: faults planted in the flash backward, as (text, replacement)
FLASH_BWD_MUTANTS = {
    # the dK/dV CTA of the 128-key tile holding t/2 walks no q tile
    "skip_key_tile": ("  q_range(k0, kKeys, kRows, s, causal, window, poff, "
                      "&qlo, &qhi);\n",
                      "  q_range(k0, kKeys, kRows, s, causal, window, poff, "
                      "&qlo, &qhi);\n"
                      "  if (k0 == (t / 2) / kKeys * kKeys) qhi = qlo;\n"),
    # D = rowsum(dO o O) taken as 0
    "drop_d": ("    dvec[row] = p < s ? acc : 0.f;\n",
               "    dvec[row] = 0.f;\n"),
}
#: |lse - plain| <= LSE_RTOL * max(1, |plain|): f32 log-sum-exp over at
#: most 2048 terms in another order, and exp2 of log2-scaled scores against
#: exp, each about 1e-6 of the row's largest score; a log in the wrong base
#: or the maximum left in log2 units is off by O(1)
LSE_RTOL = 1e-4
#: faults planted in the SSD kernel, as (text, replacement)
SSD_MUTANTS = {
    # skip the key block just below the diagonal (J = I - 1): the decay
    # leaves blocks further back too small to see
    "skip_block": ("    const int jc = jb * kBJ;\n",
                   "    const int jc = jb * kBJ;\n"
                   "    if (jb == n_jb - 2) continue;\n"),
    # plain TF32: the low part's product dropped (bf16 x, the serve path)
    "tf32": ("          mma_b_2xtf32(acc[nt], ahi, alo, b);\n",
             "          mma_tf32(acc[nt], ahi, b);\n"),
}
#: faults planted in the SSD backward, as (text, replacement)
SSD_BWD_MUTANTS = {
    # U = m^T dY leaves out the row block just below each key block
    # (I = J + 1): dX and d(dt) of the keys near J's end lose most of
    # their terms
    "skip_block": ("        mma_3xtf32(uacc[nt], ahi, alo, bhi, blo);\n",
                   "        if (ib != 1) mma_3xtf32(uacc[nt], ahi, alo, bhi, "
                   "blo);\n"),
    # d(cum) without the column sums of G: the row sums alone
    "drop_colsum": ("      dcum[k] = s - dt[k] * ddt[k];\n",
                    "      dcum[k] = s;\n"),
}
#: the SSD gradient's f32-input cases: the small ones of SSD_CASES, groups
#: of one head (g = h, r = 1: the mesh trainer's re-indexed groups) and a
#: state of 20 (B and C rows not whole 16-byte pieces)
SSD_GRAD_F32_CASES = SSD_CASES[:-1] + [(1, 2, 32, 4, 1, 16, 16),
                                       (2, 2, 64, 8, 1, 32, 64),
                                       (1, 2, 96, 1, 4, 16, 20)]
#: bf16: groups of one head, the second a process's 40 Mamba2 heads as
#: their own groups, and a state of 20
SSD_GRAD_BF16_CASES = [(1, 2, 32, 4, 1, 16, 16), (1, 2, 256, 40, 1, 64, 128),
                     (1, 2, 96, 2, 2, 16, 20)]
#: faults planted in the mxu_iter kernel, as (text, replacement)
MXU_MUTANTS = {
    # the last of a product's eight k16 steps dropped, every turn
    "drop_kstep": ("      wgmma_rs_t<kMM>(acc, pa + 4 * kk,\n",
                   "      if (kk != kKSteps - 1) "
                   "wgmma_rs_t<kMM>(acc, pa + 4 * kk,\n"),
    # one turn fewer than asked for
    "skip_last_turn": ("  for (int turn = 0; turn < reps; ++turn) {\n",
                       "  for (int turn = 0; turn < reps - 1; ++turn) {\n"),
}


#: bf16 outputs of one turn: at most one bf16 ulp (8 significant bits) of
#: the largest output, held per case against max|want|.  Over ``reps``
#: turns the limit is sqrt(reps) times that: two correct versions that sum
#: in different orders round a few outputs to neighbouring bf16 values each
#: turn, and the orthogonal ``b`` of ``_mxu_inputs`` carries those
#: differences forward without growing them, so they add like a random walk
#: (the CUDA kernel against cuBLAS on an H100: 0.0244 at reps 32, max|want|
#: 2.47).  On the CPU the port and the reference agree exactly.
MXU_RTOL = 2.0 ** -7


def _mxu_inputs(seed: int, scale: float = bref.MXU_SCALE,
                batch: tuple = ()):
    """``a`` ~ U(-1, 1) and ``b`` an orthogonal matrix divided by ``scale``,
    so each turn ``a <- bf16(a @ b * scale)`` keeps the norm of every row of
    ``a``: the outputs stay O(1) over any number of turns, and a kernel that
    runs too few turns, drops the scale or sums in bf16 misses by far more
    than the tolerance."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, batch + (bref.MM, bref.MM)).astype(np.float32)
    q, r = np.linalg.qr(rng.standard_normal(batch + (bref.MM, bref.MM)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    return a, (q / scale).astype(np.float32)


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def mxu_excess(got, want, reps: int = 1, min_top: float = 0.5) -> float:
    """max|got - want| over its limit, sqrt(reps) * MXU_RTOL * max|want|:
    at most 1 passes.  ``want`` must reach ``min_top`` or the comparison
    says nothing (the main path's own state shrinks about 20-fold a turn,
    so it is held with a smaller ``min_top``)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    assert top >= min_top, f"outputs decayed to {top}: the comparison says nothing"
    err = float(np.abs(got - want).max())
    return err / (max(reps, 1) ** 0.5 * MXU_RTOL * top)


def assert_mxu_close(got, want, reps: int = 1, min_top: float = 0.5) -> None:
    excess = mxu_excess(got, want, reps, min_top)
    assert excess <= 1, f"max|got - want| is {excess:.3g} times the limit"


#: turns per piece of the long chain's check (reps 4096 in 64 launches)
MXU_PIECE = 64


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks there)")


def _flash_inputs(seed, b, s, h, g, d, dtype):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
                 .to("cuda", dtype)
                 for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d)))


def _ssd_inputs(seed, b, c, q, g, r, p, n, dtype):
    """tests/test_kernels.py's distributions."""
    rng = np.random.RandomState(seed)
    h = g * r
    x = rng.normal(0, 1, (b, c, q, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (b, c, q, h)).astype(np.float32)
    adt = -rng.uniform(0.01, 0.5, (b, c, q, h)).astype(np.float32)
    cum = np.cumsum(adt, axis=2, dtype=np.float32)
    bm = rng.normal(0, 1, (b, c, q, g, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, c, q, g, n)).astype(np.float32)
    cuda = [torch.from_numpy(a).cuda() for a in (x, dt, cum, bm, cm)]
    return (cuda[0].to(dtype), cuda[1], cuda[2], cuda[3].to(dtype),
            cuda[4].to(dtype))


def _excess(name, got, want) -> float:
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float(want.float().abs().max()) > 0.1
    return tolerance.kernel_excess(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,g,d,win,causal", FLASH_CASES)
def test_cuda_flash_kernel_matches_plain(b, s, h, g, d, win, causal, dtype):
    q, k, v = _flash_inputs(s + d, b, s, h, g, d, dtype)
    got = fops.flash_attention_fwd(q, k, v, causal=causal, window=win)
    want = fref.attention_ref(q, k, v, causal=causal, window=win)
    assert _excess("flash_fwd", got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,q,g,r,p,n", SSD_CASES)
def test_cuda_ssd_kernel_matches_plain(b, c, q, g, r, p, n, dtype):
    ins = _ssd_inputs(q + r, b, c, q, g, r, p, n, dtype)
    for out_dtype in (None, torch.float32):
        got = sops.ssd_diag_block(*ins, r, out_dtype=out_dtype)
        want = sref.ssd_diag_ref(*ins, r, out_dtype=out_dtype)
        assert _excess("ssd_diag", got, want) <= 1


def _with_mutants(tmp_path, monkeypatch, ops, mutants, run,
                  attr: str = "SOURCE") -> dict:
    """``run()``'s worst error over its limit for the kernel, then for a
    copy of its source (``ops.<attr>``) with each fault of ``mutants``
    planted (built and loaded in place of the kernel)."""
    worst = {"kernel": run()}
    source = getattr(ops, attr)
    text = source.read_text()
    for name, (old, new) in mutants.items():
        assert text.count(old) == 1, f"{name}: the text to change is gone"
        src = tmp_path / name / source.parent.name / source.name
        src.parent.mkdir(parents=True)
        src.write_text(text.replace(old, new))
        monkeypatch.setattr(ops, attr, src)
        worst[name] = run()
    monkeypatch.undo()
    return worst


def _bwd_inputs(seed, b, s, t, h, g, d, dtype, window, causal):
    """q, k, v, dout ~ N(0, 1) and the plain forward's out and lse."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
                   .to("cuda", dtype) for shape in
                   ((b, s, h, d), (b, t, g, d), (b, t, g, d), (b, s, h, d)))
    out, lse = fref.attention_ref(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    return q, k, v, out, lse, do


def _bwd_excess(got, want) -> float:
    return max(_excess("flash_bwd", g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,g,d,win,causal,dtype", [
    case + (dtype,) for case in FLASH_BWD_CASES
    for dtype in ((torch.bfloat16,) if case == FLASH_BWD_CASES[-1]
                  else (torch.float32, torch.bfloat16))])
def test_cuda_flash_bwd_matches_plain(b, s, t, h, g, d, win, causal, dtype):
    """Every case in both dtypes but the main shape, which runs in bf16 (the
    training path's dtype) only."""
    ins = _bwd_inputs(s + t + d, b, s, t, h, g, d, dtype, win, causal)
    kw = dict(causal=causal, window=win)
    got = fops.flash_attention_bwd(*ins, **kw)
    want = fref.attention_bwd_ref(*ins, **kw)
    assert _bwd_excess(got, want) <= 1
    again = fops.flash_attention_bwd(*ins, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        "two calls differ: the backward must be deterministic"


#: a "cp" block of query rows against every key: (b, s, t, h, g, d, window,
#: causal, q_offset), the last the Llama 3.2 3B training shape's second half
FLASH_OFFSET_CASES = [(2, 256, 1024, 4, 2, 64, None, True, 512),
                      (1, 333, 1000, 4, 2, 64, 129, True, 600),
                      (1, 100, 1000, 4, 4, 32, None, True, 37),
                      (2, 256, 1024, 4, 2, 128, None, False, 768),
                      (4, 1024, 2048, 24, 8, 128, None, True, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,g,d,win,causal,off", FLASH_OFFSET_CASES)
def test_cuda_flash_with_q_offset_matches_plain(b, s, t, h, g, d, win,
                                                causal, off, dtype):
    """``flash_fwd`` (with its LSE) and ``flash_bwd`` given ``q_offset``
    against their plain versions given it, within their limits; at offset
    0 each call equals the call without the argument bit for bit."""
    rng = np.random.RandomState(off + s)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, shape).astype(
        np.float32)).to("cuda", dtype) for shape in
        ((b, s, h, d), (b, t, g, d), (b, t, g, d), (b, s, h, d)))
    kw = dict(causal=causal, window=win)
    out, lse = fops.flash_attention_fwd(q, k, v, return_lse=True,
                                        q_offset=off, **kw)
    want, want_lse = fref.attention_ref(q, k, v, return_lse=True,
                                        q_offset=off, **kw)
    assert _excess("flash_fwd", out, want) <= 1
    err = (lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)
    assert float(err.max()) <= LSE_RTOL
    got = fops.flash_attention_bwd(q, k, v, out, lse, do, q_offset=off, **kw)
    wantg = fref.attention_bwd_ref(q, k, v, out, lse, do, q_offset=off, **kw)
    assert _bwd_excess(got, wantg) <= 1
    o0, l0 = fops.flash_attention_fwd(q, k, v, return_lse=True, q_offset=0,
                                      **kw)
    o1, l1 = fops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    assert torch.equal(o0, o1) and torch.equal(l0, l1)
    assert all(torch.equal(x, y) for x, y in zip(
        fops.flash_attention_bwd(q, k, v, o0, l0, do, q_offset=0, **kw),
        fops.flash_attention_bwd(q, k, v, o0, l0, do, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,g,d,win,causal", FLASH_CASES)
def test_cuda_flash_lse_matches_plain_and_leaves_out_unchanged(
        b, s, h, g, d, win, causal, dtype):
    q, k, v = _flash_inputs(s + d + 1, b, s, h, g, d, dtype)
    out, lse = fops.flash_attention_fwd(q, k, v, causal=causal, window=win,
                                        return_lse=True)
    plain = fops.flash_attention_fwd(q, k, v, causal=causal, window=win)
    assert torch.equal(out, plain), "asking for the LSE changed the output"
    _, want = fref.attention_ref(q, k, v, causal=causal, window=win,
                                 return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (b, s, h) and lse.dtype == torch.float32
    err = (lse - want).abs() / want.abs().clamp_min(1.0)
    assert float(err.max()) <= LSE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 512])
def test_cuda_flash_bwd_mutants_fail_the_limit(tmp_path, monkeypatch, window):
    """The backward and two faulty copies of its source at the Llama 3.2 3B
    training shape: the kernel within its limit, each copy more than 10
    times outside it (the CPU emulation: 40 times or more)."""
    ins = _bwd_inputs(9, 4, 2048, 2048, 24, 8, 128, torch.bfloat16, window,
                      True)
    want = fref.attention_bwd_ref(*ins, window=window)
    worst = _with_mutants(
        tmp_path, monkeypatch, fops, FLASH_BWD_MUTANTS,
        lambda: _bwd_excess(fops.flash_attention_bwd(*ins, window=window),
                            want), attr="BWD_SOURCE")
    print(f"window {window}: worst error over its limit {worst}")
    assert worst["kernel"] <= 1
    assert worst["skip_key_tile"] > 10 and worst["drop_d"] > 10


def _ssd_grads(ins, r, gy, fn) -> tuple:
    """The five input gradients of ``fn(*ins, r, f32)`` against ``gy``."""
    leaves = [x.detach().requires_grad_(True) for x in ins]
    return torch.autograd.grad(fn(*leaves, r, torch.float32), leaves, gy)


def _ssd_grad_excess(got, want) -> dict:
    """Each gradient's worst error over its ``ssd_diag_bwd`` limit."""
    out = {}
    for name, a, w in zip(("x", "dt", "cum", "B", "C"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.isfinite(a.float()).all()
        out[name] = _excess("ssd_diag_bwd", a, w)
    return out


def _check_ssd_gradient(b, c, q, g, r, p, n, dtype):
    """``ssd_diag`` under autograd: the kernel's forward (the bits of
    ``ssd_diag_block``), one launch of the hand-written backward, every
    gradient within its limit of plain autograd through ``ssd_diag_ref``,
    and the same bits from a second call."""
    ins = _ssd_inputs(q + r + 1, b, c, q, g, r, p, n, dtype)
    gy = torch.randn(ins[0].shape, generator=torch.Generator("cuda")
                     .manual_seed(q), device="cuda")
    sops.reset_counts()
    leaves = [x.detach().requires_grad_(True) for x in ins]
    y = sops.ssd_diag(*leaves, r, torch.float32)
    got = torch.autograd.grad(y, leaves, gy)
    assert sops.LAUNCHES == {"ssd_diag": 1, "ssd_diag_bwd": 1}
    with torch.no_grad():
        assert torch.equal(y, sops.ssd_diag_block(*ins, r, torch.float32))
    want = _ssd_grads(ins, r, gy, sref.ssd_diag_ref)
    worst = _ssd_grad_excess(got, want)
    print(f"{(b, c, q, g, r, p, n)} {str(dtype)[6:]}: worst error over the "
          f"limit {worst}")
    assert max(worst.values()) <= 1
    again = sops.ssd_diag_bwd(*ins, r, gy)
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        "two calls differ: the backward must be deterministic"


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,q,g,r,p,n", SSD_CASES)
def test_cuda_ssd_gradient_matches_plain_autograd(b, c, q, g, r, p, n):
    """bf16 inputs (the model's) at every SSD_CASES shape, the Mamba2 2.7B
    training shape last: within ``ssd_diag_bwd``'s limits (the backward
    was plain autograd, and equal to it, before it had a kernel)."""
    _check_ssd_gradient(b, c, q, g, r, p, n, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,q,g,r,p,n,dtype", [
    case + (torch.float32,) for case in SSD_GRAD_F32_CASES] + [
    case + (torch.bfloat16,) for case in SSD_GRAD_BF16_CASES])
def test_cuda_ssd_gradient_f32_and_one_head_groups(b, c, q, g, r, p, n,
                                                   dtype):
    """f32 inputs (the smoke configs), groups of one head and a state
    that is not a multiple of 8."""
    _check_ssd_gradient(b, c, q, g, r, p, n, dtype)


@pytest.mark.cuda
def test_cuda_ssd_bwd_mutants_fail_the_limit(tmp_path, monkeypatch):
    """The backward and two faulty copies of its source at the Mamba2 2.7B
    training shape: the kernel within every gradient's limit; the skipped
    row block more than 10 times outside it in dX and the dropped column
    sums in d(cum) (the CPU emulation: thousands of times)."""
    r = 80
    ins = _ssd_inputs(11, 4, 8, 256, 1, r, 64, 128, torch.bfloat16)
    gy = torch.randn(ins[0].shape, generator=torch.Generator("cuda")
                     .manual_seed(3), device="cuda")
    want = _ssd_grads(ins, r, gy, sref.ssd_diag_ref)
    worst = _with_mutants(
        tmp_path, monkeypatch, sops, SSD_BWD_MUTANTS,
        lambda: _ssd_grad_excess(sops.ssd_diag_bwd(*ins, r, gy), want),
        attr="BWD_SOURCE")
    print(f"worst error over its limit {worst}")
    assert max(worst["kernel"].values()) <= 1
    assert worst["skip_block"]["x"] > 10
    assert worst["drop_colsum"]["cum"] > 10


@pytest.mark.cuda
def test_cuda_mamba2_train_step_runs_the_ssd_backward(tmp_path):
    """One smoke Mamba2 training step on the card: the backward kernel once
    per SSM layer (and the forward twice: the step and, with remat, its
    recompute; once without)."""
    from repro_torch.configs import get, smoke
    from repro_torch.train.loop import Trainer

    cfg = smoke(get("mamba2-2.7b"))
    trainer = Trainer(cfg, global_batch=2, seq_len=64, device="cuda",
                      ckpt_dir=tmp_path)
    sops.reset_counts()
    trainer.run(1)
    torch.cuda.synchronize()
    fwd = (2 if cfg.remat else 1) * cfg.n_layers
    assert sops.LAUNCHES == {"ssd_diag": fwd, "ssd_diag_bwd": cfg.n_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 512])
def test_cuda_flash_mutants_fail_the_limit(tmp_path, monkeypatch, window):
    """The kernel and two faulty copies of its source on the same inputs at
    the Llama 3.2 3B prefill shape: the kernel within its limit, each copy
    far outside it."""
    q, k, v = _flash_inputs(5, 4, 2048, 24, 8, 128, torch.bfloat16)
    want = fref.attention_ref(q, k, v, window=window)
    worst = _with_mutants(tmp_path, monkeypatch, fops, FLASH_MUTANTS,
                          lambda: _excess("flash_fwd", fops.flash_attention_fwd(
                              q, k, v, window=window), want))
    print(f"window {window}: worst error over its limit {worst}")
    assert worst["kernel"] <= 1
    assert worst["drop_tile"] > 10 and worst["stale_max"] > 10


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_mutants_fail_the_limit(tmp_path, monkeypatch, out_dtype):
    """The kernel and two faulty copies of its source at the Mamba2 2.7B
    prefill shape (bf16 in): a skipped key block and plain TF32 each miss
    the limit by more than 10 times in f32 (a bf16 output rounds away the
    TF32 fault, so only the skipped block is held there)."""
    ins = _ssd_inputs(7, 4, 8, 256, 1, 80, 64, 128, torch.bfloat16)
    want = sref.ssd_diag_ref(*ins, 80, out_dtype=out_dtype)
    worst = _with_mutants(tmp_path, monkeypatch, sops, SSD_MUTANTS,
                          lambda: _excess("ssd_diag", sops.ssd_diag_block(
                              *ins, 80, out_dtype=out_dtype), want))
    print(f"{out_dtype}: worst error over its limit {worst}")
    assert worst["kernel"] <= 1
    assert worst["skip_block"] > 10
    if out_dtype == torch.float32:
        assert worst["tf32"] > 10


@pytest.mark.cuda
def test_cuda_zoo_empty_inputs_launch_nothing_and_views_are_copied():
    fops.reset_counts()
    sops.reset_counts()
    q = torch.randn(1, 0, 2, 16, device="cuda")
    k = torch.randn(1, 8, 1, 16, device="cuda")
    assert fops.flash_attention_fwd(q, k, k).shape == q.shape
    ins = _ssd_inputs(0, 0, 1, 8, 1, 2, 16, 16, torch.float32)
    assert sops.ssd_diag_block(*ins, 2).numel() == 0
    assert fops.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}
    gy = torch.zeros(ins[0].shape, device="cuda")
    assert all(x.numel() == 0 for x in sops.ssd_diag_bwd(*ins, 2, gy))
    assert sops.LAUNCHES == {"ssd_diag": 0, "ssd_diag_bwd": 0}
    q, k, v = _flash_inputs(2, 1, 65, 2, 1, 16, torch.float32)
    flat = torch.zeros(q.numel() + 1, device="cuda")
    flat[1:] = q.flatten()
    view = flat[1:].view(q.shape)
    assert view.data_ptr() % 16
    assert torch.equal(fops.flash_attention_fwd(view, k, v),
                       fops.flash_attention_fwd(q, k, v))


def _cpu(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [0, 1, 5, 7, 32, 4096])
def test_cuda_mxu_kernel_matches_plain(reps):
    """One item, a batch of 3 with a shared ``b`` and with one ``b`` per
    item (the per-rank-seeds replay), and the main path's own state."""
    cases = []
    for scale in (bref.MXU_SCALE, 1.0):
        for batch, shared in (((), True), ((3,), True), ((3,), False)):
            a, b = _mxu_inputs(reps + len(batch) + shared, scale, batch)
            b = b[0] if batch and shared else b
            cases.append((_bf16(a).cuda(), _bf16(b).cuda(), scale, 0.5))
    st = blocks.init_state(0, "cuda")
    if reps <= 7:           # it shrinks about 20-fold a turn
        cases.append((st["a"], st["b"], 1.0, 1e-30))
    for a, b, scale, min_top in cases:
        got = bops.mxu_iter(a, b, reps, scale)
        if reps == 0:
            assert torch.equal(got, a)
            continue
        want = bref.mxu_ref(a, b, reps, scale)
        assert_mxu_close(_cpu(got), _cpu(want), reps, min_top)
        # the last turn alone, at the one-turn limit
        last = bref.mxu_ref(bops.mxu_iter(a, b, reps - 1, scale), b, 1, scale)
        assert_mxu_close(_cpu(got), _cpu(last), 1, min_top)
        if reps > MXU_PIECE:
            # sqrt(4096) ulps is half the largest output, so the long chain
            # is also held in pieces: the kernel is deterministic, so one
            # launch of reps turns equals reps / 64 launches of 64 bit for
            # bit, and each piece is held to the plain chain restarted from
            # the kernel's own output, at the 64-turn limit
            x = a
            for _ in range(reps // MXU_PIECE):
                nxt = bops.mxu_iter(x, b, MXU_PIECE, scale)
                assert_mxu_close(_cpu(nxt), _cpu(bref.mxu_ref(
                    x, b, MXU_PIECE, scale)), MXU_PIECE, min_top)
                x = nxt
            assert torch.equal(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [5, 32])
def test_cuda_mxu_mutants_fail_the_limit(tmp_path, monkeypatch, reps):
    """The kernel and two faulty copies of its source on orthogonal-``b``
    inputs at both scales: the kernel within sqrt(reps) * 2^-7 *
    max|plain|, a dropped k-step and a skipped turn each more than 10
    times over it (CPU estimate of the two faults: 36x and 71x at reps 5,
    22x and 32x at reps 32)."""
    ins = []
    for scale in (bref.MXU_SCALE, 1.0):
        a, b = _mxu_inputs(reps, scale)
        a, b = _bf16(a).cuda(), _bf16(b).cuda()
        ins.append((a, b, scale, _cpu(bref.mxu_ref(a, b, reps, scale))))

    def run():
        return max(mxu_excess(_cpu(bops.mxu_iter(a, b, reps, scale)), want,
                              reps) for a, b, scale, want in ins)

    worst = _with_mutants(tmp_path, monkeypatch, bops, MXU_MUTANTS, run)
    print(f"reps {reps}: worst error over its limit {worst}")
    assert worst["kernel"] <= 1
    assert worst["drop_kstep"] > 10 and worst["skip_last_turn"] > 10


@pytest.mark.cuda
@pytest.mark.parametrize("n,reps", [(2048, 3), (4096, 17), (32768, 5)])
def test_cuda_stream_kernel_is_bit_exact(n, reps):
    v = torch.rand(n, generator=torch.Generator().manual_seed(n)).cuda()
    assert torch.equal(bops.stream_iter(v, reps), bref.stream_ref(v, reps))


@pytest.mark.cuda
def test_cuda_misaligned_views_are_realigned():
    """The kernels load 16-byte vectors; a contiguous view that starts off
    a 16-byte boundary is copied first instead of faulting."""
    big = torch.rand(4096 + 1, device="cuda")
    v = big[1:]
    assert v.is_contiguous() and v.data_ptr() % 16
    assert torch.equal(bops.stream_iter(v, 3), bref.stream_ref(v, 3))
    a, b = _mxu_inputs(0)
    flat = torch.zeros(bref.MM * bref.MM + 1, dtype=torch.bfloat16,
                       device="cuda")
    flat[1:] = _bf16(a).cuda().flatten()
    a_view = flat[1:].view(bref.MM, bref.MM)
    assert a_view.data_ptr() % 16
    b = _bf16(b).cuda()
    assert torch.equal(bops.mxu_iter(a_view, b, 5),
                       bops.mxu_iter(a_view.clone(), b, 5))


@pytest.mark.cuda
def test_cuda_empty_inputs_launch_nothing():
    bops.reset_counts()
    a = torch.empty(0, bref.MM, bref.MM, dtype=torch.bfloat16, device="cuda")
    b = torch.empty(bref.MM, bref.MM, dtype=torch.bfloat16, device="cuda")
    assert bops.mxu_iter(a, b, 3).shape == a.shape
    assert bops.stream_iter(torch.empty(0, 1024, device="cuda"), 3).numel() == 0
    assert bops.LAUNCHES == {"mxu_iter": 0, "stream_iter": 0}


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_input_and_launch_nothing():
    """A CUDA tensor launches or raises: a wrong device, dtype or shape, or
    reps < 0, raises before any launch, and nothing falls back to the
    plain version."""
    bops.reset_counts()
    a = torch.zeros(bref.MM, bref.MM, dtype=torch.bfloat16, device="cuda")
    bad_mxu = [((a, a.cpu(), 1), ValueError), ((a.cpu(), a, 1), ValueError),
               ((a.float(), a, 1), TypeError), ((a, a.float(), 1), TypeError),
               ((a[:64], a, 1), ValueError), ((a, a[:, :64], 1), ValueError),
               ((a, a.expand(2, -1, -1), 1), ValueError),
               ((a, a, -1), ValueError)]
    for args, err in bad_mxu:
        with pytest.raises(err):
            bops.mxu_iter(*args)
    v = torch.zeros(2048, device="cuda")
    bad_stream = [((v.double(), 1), TypeError), ((v[:1000], 1), ValueError),
                  ((v[0], 1), ValueError), ((v, -1), ValueError)]
    for args, err in bad_stream:
        with pytest.raises(err):
            bops.stream_iter(*args)
    assert bops.LAUNCHES == {"mxu_iter": 0, "stream_iter": 0}
