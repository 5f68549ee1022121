"""The flash-attention and SSD CUDA kernels against their plain versions,
on a CUDA card (every test here skips without one).  Imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held element by element to ``tolerance.KERNEL_TOL``.  Two
faults planted in a copy of the flash kernel's source, a dropped key tile
and an accumulator that is not rescaled when the running maximum grows,
must fail that limit at the Llama 3.2 3B prefill shape.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import tolerance
from repro_torch.kernels.flash_attention import ops as fops, ref as fref
from repro_torch.kernels.ssd import ops as sops, ref as sref

#: tests/test_kernels.py's sweeps, the smoke shapes, ragged lengths and the
#: main path's shapes (Llama 3.2 3B and Mamba2 2.7B prefill at batch 4,
#: 2048-token prompts)
FLASH_CASES = [
    (1, 256, 4, 2, 64, None, True), (2, 256, 2, 2, 128, 128, True),
    (1, 384, 4, 1, 64, None, True), (1, 512, 2, 1, 64, None, False),
    (2, 1024, 4, 2, 16, 16, True), (1, 77, 4, 2, 16, None, True),
    (4, 2048, 24, 8, 128, None, True)]
SSD_CASES = [
    (1, 2, 32, 1, 4, 16, 16), (2, 2, 16, 2, 8, 8, 32), (1, 1, 64, 1, 12, 16, 16),
    (2, 4, 8, 1, 8, 16, 16), (4, 8, 256, 1, 80, 64, 128)]
#: faults planted in the bf16 flash kernel, as (text, replacement)
FLASH_MUTANTS = {
    # skip the tile of keys from s/2 for every query block past it
    "drop_tile": ("    const int k0 = jt * kBK;\n",
                  "    const int k0 = jt * kBK;\n"
                  "    if (k0 == s / 2 && q0 >= k0 + kBK) continue;\n"),
    # keep the accumulator at the old maximum's scale
    "stale_max": ("    for (int c = half; c < D; c += 2) orow[c] *= corr;\n",
                  ""),
}


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


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 512])
def test_cuda_flash_mutants_fail_the_limit(tmp_path, monkeypatch, window):
    """The kernel and two faulty copies of its source on the same inputs at
    the Llama 3.2 3B prefill shape: the kernel within its limit, each copy
    far outside it."""
    q, k, v = _flash_inputs(5, 4, 2048, 24, 8, 128, torch.bfloat16)
    want = fref.attention_ref(q, k, v, window=window)
    worst = {"kernel": _excess("flash_fwd", fops.flash_attention_fwd(
        q, k, v, window=window), want)}
    text = fops.SOURCE.read_text()
    for name, (old, new) in FLASH_MUTANTS.items():
        assert text.count(old) == 1, f"{name}: the text to change is gone"
        src = tmp_path / name / "flash_attention" / "kernel.cu"
        src.parent.mkdir(parents=True)
        src.write_text(text.replace(old, new))
        monkeypatch.setattr(fops, "SOURCE", src)
        worst[name] = _excess("flash_fwd", fops.flash_attention_fwd(
            q, k, v, window=window), want)
    monkeypatch.undo()
    print(f"window {window}: worst error over its limit {worst}")
    assert worst["kernel"] <= 1
    assert worst["drop_tile"] > 10 and worst["stale_max"] > 10


@pytest.mark.cuda
def test_cuda_zoo_empty_inputs_launch_nothing_and_views_are_copied():
    fops.reset_counts()
    sops.reset_counts()
    q = torch.randn(1, 0, 2, 16, device="cuda")
    k = torch.randn(1, 8, 1, 16, device="cuda")
    assert fops.flash_attention_fwd(q, k, k).shape == q.shape
    ins = _ssd_inputs(0, 0, 1, 8, 1, 2, 16, 16, torch.float32)
    assert sops.ssd_diag_block(*ins, 2).numel() == 0
    assert fops.LAUNCHES == {"flash_fwd": 0}
    assert sops.LAUNCHES == {"ssd_diag": 0}
    q, k, v = _flash_inputs(2, 1, 65, 2, 1, 16, torch.float32)
    flat = torch.zeros(q.numel() + 1, device="cuda")
    flat[1:] = q.flatten()
    view = flat[1:].view(q.shape)
    assert view.data_ptr() % 16
    assert torch.equal(fops.flash_attention_fwd(view, k, v),
                       fops.flash_attention_fwd(q, k, v))
