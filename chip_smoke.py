"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --launch-cost OLD . . OLD    # only the launch path
    python3 chip_smoke.py --flash-bwd-vs OLD . . OLD   # only flash_bwd

Builds the hand-written CUDA kernels from the sources in this checkout
(printing each kernel's ptxas register and spill line, and failing unless
the tensor-core kernels use the engines their design names: SASS
``HGMMA`` and ``UTMALDG`` and no ``HMMA`` in both bf16 ``flash_bwd``
kernels, ``HGMMA`` and no ``HMMA`` in ``mxu_iter``), holds each kernel
against its plain PyTorch version, and drives the port's
paths on the card, checking that each went through its kernels:

- slice 1: synthesize → run_all → fidelity on the 64-rank synthetic trace
  (51,204 events), through ``mxu_iter`` and ``stream_iter``;
- slice 2: ``ServeEngine.generate`` on Llama 3.2 3B (through ``flash_fwd``)
  and Mamba2 2.7B (through ``ssd_diag``) at full width and depth, bf16,
  random weights from a seed, batch 4, 2048-token prompts, 32 new tokens,
  with a prefill/decode consistency check on each (and on each Mamba2
  layer alone); then the three smoke configs on the card against the CPU;
- slice 5: ``Trainer.run`` on Llama 3.2 3B (through ``flash_fwd`` with the
  row log-sum-exp and ``flash_bwd``) and Mamba2 2.7B (through ``ssd_diag``
  and the plain SSD backward) at full width and depth, bf16, random weights
  from seed 0, batch 4 x 2048 tokens, 3 steps each, with a check that 3
  steps on one fixed batch lower its loss each step; one training step of
  the three smoke configs on the card against the CPU; and a crash/resume
  of the smoke Llama that must equal the uninterrupted run bit for bit;
- slice 7: the tracer front end: ``synthesize(fn, *args, axis_sizes=...)``
  of the paper's programs (stencil2d, dp_train; pipeline from its
  TraceSession) and the three ported zoo scenarios (transformer-dp,
  flash-ring, ssm-decode) at their defaults, each replayed and scored on
  the card, with comm lossless, the proxy-block launches the fit and the
  grammar predict, and the TraceStore and delta_bar of the same run on the
  CPU; then the walker's costs of the full Llama 3.2 3B and Mamba2 2.7B
  prefill, decode and train steps (batch 4 x 2048), which launch nothing;
- slice 8: the MoE family and the encoder-decoder.  ``flash_fwd`` at
  DeepSeek-MoE 16B's shape (MHA, 16 heads of 128, causal) and at Whisper
  large-v3's encoder shape (20 heads of 64, 1500 frames, unmasked) and
  ``flash_bwd`` at the latter, against their plain versions;
  ``ServeEngine.generate`` on DeepSeek-MoE 16B (batch 4, 2048-token
  prompts, 32 new tokens, capacity factor 1.25; 28 ``flash_fwd``) with the
  share of dropped and emptied expert picks, and on Whisper large-v3
  (batch 4, the reference engine's zero frames, 416-token prompts, 32 new
  tokens: 448 positions; 32 ``flash_fwd``, the encoder's), each with its
  prefill/decode consistency (DeepSeek's at capacity factor
  n_experts / top_k, where nothing drops; its f32 check at a cut depth);
  ``Trainer.run`` on Whisper large-v3 at full width (batch 4 x 448 tokens,
  1500 random frames) and on DeepSeek-MoE 16B at full width and a cut
  depth (``DEEPSEEK_TRAIN_LAYERS``); the MoE and encoder-decoder smoke
  configs on the card against the CPU (serve, one training step,
  crash/resume); the ``moe-ep`` and ``encdec-pipeline`` scenarios in the
  trace phase, and the walker's DeepSeek and Whisper prefill and decode.

Then it times every kernel against its plain version, its bound and, where
one PyTorch call computes the same function, that call; for the two
proxy-block kernels, whose launches at the main path's reps 5 cost the
host more than the device, also the profiler's device time per launch and
the wrapper's host time per call.  Imports nothing
of JAX or of the JAX package.  Exits non-zero, printing no result, without
a CUDA device or outside a checkout of the repository.  The last line of
its output is ``{"ok": true, "device": {...}}``.

``--launch-cost TREE ...`` runs nothing of the above: it times, in a fresh
process for each checkout named and in that order, the proxy-block
wrappers' host cost per call and ``run_all`` (:func:`launch_cost`), and
writes the runs to ``build/launch_cost.json`` of this checkout.
``--flash-bwd-vs TREE ...`` likewise runs only ``flash_bwd`` built from
each checkout's ``backward.cu``, at the main shape, in that order
(:func:`phase_flash_bwd_versus`).
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published peaks of one H100 SXM (NVIDIA data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

#: δ̄ of the JAX reference on this trace (tests/test_torch_slice.py holds
#: the port to the live reference on the CPU)
REFERENCE_DELTA = 0.006768716933820147
N_RANKS = 64
#: bf16 outputs of one turn: at most one bf16 ulp (8 significant bits) of
#: the largest output, max|got - want| <= MXU_RTOL * max|want|.  Over reps
#: turns the limit is sqrt(reps) times that: the kernel and cuBLAS sum in
#: other orders, so each turn rounds a few outputs to the neighbouring bf16
#: value, and an orthogonal b carries those differences forward without
#: growing them, so they add like a random walk (see check_mxu)
MXU_RTOL = 2.0 ** -7
#: turns per piece when a long chain is checked piece by piece
MXU_PIECE = 64
STATE_ATOL = 1e-4  # f32 leaves, CUDA vs CPU: see check_states

SERVE_BATCH = 4
SERVE_NEW = 32
#: consistency: the last position's logits from a 2048-token prefill
#: against a 1792-token prefill then 256 teacher-forced decode steps, as a
#: share of max|logits|.  The two run the same weights through other
#: operations (flash or the chunked SSD against the cache paths).  In f32
#: they differ by f32 rounding (the smoke configs on the CPU: 1e-7 of the
#: logits); a wrong position, a cache written to the wrong slot or a
#: dropped state is off by O(1).  In bf16 they differ by bf16 rounding
#: carried through every layer: Llama's 28 layers keep that within a few
#: percent.  Mamba2's 64 layers of random weights amplify it until the two
#: sets of logits have little left in common (on an H100: 0.455 of
#: max|logits|), and the reference's own model does the same: at 64 layers
#: of d 128 it drifts 0.442 (tests/test_torch_serve.py::test_bf16_drift_
#: is_the_reference_models[64], which also holds the port's drift within a
#: factor 2 of it).  So the whole Mamba2 model is held in bf16 to twice the
#: reference's figure, which a fault as large as a lost state fails (the
#: check prints, for scale, how far the logits of unrelated prompts lie), and
#: each of its layers is held on its own (check_ssm_layers): fed the same
#: input, one layer's prefill and decode differ by bf16 rounding of that
#: layer alone (the CPU at full width, 3 layers: 0.021 of max|output|;
#: at 64 layers of d 128: 0.037), where a stale conv tail or a lost state
#: gives O(1).
#: DeepSeek-MoE is held at capacity factor n_experts / top_k, where cap =
#: tokens and nothing drops at any step (at 1.25 a decode step has cap 1,
#: and the reference's own prefill-then-decode differs from its prefill by
#: O(1)).  Its bf16 drift: the reference's DeepSeek-MoE routing at d 128
#: and 28 layers drifts 0.135 of max|logits| (tests/test_torch_serve.py::
#: test_bf16_drift_is_the_reference_models[deepseek-moe-16b-28]; the port
#: 0.015): routing flips on near-ties between the two paths amplify like
#: depth does.  Whisper's 32 decoder layers: the reference drifts 0.014 at
#: d 128, so Llama's 0.05 holds it.
CONSISTENCY_F32_RTOL = 1e-3
REFERENCE_MAMBA2_BF16_DRIFT = 0.442
REFERENCE_MOE_BF16_DRIFT = 0.135
CONSISTENCY_BF16_RTOL = {"llama3.2-3b": 0.05,
                         "mamba2-2.7b": 2 * REFERENCE_MAMBA2_BF16_DRIFT,
                         "deepseek-moe-16b": 2 * REFERENCE_MOE_BF16_DRIFT,
                         "whisper-large-v3": 0.05}
#: serve cells: prompt length (Whisper's 416 + 32 new tokens are its
#: published 448 decoder positions); each launches its kernel once an
#: attention (or SSD) layer of the prefill: the encoder's, for Whisper
SERVE_CELLS = {"llama3.2-3b": (2048, "flash_fwd"),
               "mamba2-2.7b": (2048, "ssd_diag"),
               "deepseek-moe-16b": (2048, "flash_fwd"),
               "whisper-large-v3": (416, "flash_fwd")}
#: DeepSeek-MoE's f32 weights (62 GiB) beside its bf16 ones do not fit the
#: card: the f32 consistency check runs its first 8 layers
DEEPSEEK_F32_LAYERS = 8
SSM_LAYER_BF16_RTOL = 2.0 ** -4
#: calls a case of --launch-cost: 20 processes of it fit in a quarter hour
LAUNCH_COST_CALLS = 2000
SMOKE_PROMPTS = {"llama3.2-3b": 1024, "mamba2-2.7b": 256, "gemma3-4b": 1024,
                 "deepseek-moe-16b": 1024, "mixtral-8x22b": 1024,
                 "jamba-v0.1-52b": 256, "whisper-large-v3": 1024}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls (CUDA
    events around the whole run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {name} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    return {"platform": "gpu", "kind": name, "count": count}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    for src, lib in libs.items():
        print(f"build: {src.relative_to(ROOT)} -> {lib.relative_to(ROOT)}")
        for line in ptxas_lines(build.BUILD_LOG.get(str(src), "")):
            print(f"  {line}")
    print(f"build: {secs:.2f} s")
    counts = sass_counts(libs)
    for func in SASS_WGMMA_TMA:
        c = counts.get(func)
        if c is not None and (c["HGMMA"] == 0 or c["HMMA"] > 0
                              or c["UTMALDG"] == 0):
            fail(f"{func} is not on wgmma and TMA alone: {c}")
    c = counts.get("mxu_iter_kernel")
    if c is not None and (c["HGMMA"] == 0 or c["HMMA"] > 0):
        fail(f"mxu_iter_kernel is not on wgmma alone: {c}")


def ptxas_lines(log: str) -> list[str]:
    """Each kernel's register and spill report from ``nvcc -Xptxas -v``:
    ``name<D>: Used ... registers, ...; ... spill stores, ... spill loads``
    (kernel names demangled as far as their template argument), and any
    warning of lost performance (wgmma serialised)."""
    import re
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"([a-z][a-z0-9_]*_kernel)(?:ILi(\d+)E)?",
                          line.split()[-1])
            name = (f"{m.group(1)}<{m.group(2)}>" if m and m.group(2)
                    else m.group(1) if m else line.split()[-1])
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
        elif "Performance Loss" in line:     # e.g. wgmma serialised
            out.append(line.strip())
    return out


#: SASS instructions that show which engines a kernel uses: HGMMA (wgmma),
#: HMMA (mma.sync and WMMA), LDGSTS (cp.async), UTMALDG (TMA loads)
SASS_OPS = ("HGMMA", "HMMA", "LDGSTS", "UTMALDG")
#: the tensor-core kernels, by source (directory/file) and function names
SASS_KERNELS = {"flash_attention/kernel.cu": ("flash_fwd_bf16_kernel",),
                "flash_attention/backward.cu": ("flash_bwd_dkdv_bf16_kernel",
                                                "flash_bwd_dq_bf16_kernel"),
                "ssd/kernel.cu": ("ssd_diag_kernel",),
                "proxy_blocks/kernel.cu": ("mxu_iter_kernel",)}
#: kernels that must run on wgmma fed by TMA, with no mma.sync
SASS_WGMMA_TMA = ("flash_bwd_dkdv_bf16_kernel", "flash_bwd_dq_bf16_kernel")


def sass_counts(libs: dict) -> dict:
    """Print the count of SASS_OPS in each redesigned kernel's functions
    (all template instances together), from ``cuobjdump -sass`` on the
    built library; return them by function name."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for src, lib in libs.items():
        funcs = SASS_KERNELS.get(f"{src.parent.name}/{src.name}", ())
        if not funcs:
            continue
        if not Path(tool).exists():
            print(f"sass {', '.join(funcs)}: cuobjdump not found, "
                  "instructions not counted")
            continue
        dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300).stdout
        for func in funcs:
            counts = dict.fromkeys(SASS_OPS, 0)
            inside = False
            for line in dump.splitlines():
                if "Function :" in line:
                    inside = func in line
                elif inside:
                    for op in SASS_OPS:
                        counts[op] += len(re.findall(rf"\b{op}\b", line))
            print(f"sass {func} ({src.relative_to(ROOT)}): " + ", ".join(
                f"{op} {n}" for op, n in counts.items()))
            out[func] = counts
    return out


def mxu_inputs(rng, scale: float, batch: tuple = ()):
    """``a`` ~ U(-1, 1) and ``b`` an orthogonal matrix divided by ``scale``:
    each turn keeps the norm of every row of ``a``, so the outputs stay O(1)
    over any number of turns and the relative limit has something to see."""
    import numpy as np
    a = rng.uniform(-1, 1, batch + (128, 128))
    q, r = np.linalg.qr(rng.standard_normal(batch + (128, 128)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    return (torch.tensor(a, dtype=torch.float32),
            torch.tensor(q / scale, dtype=torch.float32))


def check_mxu(got, want, what: str, reps: int = 1) -> float:
    """max|got - want|, failing above sqrt(reps) * MXU_RTOL of max|want|.

    A kernel that runs a wrong number of turns or drops the scale misses by
    O(max|want|); one that sums in bf16 by about 2-4 times the limit."""
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    limit = max(reps, 1) ** 0.5 * MXU_RTOL * top
    print(f"kernel mxu_iter {what}: max|kernel-plain| = {err:.3g}, "
          f"max|plain| = {top:.3g}, limit {limit:.3g}")
    if not top > 0:
        fail(f"mxu_iter {what}: outputs are all zero, nothing was compared")
    if not err <= limit:
        fail(f"mxu_iter {what} disagrees with mxu_ref: {err} > {limit}")
    return err


def check_mxu_pieces(got, a, b, reps: int, scale: float) -> None:
    """A long chain in pieces of MXU_PIECE turns, where sqrt(reps) ulps
    would pass too much (half the largest output at reps 4096): the kernel
    is deterministic, so one launch of ``reps`` turns must equal reps /
    MXU_PIECE launches bit for bit, and each piece is held to the plain
    chain restarted from the kernel's own output, at the piece's limit."""
    from repro_torch.kernels.proxy_blocks import ops, ref

    x, worst = a, 0.0
    for i in range(reps // MXU_PIECE):
        nxt = ops.mxu_iter(x, b, MXU_PIECE, scale)
        want = ref.mxu_ref(x, b, MXU_PIECE, scale)
        err = float((nxt.float() - want.float()).abs().max())
        limit = MXU_PIECE ** 0.5 * MXU_RTOL * float(want.float().abs().max())
        if not err <= limit:
            fail(f"mxu_iter reps={reps} scale={scale:g}: piece {i} is "
                 f"{err} off the plain chain, limit {limit}")
        worst = max(worst, err / limit)
        x = nxt
    if not torch.equal(got, x):
        fail(f"mxu_iter reps={reps} scale={scale:g} differs from "
             f"{reps // MXU_PIECE} launches of {MXU_PIECE} turns")
    print(f"kernel mxu_iter reps={reps} scale={scale:g}: equal to "
          f"{reps // MXU_PIECE} launches of {MXU_PIECE} turns, each within "
          f"{worst:.3g} of its limit")


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card, same inputs."""
    import numpy as np
    from repro_torch.core import blocks
    from repro_torch.kernels.proxy_blocks import ops, ref

    rng = np.random.RandomState(0)
    errs = {}
    for reps in (0, 1, 5, 7, 32, 4096):
        for scale in (ref.MXU_SCALE, 1.0):
            a, b = (x.to(dev, torch.bfloat16) for x in mxu_inputs(rng, scale))
            got = ops.mxu_iter(a, b, reps, scale)
            if reps == 0:
                if not torch.equal(got, a):
                    fail("mxu_iter reps=0 is not a copy of a")
                continue
            err = check_mxu(got, ref.mxu_ref(a, b, reps, scale),
                            f"reps={reps} scale={scale:g}", reps)
            if reps > 1:    # the last turn alone, at the one-turn limit
                prev = ops.mxu_iter(a, b, reps - 1, scale)
                check_mxu(got, ref.mxu_ref(prev, b, 1, scale),
                          f"reps={reps} scale={scale:g}, last turn")
            if reps > MXU_PIECE:
                check_mxu_pieces(got, a, b, reps, scale)
            if reps == 5 and scale == 1.0:
                errs["mxu_iter"] = err
    print("kernel mxu_iter reps=0: a copy of a, bit for bit")
    # batched a, with one b per item (the per-rank-seeds replay) and with
    # one b shared by every item
    a, b = (x.to(dev, torch.bfloat16) for x in mxu_inputs(rng, 1.0, (3,)))
    check_mxu(ops.mxu_iter(a, b, 5, 1.0), ref.mxu_ref(a, b, 5, 1.0),
              "batched (3,128,128), b per item, reps=5", 5)
    check_mxu(ops.mxu_iter(a, b[1], 5, 1.0), ref.mxu_ref(a, b[1], 5, 1.0),
              "batched (3,128,128), b shared, reps=5", 5)
    # the main path's own inputs: init_state's b shrinks a about 20-fold a
    # turn, so its outputs are small but far from bf16's underflow at reps=5
    st = blocks.init_state(0, dev)
    check_mxu(ops.mxu_iter(st["a"], st["b"], 5, 1.0),
              ref.mxu_ref(st["a"], st["b"], 5, 1.0), "main-path state reps=5",
              5)

    for n, reps in ((2048, 3), (4096, 17), (32768, 5), (32768, 2000),
                    (2 * 32768, 5)):
        shape = (2, n // 2) if n == 2 * 32768 else (n,)
        v = torch.tensor(rng.uniform(0, 1, shape), dtype=torch.float32).to(dev)
        got = ops.stream_iter(v, reps)
        want = ref.stream_ref(v, reps)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs()).max())
        print(f"kernel stream_iter shape={shape} reps={reps}: "
              f"bit-exact={exact} max rel err {rel:.3g}")
        if not exact:
            fail(f"stream_iter is not bit-exact to stream_ref (one fused "
                 f"multiply-add a turn): max rel err {rel}")
        if n == 32768 and reps == 5:
            errs["stream_iter"] = err

    # views that start off a 16-byte boundary are copied, not faulted on;
    # empty inputs launch nothing
    big = torch.rand(4096 + 1, device=dev)
    if not torch.equal(ops.stream_iter(big[1:], 3), ref.stream_ref(big[1:], 3)):
        fail("stream_iter disagrees on a misaligned view")
    flat = torch.zeros(128 * 128 + 1, dtype=torch.bfloat16, device=dev)
    a, b = (x.to(dev, torch.bfloat16) for x in mxu_inputs(rng, 1.0))
    flat[1:] = a.flatten()
    check_mxu(ops.mxu_iter(flat[1:].view(128, 128), b, 5, 1.0),
              ops.mxu_iter(a, b, 5, 1.0), "misaligned view reps=5 (against "
              "the kernel on an aligned copy)")
    before = dict(ops.LAUNCHES)
    ops.mxu_iter(torch.empty(0, 128, 128, dtype=torch.bfloat16, device=dev),
                 b, 3, 1.0)
    ops.stream_iter(torch.empty(0, 1024, device=dev), 3)
    if ops.LAUNCHES != before:
        fail(f"empty inputs counted launches: {before} -> {ops.LAUNCHES}")
    print("kernels: misaligned views copied and matched; empty inputs "
          "launched nothing")
    return errs


def check_states(got: dict, want: dict, what: str) -> float:
    """Largest |difference| over the leaves of two rank-state dicts.

    bf16 leaves within MXU_RTOL of their largest value (the one-turn
    limit: see below for why it is enough here); f32 leaves at
    STATE_ATOL: tanh and the f32 8x128x128 product round differently in
    different libraries (and batched vs single products in cuBLAS), and
    the block chain contracts, so differences stay at rounding level;
    integer leaves exactly.  On the main path's workload the bf16 leaf
    ``a`` underflows to 0 (each turn shrinks it about 20-fold, 2,000 turns
    a rank), so it is compared exactly there and is no evidence about
    mxu_iter: phase_kernels is."""
    worst = 0.0
    zero = set()
    for r in want:
        for k, w in want[r].items():
            g = got[r][k].detach().cpu()
            w = w.detach().cpu()
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{what}: rank {r} leaf {k} {g.shape}/{g.dtype} "
                     f"vs {w.shape}/{w.dtype}")
            if not torch.isfinite(g.float()).all():
                fail(f"{what}: rank {r} leaf {k} not finite")
            d = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
            if g.dtype == torch.bfloat16:
                top = float(w.float().abs().max())
                if top == 0:
                    zero.add(k)
                tol = MXU_RTOL * top
            else:
                tol = STATE_ATOL if g.is_floating_point() else 0.0
            if not d <= tol:
                fail(f"{what}: rank {r} leaf {k} differs by {d} > {tol}")
            worst = max(worst, d)
    for k in sorted(zero):
        print(f"{what}: bf16 leaf {k} is 0 in the reference states and "
              f"compared exactly; it says nothing about mxu_iter")
    return worst


def kernel_ops() -> tuple:
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.proxy_blocks import ops as block_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return block_ops, flash_ops, ssd_ops


def reset_counts() -> None:
    for mod in kernel_ops():
        mod.reset_counts()


def read_counts() -> dict:
    out = {}
    for mod in kernel_ops():
        out.update(mod.LAUNCHES)
    return out


def phase_main_path(dev) -> tuple[dict, object]:
    from repro_torch.core.replay import ProxyProgram
    from repro_torch.core.synthesize import synthesize
    from repro_torch.core.trace_ir import TraceStore
    from repro_torch.workloads import synthetic_rank_traces

    store = TraceStore.from_rank_traces(synthetic_rank_traces(N_RANKS),
                                        {"x": N_RANKS})
    reset_counts()
    t0 = time.perf_counter()
    res = synthesize(store=store, device=dev,
                     out_dir=ROOT / "build" / "chip_smoke")
    t1 = time.perf_counter()
    states = res.proxy.run_all()
    t2 = time.perf_counter()
    fid = res.fidelity(sample_ranks=None)
    t3 = time.perf_counter()
    launches = read_counts()
    print(f"main path: synthesize {1e3 * (t1 - t0):.1f} ms, run_all "
          f"{1e3 * (t2 - t1):.1f} ms, fidelity {1e3 * (t3 - t2):.1f} ms")
    print("main path stats: " + json.dumps(res.stats))
    print(f"main path combos: {res.proxy.combos}")
    print(f"main path: delta_bar = {fid.mean!r}, comm_lossless = "
          f"{fid.comm_lossless}")
    print(f"main path launches: {json.dumps(launches)}")
    for name in ("mxu_iter", "stream_iter"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if not fid.comm_lossless:
        fail("comm sequences not lossless")
    if abs(fid.mean - REFERENCE_DELTA) > 1e-12:
        fail(f"delta_bar {fid.mean!r} != reference {REFERENCE_DELTA!r}")
    if sorted(states) != list(range(N_RANKS)):
        fail("run_all did not return every rank")
    ms = 1e3 * res.proxy.time_all(iters=3)
    print(f"main path time_all: {ms:.2f} ms (mean of 3 warm sweeps)")

    cpu = ProxyProgram(res.source, res.proxy.module, res.merged,
                       res.proxy.combos, res.proxy.axis_sizes, device="cpu")
    worst = check_states(states, cpu.run_all(), "cuda vs cpu run_all")
    print(f"main path: max |cuda - cpu| over final states = {worst:.3g}")
    return launches, res


def phase_profile(res) -> None:
    """Device kernel time of one warm run_all, from torch.profiler."""
    res.proxy.run_all()                  # warm
    profile_call(res.proxy.run_all, "run_all")


def phase_per_rank_seeds(res) -> None:
    t0 = time.perf_counter()
    batched = res.proxy.run_all(per_rank_seeds=True)
    t1 = time.perf_counter()
    single = res.proxy.run_all(per_rank_seeds=True, batched=False)
    t2 = time.perf_counter()
    worst = check_states(batched, single, "per_rank_seeds batched vs per-rank")
    print(f"per-rank seeds: batched {1e3 * (t1 - t0):.1f} ms, per-rank "
          f"{1e3 * (t2 - t1):.1f} ms, max |diff| = {worst:.3g}")


TRACE_SCENARIOS = ("transformer-dp", "flash-ring", "ssm-decode", "moe-ep",
                   "encdec-pipeline")
#: full-width model costs the trace phase walks: batch 4 x 2048 tokens,
#: decode against a cache of 8192 (the reference cannot walk a full-width
#: train step, and the scenarios walk only DeepSeek's and Whisper's smoke
#: train steps, so those two are walked for prefill and decode)
TRACE_COSTS = (("llama3.2-3b", ("prefill", "decode", "train")),
               ("mamba2-2.7b", ("prefill", "decode", "train")),
               ("deepseek-moe-16b", ("prefill", "decode")),
               ("whisper-large-v3", ("prefill", "decode")))
TRACE_DELTA_ATOL = 1e-12


def trace_targets() -> list:
    """(name, synthesize(...) of it with the caller's keywords) of the
    paper's three programs at their default sizes and the five zoo
    scenarios at their defaults."""
    from repro_torch.configs.registry import build_scenario
    from repro_torch.core.synthesize import synthesize
    from repro_torch.workloads import PROGRAMS, pipeline_traces
    out = []
    for name, make in PROGRAMS.items():
        fn, args, axes = make()
        out.append((name, lambda fn=fn, args=args, axes=axes, **kw:
                    synthesize(fn, *args, axis_sizes=axes, **kw)))
    traces = pipeline_traces()
    out.append(("pipeline",
                lambda **kw: synthesize(rank_traces=traces, **kw)))
    for name in TRACE_SCENARIOS:
        out.append((name, lambda name=name, **kw: synthesize(
            store=build_scenario(name), **kw)))
    return out


def predicted_launches(res) -> dict:
    """mxu_iter / stream_iter launches of one batched ``run_all``: one pass
    a signature group, one launch a compute terminal in the group's stream
    whose fitted combination has mxu_vmem / hbm_stream turns."""
    from repro_torch.core.events import is_comm
    gid = {ev.key(): i for i, ev in enumerate(res.merged.table.events)}
    out = {"mxu_iter": 0, "stream_iter": 0}
    for _sig, grp in res.proxy.signature_groups():
        g = res.grammars[grp[0]]
        for i in res.rank_ids[grp[0]]:
            ev = g.table[i]
            if is_comm(ev):
                continue
            x = res.proxy.combos[gid[ev.key()]][0]
            out["mxu_iter"] += int(x[0] > 0)
            out["stream_iter"] += int(x[2] > 0)
    return out


def phase_trace(dev) -> dict:
    """Slice 7: the tracer front end on the card.  Each program and
    scenario is traced (on meta tensors), synthesized with the fit and the
    replay on the card, replayed and scored; the same on the CPU must give
    the same TraceStore and the same delta_bar.  Then the walker's costs of
    the full models' steps (TRACE_COSTS), which launch nothing."""
    from repro_torch.configs import get
    from repro_torch.configs.registry import _model_costs
    out_dir = ROOT / "build" / "chip_smoke_trace"
    rows = {}
    for name, target in trace_targets():
        t0 = time.perf_counter()
        res = target(out_dir=out_dir)          # device None: the card
        t1 = time.perf_counter()
        reset_counts()
        res.proxy.run_all()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_counts()
        fid = res.fidelity(sample_ranks=None)
        want = predicted_launches(res)
        cpu = target(out_dir=out_dir, device="cpu")
        cpu.proxy.run_all()
        fid_cpu = cpu.fidelity(sample_ranks=None)
        row = {"events": res.stats["n_events"],
               "terminals": res.stats["n_unique_terminals"],
               "synthesize_ms": 1e3 * (t1 - t0), "run_all_ms": 1e3 * (t2 - t1),
               "delta_bar": fid.mean, "delta_bar_cpu": fid_cpu.mean,
               "comm_lossless": bool(fid.comm_lossless),
               "launches": {k: launches[k] for k in want}, "predicted": want,
               "store": res.store.content_hash()[:16]}
        print(f"trace {name}: {json.dumps(row)}")
        if not fid.comm_lossless:
            fail(f"trace {name}: comm sequences not lossless")
        if {k: launches[k] for k in want} != want:
            fail(f"trace {name}: launches {launches} != predicted {want}")
        if any(launches[k] for k in launches if k not in want):
            fail(f"trace {name}: a model kernel launched in replay")
        if res.store.content_hash() != cpu.store.content_hash():
            fail(f"trace {name}: the TraceStore differs from the CPU's")
        if abs(fid.mean - fid_cpu.mean) > TRACE_DELTA_ATOL:
            fail(f"trace {name}: delta_bar {fid.mean!r} != CPU "
                 f"{fid_cpu.mean!r}")
        rows[name] = row
    costs = {}
    for arch, kinds in TRACE_COSTS:
        cfg = get(arch)
        for kind in kinds:
            reset_counts()
            t0 = time.perf_counter()
            vec = _model_costs(cfg, (kind,), b=4, s=2048)[kind]
            secs = time.perf_counter() - t0
            launched = {k: v for k, v in read_counts().items() if v}
            costs[f"{arch} {kind}"] = {"cost": [int(v) for v in vec],
                                       "walk_s": secs}
            print(f"trace cost {arch} {kind} (b 4 x 2048"
                  f"{', cache 8192' if kind == 'decode' else ''}): "
                  f"{[int(v) for v in vec]} in {secs:.2f} s")
            if launched:
                fail(f"walking {arch} {kind} launched kernels: {launched}")
            if not all(math.isfinite(v) for v in vec) or vec[0] <= 0:
                fail(f"walking {arch} {kind}: cost {vec}")
    return {"targets": rows, "costs": costs}


def flash_inputs(gen, b, s, h, g, d, dtype, dev):
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, g, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, g, d), generator=gen, device=dev).to(dtype)
    return q, k, v


def ssd_inputs(gen, b, c, q, g, r, p, n, dtype, dev):
    """The reference test's distributions: x, B, C ~ N(0, 1), dt in
    [0.01, 0.1], cum the running sum of a in [-0.5, -0.01]."""
    h = g * r
    x = torch.randn((b, c, q, h, p), generator=gen, device=dev).to(dtype)
    dt = 0.01 + 0.09 * torch.rand((b, c, q, h), generator=gen, device=dev)
    adt = -(0.01 + 0.49 * torch.rand((b, c, q, h), generator=gen, device=dev))
    cum = torch.cumsum(adt, dim=2)
    bm = torch.randn((b, c, q, g, n), generator=gen, device=dev).to(dtype)
    cm = torch.randn((b, c, q, g, n), generator=gen, device=dev).to(dtype)
    return x, dt, cum, bm, cm


def check_close(name: str, got, want, what: str) -> float:
    """Each element within its limit (``tolerance.KERNEL_TOL``); returns
    max|got - want|."""
    from repro_torch.kernels import tolerance

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {what}: {tuple(got.shape)}/{got.dtype} against "
             f"{tuple(want.shape)}/{want.dtype}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name} {what}: not finite")
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    tol = tolerance.KERNEL_TOL[(name, got.dtype)]
    worst = tolerance.excess(got, want, *tol)
    extra = f" + {tol[2]:.3g} RMS" if len(tol) > 2 else ""
    print(f"kernel {name} {what}: max|kernel-plain| = {err:.3g}, "
          f"max|plain| = {top:.3g}, worst |kernel-plain| / ({tol[0]} ulp + "
          f"{tol[1]:.3g} row RMS{extra}) = {worst:.3g} (limit 1)")
    if not top > 0.1:
        fail(f"{name} {what}: outputs near zero, nothing was compared")
    if not worst <= 1:
        fail(f"{name} {what} disagrees with its plain version: {worst} times "
             "the limit")
    return err


#: the main path's kernel shapes: Llama 3.2 3B prefill attention at batch 4,
#: prompt 2048; Mamba2 2.7B's SSD diagonal block at the same batch and
#: prompt (8 chunks of 256, 80 heads of 64, one group, state 128)
FLASH_MAIN = dict(b=4, s=2048, h=24, g=8, d=128)
SSD_MAIN = dict(b=4, c=8, q=256, g=1, r=80, p=64, n=128)
#: slice 8's flash shapes (bf16): DeepSeek-MoE 16B's prefill (MHA, causal)
#: and Whisper large-v3's encoder over its 1500 frames (unmasked; the
#: forward in serve and train, the backward in train); (b, s, h, g, d,
#: causal) by cell
FLASH_SHAPES = {"deepseek-moe-16b": (4, 2048, 16, 16, 128, True),
                "whisper-large-v3": (4, 1500, 20, 20, 64, False)}


def phase_zoo_kernels(dev) -> dict:
    """flash_fwd and ssd_diag against their plain versions on the card: the
    CPU tests' sweeps (tests/test_kernels.py's shapes), the smoke shapes,
    ragged lengths, and the main path's shapes."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.ssd import ops as sops, ref as sref

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    fl = FLASH_MAIN
    flash_cases = [
        (1, 256, 4, 2, 64, None, True), (2, 256, 2, 2, 128, 128, True),
        (1, 384, 4, 1, 64, None, True), (1, 512, 2, 1, 64, None, False),
        (2, 1024, 4, 2, 16, None, True), (2, 1024, 4, 2, 16, 16, True),
        (1, 77, 4, 2, 16, 16, True), (1, 1000, 2, 1, 64, None, False),
        (2, 300, 4, 2, 32, None, True), (1, 200, 2, 2, 32, 64, True),
        (fl["b"], fl["s"], fl["h"], fl["g"], fl["d"], None, True),
        (fl["b"], fl["s"], fl["h"], fl["g"], fl["d"], 512, True)]
    shapes = {v[:5]: k for k, v in FLASH_SHAPES.items()}
    flash_cases += [v[:5] + (None, v[5]) for v in FLASH_SHAPES.values()]
    for b, s, h, g, d, win, causal in flash_cases:
        main = (b, s, h, g, d) == tuple(fl.values())
        cell = shapes.get((b, s, h, g, d))
        for dtype in ((torch.bfloat16,) if main or cell else
                      (torch.float32, torch.bfloat16)):
            q, k, v = flash_inputs(gen, b, s, h, g, d, dtype, dev)
            got = fops.flash_attention_fwd(q, k, v, causal=causal, window=win)
            want = fref.attention_ref(q, k, v, causal=causal, window=win)
            err = check_close("flash_fwd", got, want,
                              f"b={b} s={s} h={h} g={g} d={d} window={win} "
                              f"causal={causal} {str(dtype)[6:]}")
            if main and win is None:
                errs["flash_fwd"] = err
            if cell:
                errs[f"flash_fwd {cell}"] = err
            del q, k, v, got, want
    sm = SSD_MAIN
    ssd_cases = [(1, 2, 32, 1, 4, 16, 16), (2, 2, 16, 2, 8, 8, 32),
                 (1, 1, 64, 1, 12, 16, 16), (2, 4, 8, 1, 8, 16, 16),
                 (1, 2, 100, 2, 3, 32, 64), tuple(sm.values())]
    for b, c, q, g, r, p, n in ssd_cases:
        main = (b, c, q, g, r, p, n) == tuple(sm.values())
        for dtype in ((torch.bfloat16,) if main else
                      (torch.float32, torch.bfloat16)):
            ins = ssd_inputs(gen, b, c, q, g, r, p, n, dtype, dev)
            # out_dtype None is x's dtype: for f32 inputs the same call
            for out_dtype in ((None, torch.float32)
                              if dtype == torch.bfloat16 else (None,)):
                got = sops.ssd_diag_block(*ins, r, out_dtype=out_dtype)
                want = sref.ssd_diag_ref(*ins, r, out_dtype=out_dtype)
                err = check_close("ssd_diag", got, want,
                                  f"b={b} c={c} q={q} g={g} r={r} p={p} n={n}"
                                  f" {str(dtype)[6:]} -> {str(got.dtype)[6:]}")
                if main and got.dtype == torch.float32:
                    errs["ssd_diag"] = err
            del ins
    # views that start off a 16-byte boundary are copied; empty inputs
    # launch nothing
    q, k, v = flash_inputs(gen, 1, 65, 2, 1, 16, torch.float32, dev)
    flat = torch.zeros(q.numel() + 1, device=dev)
    flat[1:] = q.flatten()
    qv = flat[1:].view(q.shape)
    if not torch.equal(fops.flash_attention_fwd(qv, k, v),
                       fops.flash_attention_fwd(q, k, v)):
        fail("flash_fwd disagrees on a misaligned view")
    before = read_counts()
    fops.flash_attention_fwd(q[:, :0], k, v)
    ins = ssd_inputs(gen, 0, 1, 8, 1, 2, 16, 16, torch.float32, dev)
    sops.ssd_diag_block(*ins, 2)
    if read_counts() != before:
        fail(f"empty inputs counted launches: {before} -> {read_counts()}")
    print("kernels flash_fwd/ssd_diag: misaligned view matched; empty "
          "inputs launched nothing")
    return errs


def serve_prompts(cfg, b: int, s: int, seed: int = 0):
    import numpy as np
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(
        np.int32)


def model_batch(cfg, tokens, dev, seed: int = 0) -> dict:
    """{tokens} and, for an encoder-decoder, random N(0, 1) audio frames
    (b, n_audio_frames, d) in the config's dtype, from ``seed``: the
    checks that call the prefill directly feed the encoder something that
    is not zero (the serve engine feeds the reference's zero frames)."""
    out = {"tokens": tokens}
    if cfg.n_audio_frames:
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        out["audio_frames"] = torch.randn(
            (tokens.shape[0], cfg.n_audio_frames, cfg.d_model),
            generator=gen, device=dev).to(getattr(torch, cfg.dtype))
    return out


def cut_depth(cfg, params, n_layers: int):
    """The config and weights of the first ``n_layers`` layers (views)."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map

    u = T.unit_len(cfg)
    if cfg.family == "encdec" or n_layers % u:
        fail(f"{cfg.name}: no cut at {n_layers} layers")
    out = dict(params, rest=())
    out["unit"] = tree_map(lambda t: t[:n_layers // u], params["unit"])
    return dataclasses.replace(cfg, n_layers=n_layers), out


@contextlib.contextmanager
def moe_routes(records: list):
    """Record, for each ``moe_apply`` call, its (dropped picks, picks in
    an emptied slot, all picks) as device tensors (no host sync)."""
    from repro_torch.models import moe as M

    route = M.route

    def spy(*args, **kwargs):
        r = route(*args, **kwargs)
        records.append(((~r["inv_ok"]).sum(), r["emptied"].sum(),
                        r["inv_ok"].numel()))
        return r

    M.route = spy
    try:
        yield
    finally:
        M.route = route


def drop_shares(records: list) -> dict:
    """(dropped, emptied) as shares of the picks of a list of records."""
    n = sum(r[2] for r in records)
    return {"dropped": sum(int(r[0]) for r in records) / n,
            "emptied": sum(int(r[1]) for r in records) / n}


def check_consistency(cfg, params, prompts, dev, split: int,
                      rtol: float, profile: bool = False) -> float:
    """Last-position logits of a full prefill against a prefill of the first
    ``split`` tokens then teacher-forced decode steps through the rest,
    held within ``rtol`` of max|logits|."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import build_forward, init_cache
    from repro_torch.serve.engine import ServeEngine

    b, s = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    prefill = build_forward(cfg, "prefill")
    decode = build_forward(cfg, "decode")
    with torch.inference_mode():
        full, _ = prefill(params, model_batch(cfg, toks, dev), cfg)
        logits, pre = prefill(params, model_batch(cfg, toks[:, :split], dev),
                              cfg)
        cache = tree_map(ServeEngine._embed_cache,
                         init_cache(cfg, b, s, dev), pre)
        del pre
        for i in range(split, s):
            args = (params, cache, {"tokens": toks[:, i:i + 1]}, i, cfg)
            if profile and i == split + 1:
                logits, cache = profile_call(lambda: decode(*args),
                                             f"{cfg.name} decode step")
            else:
                logits, cache = decode(*args)
        other = torch.as_tensor(serve_prompts(cfg, b, s, seed=1),
                                dtype=torch.int32, device=dev)
        unrelated, _ = prefill(params, model_batch(cfg, other, dev, 1), cfg)
    torch.cuda.synchronize()
    del cache
    err = float((logits.float() - full.float()).abs().max())
    top = float(full.float().abs().max())
    far = float((unrelated.float() - full.float()).abs().max())
    agree = (logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"serve {cfg.name} {cfg.dtype} consistency: prefill {s} vs prefill "
          f"{split} + {s - split} decode steps: max|diff| = {err:.4g}, "
          f"max|logits| = {top:.4g} (limit {rtol * top:.4g}), argmax "
          f"agreement {agree:.2f}; unrelated prompts' logits lie "
          f"{far:.4g} away")
    if not torch.isfinite(logits.float()).all() or not top > 0:
        fail(f"{cfg.name} consistency: logits not finite or all zero")
    if not err <= rtol * top:
        fail(f"{cfg.name} {cfg.dtype} prefill/decode consistency: {err} > "
             f"{rtol} * {top}")
    return err


def check_ssm_layers(cfg, params, prompts, dev, split: int,
                     rtol: float) -> float:
    """Every Mamba2 layer on its own, fed the full prefill's input to it:
    the layer's chunked prefill over all positions against its prefill of
    the first ``split`` then ``ssm_decode`` steps through the rest, over
    every decoded position, held within ``rtol`` of max|prefill output| of
    that layer.  No layer's difference reaches the next one, so this sees
    one layer's rounding, not 64 layers' amplification of it."""
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rms_norm

    b, s = prompts.shape
    kw = dict(head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
              n_groups=cfg.ssm_groups, expand=cfg.ssm_expand)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    worst, where = 0.0, None
    with torch.inference_mode():
        x = T.embed_inputs(params, {"tokens": toks}, cfg)
        for n, (kind, i, _, sub) in enumerate(T._layers(cfg, params)):
            if kind != "m":
                fail(f"{cfg.name}: layer {n} is of kind {kind}, not m")
            p = T._index(sub, i)
            hh = rms_norm(x, p["ln1"])
            full = S.ssm_apply(p["mixer"], hh, chunk=cfg.ssm_chunk, **kw)
            _, cache = S.ssm_apply(p["mixer"], hh[:, :split],
                                   chunk=cfg.ssm_chunk, return_cache=True,
                                   **kw)
            steps = []
            for t in range(split, s):
                y, cache = S.ssm_decode(p["mixer"], hh[:, t:t + 1], cache,
                                        **kw)
                steps.append(y)
            want = full[:, split:].float()
            err = float((torch.cat(steps, 1).float() - want).abs().max()
                        / want.abs().max())
            if not err < float("inf"):
                fail(f"{cfg.name} layer {n}: decode output not finite")
            if err > worst:
                worst, where = err, n
            x = T._ffn(cfg, n, p, x + full)[0]
    print(f"serve {cfg.name} {cfg.dtype} per-layer consistency: prefill {s} "
          f"vs prefill {split} + {s - split} decode steps, each of "
          f"{cfg.n_layers} layers on the prefill's own input: worst "
          f"max|diff| / max|out| = {worst:.4g} (layer {where}), limit {rtol}")
    if not worst <= rtol:
        fail(f"{cfg.name} {cfg.dtype} per-layer prefill/decode consistency: "
             f"{worst} > {rtol} at layer {where}")
    return worst


def phase_serve(dev, arch: str) -> dict:
    """ServeEngine.generate at full width and depth, bf16, random weights
    from seed 0: batch 4, SERVE_CELLS' prompt, 32 new tokens."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models import moe as M
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get(arch)
    plen, kernel = SERVE_CELLS[arch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    # init draws each leaf in f32 first: its peak is the weights plus the
    # largest leaf in f32; serving's is read apart
    init_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve {arch}: {cfg.n_layers} layers"
          f"{f' (+ {cfg.enc_layers} encoder)' if cfg.enc_layers else ''}, "
          f"d {cfg.d_model}, {n_params / 1e9:.3f}B parameters ({cfg.dtype}), "
          f"init {time.perf_counter() - t0:.2f} s")
    prompts = serve_prompts(cfg, SERVE_BATCH, plen)
    engine = ServeEngine(cfg, params, device=dev, max_len=plen + SERVE_NEW)
    reset_counts()
    res = engine.generate(prompts, SERVE_NEW)
    launches = read_counts()
    print(f"serve {arch} launches: {json.dumps(launches)}")
    want = cfg.enc_layers or cfg.n_layers
    if launches[kernel] != want:
        fail(f"{arch}: {kernel} launched {launches[kernel]} times per "
             f"generate, expected {want} (one per layer)")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    if others:
        fail(f"{arch}: unexpected launches {others}")
    if res.tokens.shape != (SERVE_BATCH, SERVE_NEW) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all():
        fail(f"{arch}: tokens {res.tokens.shape} out of range")
    warm = engine.generate(prompts, SERVE_NEW)      # the same run, warm
    if not (warm.tokens == res.tokens).all():
        fail(f"{arch}: a second generate gave other tokens")
    row = {"launches": launches[kernel],
           "prefill_ms": 1e3 * warm.prefill_sec,
           "decode_ms": 1e3 * warm.decode_sec,
           "tokens_per_sec": warm.tokens_per_sec,
           "cold_prefill_ms": 1e3 * res.prefill_sec,
           "serve_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    row["max_memory_gib"] = max(init_peak, row["serve_peak_gib"])
    print(f"serve {arch}: prefill {row['prefill_ms']:.2f} ms (cold "
          f"{row['cold_prefill_ms']:.2f}), decode {row['decode_ms']:.2f} ms "
          f"for {SERVE_NEW - 1} steps, {row['tokens_per_sec']:.1f} tokens/s, "
          f"max memory {row['max_memory_gib']:.2f} GiB (serving "
          f"{row['serve_peak_gib']:.2f}, init {init_peak:.2f})")
    print(f"serve {arch} tokens[0][:8]: {res.tokens[0][:8].tolist()}")
    if cfg.n_experts:
        # a prefill and one decode step, at the published capacity factor
        records: list = []
        with moe_routes(records):
            again = engine.generate(prompts, 2)
        if not (again.tokens == res.tokens[:, :2]).all():
            fail(f"{arch}: generate under the route recorder differs")
        n = cfg.n_layers
        row["picks_prefill"] = drop_shares(records[:n])
        row["picks_decode_step"] = drop_shares(records[n:2 * n])
        caps = [M.capacity(SERVE_BATCH * t, cfg.top_k, cfg.n_experts,
                         cfg.capacity_factor) for t in (plen, 1)]
        print(f"serve {arch} expert picks at capacity factor "
              f"{cfg.capacity_factor} (shares of all picks): prefill (cap "
              f"{caps[0]}) {json.dumps(row['picks_prefill'])}, a decode step "
              f"(cap {caps[1]}) {json.dumps(row['picks_decode_step'])}")
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        batch = {"tokens": toks, **engine._extras(SERVE_BATCH)}
        profile_call(lambda: engine._prefill(params, batch, cfg),
                     f"{arch} prefill")
        del batch
    split = plen - 256
    ccfg = cfg
    if cfg.n_experts:
        # cap = tokens: nothing drops in the prefill or in any decode step
        ccfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                   / cfg.top_k)
    row["consistency_bf16"] = check_consistency(
        ccfg, params, prompts, dev, split, CONSISTENCY_BF16_RTOL[arch],
        profile=True)
    if cfg.family == "ssm":
        row["layers_bf16"] = check_ssm_layers(cfg, params, prompts, dev, split,
                                              SSM_LAYER_BF16_RTOL)
    del engine
    if cfg.n_experts:
        ccfg, params = cut_depth(ccfg, params, DEEPSEEK_F32_LAYERS)
        print(f"serve {arch} f32 consistency at {ccfg.n_layers} of "
              f"{cfg.n_layers} layers (the f32 weights of all do not fit "
              "beside the bf16 ones)")
    params = tree_map(lambda t: t.float(), params)   # the same weights in f32
    torch.cuda.empty_cache()
    row["consistency_f32"] = check_consistency(
        dataclasses.replace(ccfg, dtype="float32"), params, prompts, dev,
        split, CONSISTENCY_F32_RTOL)
    del params
    torch.cuda.empty_cache()
    return row


def _leaves(tree) -> list:
    from repro_torch.models.layers import tree_leaves
    return tree_leaves(tree)


def kernel_times(prof) -> list[tuple]:
    """(device us, launches, name) of each kernel a profile saw."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        rows.append((e.self_cuda_time_total if t is None else t, e.count,
                     e.key))
    return rows


def profile_call(fn, label: str, stats: dict | None = None):
    """Run ``fn()`` once under torch.profiler; print the device kernel time
    by name and the device's busy share of the call's wall time (the
    profiler slows the host side, so the share is a floor); put the share
    in ``stats["busy_share"]`` when given."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = kernel_times(prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"profile {label}: device time not measured")
        return out
    print(f"profile {label}: wall {wall_us / 1e3:.2f} ms under the profiler, "
          f"device kernels {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% "
          f"busy), {sum(r[1] for r in rows)} kernel launches")
    if stats is not None:
        stats["busy_share"] = busy / wall_us
    for t, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {t / 1e3:8.3f} ms {100 * t / busy:5.1f}%  {count:5d}x  "
              f"{key[:60]}")
    return out


def phase_smoke_configs(dev) -> None:
    """The CPU tests' smoke configs (f32), same weights and prompts, on the
    card against the CPU: equal tokens, prefill logits close (Whisper's on
    random frames; its generate feeds zero frames)."""
    import dataclasses
    from repro_torch.configs import get, smoke
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import build_forward, init_params
    from repro_torch.serve.engine import ServeEngine

    for arch, plen in SMOKE_PROMPTS.items():
        cfg = smoke(get(arch))
        cpu = init_params(cfg, 0, "cpu")
        gpu = tree_map(lambda t: t.to(dev), cpu)
        prompts = serve_prompts(cfg, 2, plen)
        reset_counts()
        got = ServeEngine(cfg, gpu, device=dev, max_len=plen + 8).generate(
            prompts, 8)
        launches = read_counts()
        want = ServeEngine(cfg, cpu, device="cpu", max_len=plen + 8).generate(
            prompts, 8)
        batch = model_batch(cfg, torch.as_tensor(prompts, device=dev), dev)
        with torch.inference_mode():
            lg, _ = build_forward(cfg, "prefill")(gpu, batch, cfg)
            lc, _ = build_forward(cfg, "prefill")(
                cpu, {k: v.cpu() for k, v in batch.items()}, cfg)
        diff = float((lg.cpu() - lc).abs().max())
        print(f"smoke {arch} (prompt {plen}) cuda vs cpu: tokens equal "
              f"{bool((got.tokens == want.tokens).all())}, prefill logits "
              f"max|diff| {diff:.3g} of max {float(lc.abs().max()):.3g}, "
              f"launches {json.dumps(launches)}")
        if not (got.tokens == want.tokens).all():
            fail(f"smoke {arch}: tokens on the card differ from the CPU's")
        if not sum(launches.values()) > 0:
            fail(f"smoke {arch}: no kernel launched on the card")


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def zoo_timings(dev) -> dict:
    """flash_fwd and ssd_diag at the main path's shapes: kernel, plain
    version, bound and (flash) PyTorch's SDPA as a yardstick.  Each kernel
    is timed in turns with its yardstick (kernel, yardstick, kernel), and
    its ``ms`` is the mean of its two turns."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.ssd import ops as sops, ref as sref

    gen = torch.Generator(device=dev).manual_seed(1)
    fl = FLASH_MAIN
    b, s, h, g, d = (fl[k] for k in ("b", "s", "h", "g", "d"))
    q, k, v = flash_inputs(gen, b, s, h, g, d, torch.bfloat16, dev)
    # the causal pairs this call computes: s (s + 1) / 2 per (b, head)
    pairs = s * (s + 1) / 2
    fb, fby = bound(2 * (2 * b * s * h * d + 2 * b * s * g * d),
                    4 * b * h * d * pairs, PEAK_BF16_FLOPS)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    turns = [cuda_ms(lambda: fops.flash_attention_fwd(q, k, v), 20),
             cuda_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True), 20),
             cuda_ms(lambda: fops.flash_attention_fwd(q, k, v), 20)]
    print(f"timing flash_fwd in turns: kernel {turns[0]:.4f} ms, SDPA "
          f"{turns[1]:.4f} ms, kernel {turns[2]:.4f} ms")
    flash = {
        "ms": (turns[0] + turns[2]) / 2,
        "plain_ms": cuda_ms(lambda: fref.attention_ref(q, k, v), 5),
        "bound_ms": fb, "bound_by": fby, "library_ms": turns[1]}
    flops = 4 * b * h * d * pairs
    print(f"timing flash_fwd: {flops:.3g} FLOP, {flops / flash['ms'] / 1e9:.1f}"
          f" TFLOP/s ({100 * fb / flash['ms']:.1f}% of the bound)")
    del q, k, v, qt, kt, vt
    sm = SSD_MAIN
    b, c, qq, g, r, p, n = (sm[k] for k in ("b", "c", "q", "g", "r", "p", "n"))
    ins = ssd_inputs(gen, b, c, qq, g, r, p, n, torch.bfloat16, dev)
    pairs = qq * (qq + 1) / 2
    h = g * r
    nbytes = b * c * qq * (h * p * 2 + 2 * h * 4 + 2 * g * n * 2 + h * p * 4)
    y_flops, s_flops = 2 * b * c * pairs * h * p, 2 * b * c * pairs * g * n
    # on the CUDA cores in f32 (the first design), and on the tensor cores
    # as the kernel runs it: C B^T in bf16 (counted at the TF32 rate's
    # share), and (S o L o dt) X as two TF32 products (a bf16 x is exact
    # in TF32, so 3xTF32's third product vanishes)
    f32b, f32by = bound(nbytes, y_flops + s_flops, PEAK_F32_FLOPS)
    tc_flops = 2 * y_flops + s_flops * PEAK_TF32_FLOPS / PEAK_BF16_FLOPS
    sb, sby = bound(nbytes, tc_flops, PEAK_TF32_FLOPS)
    print(f"bound ssd_diag main shape: tensor cores {sb:.4f} ms ({sby}; "
          f"operations {1e3 * tc_flops / PEAK_TF32_FLOPS:.4f} ms, bytes "
          f"{1e3 * nbytes / PEAK_BYTES:.4f} ms), f32 CUDA cores {f32b:.4f} ms "
          f"({f32by})")
    turns = [cuda_ms(lambda: sops.ssd_diag_block(*ins, r, torch.float32), 20),
             cuda_ms(lambda: sref.ssd_diag_ref(*ins, r, torch.float32), 5),
             cuda_ms(lambda: sops.ssd_diag_block(*ins, r, torch.float32), 20)]
    print(f"timing ssd_diag in turns: kernel {turns[0]:.4f} ms, plain "
          f"{turns[1]:.4f} ms, kernel {turns[2]:.4f} ms")
    ssd = {
        "ms": (turns[0] + turns[2]) / 2, "plain_ms": turns[1],
        "bound_ms": sb, "bound_by": sby,
        # no single PyTorch call computes the decay-masked block
        "library_ms": None}
    for name, row in (("flash_fwd", flash), ("ssd_diag", ssd)):
        lib = ("" if row["library_ms"] is None
               else f", library {row['library_ms']:.4f} ms")
        print(f"timing {name} main shape: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}){lib}")
    return {"flash_fwd": flash, "ssd_diag": ssd}


def host_us(fn, calls: int) -> float:
    """Host microseconds per call of ``fn()`` over ``calls`` back-to-back
    calls (time.perf_counter after a warm-up, no synchronise inside the
    loop).  Where the device takes longer than the host, the host waits for
    it once the launch queue is full, and this is the device's time."""
    for _ in range(min(calls, 100)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def device_us(fn, kernel: str, calls: int):
    """The profiler's device microseconds per launch of the kernel whose
    name holds ``kernel``, over ``calls`` calls of ``fn()``; None if the
    profiler saw no such launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    mine = [(t, n) for t, n, key in kernel_times(prof) if kernel in key]
    count = sum(n for _, n in mine)
    return sum(t for t, _ in mine) / count if count else None


#: latency of a dependent f32 fused multiply-add on Hopper, in cycles
FMA_CYCLES = 4
#: the H100 SXM's published maximum SM clock (boost), MHz
H100_MAX_SM_MHZ = 1980.0


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it, else the
    published one (said so in the output)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    try:
        mhz = float(smi.stdout.strip().splitlines()[0])
        print(f"device max SM clock: {mhz:.0f} MHz (nvidia-smi)")
    except (ValueError, IndexError):
        mhz = H100_MAX_SM_MHZ
        print(f"device max SM clock: not reported ({smi.stdout.strip()!r}); "
              f"the H100 SXM's published {mhz:.0f} MHz used")
    return mhz * 1e6


def phase_timings(dev, launches: dict, errs: dict) -> list[dict]:
    """Kernel, plain and bound times at the main paths' shapes."""
    from repro_torch.kernels.proxy_blocks import ops, ref
    from repro_torch.core import blocks

    st = blocks.init_state(0, dev)
    a, b, v = st["a"], st["b"], st["v"]
    rows = []
    table = {}
    sm_hz = max_sm_clock_hz()
    for reps in (5, 4096):
        iters = 200 if reps == 5 else 20
        calls = 10000 if reps == 5 else 100
        mxu_bytes = 3 * a.numel() * 2
        mxu_flops = reps * 2 * 128 ** 3
        mxu_call = lambda: ops.mxu_iter(a, b, reps, 1.0)    # noqa: E731
        mxu = {
            "ms": cuda_ms(mxu_call, iters),
            "plain_ms": cuda_ms(lambda: ref.mxu_ref(a, b, reps, 1.0),
                                max(iters // 10, 2)),
            "bound_ms": 1e3 * max(mxu_bytes / PEAK_BYTES,
                                  mxu_flops / PEAK_BF16_FLOPS),
            "bound_by": ("bytes" if mxu_bytes / PEAK_BYTES
                         >= mxu_flops / PEAK_BF16_FLOPS else "operations"),
            # no single PyTorch call iterates: see the reps=1 yardstick
            "library_ms": None,
            # one item's chain of turns runs on the two SMs that hold its
            # two row halves: 2/132 of the card's tensor cores
            "two_sm_bound_ms": 1e3 * mxu_flops / (PEAK_BF16_FLOPS * 2 / 132),
            "device_us": device_us(mxu_call, "mxu_iter_kernel", iters),
            "host_us": host_us(mxu_call, calls),
        }
        st_bytes = 2 * v.numel() * 4
        st_ops = reps * 2 * v.numel()
        stream_call = lambda: ops.stream_iter(v, reps)      # noqa: E731
        stream = {
            "ms": cuda_ms(stream_call, iters),
            "plain_ms": cuda_ms(lambda: ref.stream_ref(v, reps),
                                max(iters // 10, 2)),
            "bound_ms": 1e3 * max(st_bytes / PEAK_BYTES,
                                  st_ops / PEAK_F32_FLOPS),
            "bound_by": ("bytes" if st_bytes / PEAK_BYTES
                         >= st_ops / PEAK_F32_FLOPS else "operations"),
            "library_ms": None,
            # each element is a chain of reps dependent fused multiply-adds,
            # 4 cycles each at the SM's clock, whatever the card's peak
            "chain_bound_ms": 1e3 * reps * FMA_CYCLES / sm_hz,
            "device_us": device_us(stream_call, "stream_iter_kernel", iters),
            "host_us": host_us(stream_call, calls),
        }
        table[("mxu_iter", reps)] = mxu
        table[("stream_iter", reps)] = stream
        for name, row in (("mxu_iter", mxu), ("stream_iter", stream)):
            dev_us = ("not measured" if row["device_us"] is None
                      else f"{row['device_us']:.3f} us")
            two_sm = ("" if "two_sm_bound_ms" not in row else
                      f", two-SM bound {row['two_sm_bound_ms']:.6f} ms")
            if "chain_bound_ms" in row:
                two_sm = (f", chain bound {row['chain_bound_ms']:.6f} ms "
                          f"({FMA_CYCLES} cycles an FMA at {sm_hz / 1e6:.0f} "
                          "MHz)")
            print(f"timing {name} reps={reps}: event {row['ms']:.4f} ms a "
                  f"launch, device {dev_us} a launch (profiler), host "
                  f"{row['host_us']:.3f} us a call of the wrapper, plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
                  f"({row['bound_by']}){two_sm}")
    # what one PyTorch call costs the same host: the launch path's yardsticks
    yardsticks = {}
    for name, call in (("torch.matmul(a, b)", lambda: torch.matmul(a, b)),
                       ("torch.empty_like(v)", lambda: torch.empty_like(v))):
        yardsticks[name] = host_us(call, 10000)
        print(f"timing {name}: host {yardsticks[name]:.3f} us a call")
    # yardsticks at reps = 1, where one PyTorch call computes the function
    table[("mxu_iter", 1)] = {
        "ms": cuda_ms(lambda: ops.mxu_iter(a, b, 1, 1.0), 200),
        "library_ms": cuda_ms(lambda: torch.matmul(a, b), 200)}
    print(f"timing mxu_iter reps=1: kernel {table[('mxu_iter', 1)]['ms']:.4f}"
          f" ms, torch.matmul {table[('mxu_iter', 1)]['library_ms']:.4f} ms")
    meta = {
        "mxu_iter": ("src/repro_torch/kernels/proxy_blocks/kernel.cu",
                     "src/repro/kernels/proxy_blocks/kernel.py:28"),
        "stream_iter": ("src/repro_torch/kernels/proxy_blocks/kernel.cu",
                        "src/repro/kernels/proxy_blocks/kernel.py:51"),
    }
    for name, (source, replaces) in meta.items():
        row = table[(name, 5)]      # the main path's shape: reps = 5
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    zoo = zoo_timings(dev)
    meta = {
        "flash_fwd": ("src/repro_torch/kernels/flash_attention/kernel.cu",
                      "src/repro/kernels/flash_attention/kernel.py:29"),
        "ssd_diag": ("src/repro_torch/kernels/ssd/kernel.cu",
                     "src/repro/kernels/ssd/kernel.py:26"),
    }
    for name, (source, replaces) in meta.items():
        row = zoo[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    print(json.dumps({"timings": {f"{n}@reps={r}": v
                                  for (n, r), v in table.items()},
                      "host_us_yardsticks": yardsticks}))
    return rows


#: slice 5: full-size training at batch 4 x 2048 tokens, 3 steps a model
TRAIN_BATCH = 4
TRAIN_STEPS = 3
#: DeepSeek-MoE 16B trains at full width and this cut depth: its 28
#: layers' weights, gradients and AdamW moments (12 bytes a parameter,
#: 16.7 B parameters) do not fit one card.  On an H100 80GB (79.18 GiB)
#: 8 layers (4.9 B) peaked at 57.75 GiB, and each layer adds 0.588 B
#: parameters (6.6 GiB); at 10 layers the backward could not place a 3.44
#: GiB gradient of the stacked experts.  9 leave about 15 GiB spare
DEEPSEEK_TRAIN_LAYERS = 9
#: train cells: tokens a sequence, and the depth (None: the published one);
#: Whisper's decoder at its 448 positions, its encoder at the 1500 frames
TRAIN_CELLS = {"llama3.2-3b": (2048, None), "mamba2-2.7b": (2048, None),
               "whisper-large-v3": (448, None),
               "deepseek-moe-16b": (2048, DEEPSEEK_TRAIN_LAYERS)}


def train_launches(cfg) -> dict:
    """Kernel launches a training step: the forward and remat's recompute
    launch the forward kernel twice a layer, the backward once.  Every
    attention layer of these cells takes flash but Whisper's decoder's
    (448 positions, below FLASH_MIN_SEQ)."""
    if cfg.family == "ssm":
        return {"ssd_diag": 2 * cfg.n_layers}
    n = cfg.enc_layers or cfg.n_layers
    return {"flash_fwd": 2 * n, "flash_bwd": n}
#: smoke configs' training step, card against CPU (f32): the loss and the
#: gradient norm within 1e-5 relative and each gradient leaf within 1e-4 of
#: its largest value (tests/test_torch_train.py's limits against the JAX
#: reference); updated weights within 1e-3 lr where the clipped |g| >= 1e-6,
#: and within 2 lr where g is rounding noise (AdamW's first step is lr
#: times g / (|g| + eps); see test_train_step_matches_reference)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
#: LSE against the plain log-sum-exp: |lse - plain| <= LSE_RTOL max(1,
#: |plain|) (tests/test_torch_cuda.py)
LSE_RTOL = 1e-4


def check_train_kernels(dev) -> tuple[dict, float]:
    """flash_bwd, the LSE output and the SSD gradient at the training
    path's shapes, against their plain versions.  Returns flash_bwd's
    max|kernel - plain| at the main shape and at Whisper's (by name), and
    the plain SSD backward's ms a Mamba2 layer."""
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.ssd import ops as sops, ref as sref

    gen = torch.Generator(device=dev).manual_seed(5)
    fl = FLASH_MAIN
    cases = [(fl["b"], fl["s"], fl["h"], fl["g"], fl["d"], None, True,
              torch.bfloat16),
             (fl["b"], fl["s"], fl["h"], fl["g"], fl["d"], 512, True,
              torch.bfloat16),
             (1, 300, 6, 2, 64, None, True, torch.float32),
             (2, 1024, 4, 2, 16, 16, True, torch.float32),
             (1, 384, 4, 2, 64, None, False, torch.float32)]
    # Whisper large-v3's encoder: 1500 frames, unmasked, d 64
    wh = FLASH_SHAPES["whisper-large-v3"]
    cases.append(wh[:5] + (None, wh[5], torch.bfloat16))
    errs = {}
    for b, s, h, g, d, win, causal, dtype in cases:
        q, k, v = flash_inputs(gen, b, s, h, g, d, dtype, dev)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        out, lse = fops.flash_attention_fwd(q, k, v, causal=causal,
                                            window=win, return_lse=True)
        if not torch.equal(out, fops.flash_attention_fwd(
                q, k, v, causal=causal, window=win)):
            fail("flash_fwd's output changes when the LSE is asked for")
        _, want = fref.attention_ref(q, k, v, causal=causal, window=win,
                                     return_lse=True)
        lse_err = float(((lse - want).abs() / want.abs().clamp_min(1.0)).max())
        what = (f"b={b} s={s} h={h} g={g} d={d} window={win} causal={causal}"
                f" {str(dtype)[6:]}")
        print(f"kernel flash_fwd lse {what}: max|lse-plain| / max(1, |plain|)"
              f" = {lse_err:.3g} (limit {LSE_RTOL}); out bit-identical with "
              "and without")
        if not lse_err <= LSE_RTOL:
            fail(f"flash_fwd lse {what}: {lse_err} > {LSE_RTOL}")
        got = fops.flash_attention_bwd(q, k, v, out, lse, dout,
                                       causal=causal, window=win)
        plain = fref.attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=win)
        err = max(check_close("flash_bwd", x, y, f"{name} {what}")
                  for name, x, y in zip(("dq", "dk", "dv"), got, plain))
        again = fops.flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=win)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"flash_bwd {what}: two calls differ (not deterministic)")
        if (b, s, h, g, d, win) == tuple(fl.values()) + (None,):
            errs["flash_bwd"] = err
        if (b, s, h, g, d, causal) == wh:
            errs["flash_bwd whisper-large-v3"] = err
        del q, k, v, dout, out, lse, got, plain, again
    print("kernel flash_bwd: two calls bit-identical on every case")
    sm = SSD_MAIN
    r = sm["r"]
    ins = ssd_inputs(gen, *(sm[k] for k in ("b", "c", "q", "g", "r", "p",
                                             "n")), torch.bfloat16, dev)
    gy = torch.randn(ins[0].shape, generator=gen, device=dev)
    grads = []
    for fn in (sops.ssd_diag, sref.ssd_diag_ref):
        leaves = [x.detach().requires_grad_(True) for x in ins]
        y = fn(*leaves, r, torch.float32)
        grads.append(torch.autograd.grad(y, leaves, gy))
        del y, leaves
    torch.cuda.synchronize()
    for name, got, want in zip(("x", "dt", "cum", "B", "C"), *grads):
        if not torch.isfinite(got.float()).all():
            fail(f"ssd_diag gradient of {name} not finite")
        if not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            fail(f"ssd_diag gradient of {name} differs from plain autograd "
                 f"by {err}")
    print("kernel ssd_diag gradient at the Mamba2 2.7B shape (b 4, c 8, q "
          "256, h 80, p 64, n 128, bf16): every input's gradient equal to "
          "plain autograd through ssd_diag_ref, bit for bit")
    del grads

    def ssd_backward():
        """What the SSD Function's backward runs: the plain version
        recomputed under autograd and differentiated."""
        leaves = [x.detach().requires_grad_(True) for x in ins]
        return torch.autograd.grad(sref.ssd_diag_ref(*leaves, r,
                                                     torch.float32),
                                   leaves, gy)

    ssd_ms = cuda_ms(ssd_backward, 5)
    print(f"timing ssd_diag's plain backward at the Mamba2 2.7B shape: "
          f"{ssd_ms:.3f} ms a layer")
    del ins, gy
    torch.cuda.empty_cache()
    return errs, ssd_ms


def model_flops(cfg, n_params: int, seq: int) -> float:
    """6 N T for the matmuls of a training step (the tied LM head counted
    once, in N; an MoE's N its active parameters, the top-k and shared
    experts; an encoder-decoder's encoder weights over its frames, the
    rest over the tokens) plus attention's score and value products: three
    times the forward's 4 b h d a layer for each query-key pair it
    computes (causal: s(s+1)/2; the encoder's F^2, cross-attention's s F);
    remat's recompute and MoE capacity padding are not counted."""
    b, hd4 = TRAIN_BATCH, 4 * TRAIN_BATCH * cfg.n_heads * cfg.hd
    tokens = b * seq
    pairs = seq * (seq + 1) / 2
    if cfg.family == "encdec":
        d, f = cfg.d_model, cfg.n_audio_frames
        enc = cfg.enc_layers * (2 * d * cfg.hd * (cfg.n_heads
                                                  + cfg.n_kv_heads)
                                + 3 * d * cfg.d_ff)
        flops = 6.0 * (enc * b * f + (n_params - enc) * tokens)
        return flops + 3 * hd4 * (cfg.enc_layers * f * f
                                  + cfg.n_layers * (pairs + seq * f))
    if cfg.n_experts:
        n_params -= sum((cfg.n_experts - cfg.top_k) * 3 * cfg.d_model
                        * cfg.d_ff_expert for i in range(cfg.n_layers)
                        if cfg.is_moe_layer(i))
    flops = 6.0 * n_params * tokens
    n_attn = sum(k in ("g", "l") for k in cfg.layer_kinds())
    return flops + n_attn * 3 * hd4 * pairs


def train_full(dev, arch: str) -> dict:
    """Trainer.run at full width and TRAIN_CELLS' depth: 3 steps, then 3
    steps of make_train_step on one fixed batch that must lower its loss
    each step."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import build_forward
    from repro_torch.train.data import TokenDataset
    from repro_torch.train.loop import Trainer, make_train_step
    from repro_torch.train.optimizer import (
        AdamWConfig, adamw_init, adamw_update,
    )

    cfg = get(arch)
    seq, depth = TRAIN_CELLS[arch]
    if depth is not None:
        print(f"train {arch}: cut to {depth} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=depth)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, global_batch=TRAIN_BATCH, seq_len=seq,
                      ckpt_dir=ROOT / "build" / "chip_smoke" / f"ckpt_{arch}",
                      seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(trainer.params))
    card = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    print(f"train {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params / 1e9:.3f}B parameters ({cfg.dtype}), card "
          f"{card:.2f} GiB, remat "
          f"{cfg.remat}, loss_chunk {cfg.loss_chunk}, init "
          f"{time.perf_counter() - t0:.2f} s")
    reset_counts()
    trainer.run(TRAIN_STEPS - 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    prof = {}
    profile_call(lambda: trainer.run(1), f"train {arch} step", prof)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log = trainer.metrics_log
    losses = [m["loss"] for m in log]
    if len(log) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train {arch}: losses {losses}")
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items() if n}
    print(f"train {arch} launches in {TRAIN_STEPS} steps: "
          f"{json.dumps(launches)}; per step {json.dumps(per_step)}")
    expected = train_launches(cfg)
    for kernel, want in expected.items():
        if launches[kernel] != want * TRAIN_STEPS:
            fail(f"train {arch}: {kernel} launched {launches[kernel]} times "
                 f"in {TRAIN_STEPS} steps, expected {want} a step")
    others = {k: n for k, n in launches.items() if k not in expected and n}
    if others:
        fail(f"train {arch}: unexpected launches {others}")
    step_s = log[1]["sec"]           # the second step: warm, not profiled
    tokens = TRAIN_BATCH * seq
    flops = model_flops(cfg, n_params, seq)
    row = {"layers": cfg.n_layers, "seq": seq, "losses": losses,
           "step_ms": 1e3 * step_s,
           "first_step_ms": 1e3 * log[0]["sec"],
           "tokens_per_sec": tokens / step_s, "model_flops": flops,
           "model_tflops": flops / step_s / 1e12,
           "share_of_989": flops / step_s / PEAK_BF16_FLOPS,
           "peak_gib_warm_step": peak, "card_gib": card,
           "busy_share_warm_step": prof.get("busy_share"),
           "launches": launches, "launches_per_step": per_step}
    print(f"train {arch}: losses {losses}; step {row['step_ms']:.1f} ms "
          f"(first {row['first_step_ms']:.1f}), {row['tokens_per_sec']:.0f} "
          f"tokens/s, {flops:.3g} model FLOP a step = "
          f"{row['model_tflops']:.1f} TFLOP/s ({100 * row['share_of_989']:.1f}"
          f"% of 989), peak {peak:.2f} GiB in a warm step")

    # the sign check: one fixed batch, 3 steps, its loss falls each step
    params = trainer.params
    del trainer
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    step = make_train_step(cfg, opt_cfg=AdamWConfig(warmup_steps=1),
                           device=dev)
    ds = TokenDataset(cfg.vocab, seq, TRAIN_BATCH, seed=1)
    batch = {**ds.batch_at(0), **ds.extras(cfg)}
    fixed = []
    for _ in range(3):
        params, opt, m = step(params, opt, batch)
        fixed.append(float(m["loss"]))
    with torch.no_grad():
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        fixed.append(float(build_forward(cfg, "loss")(params, tb, cfg)))
    print(f"train {arch} sign check: one batch, loss before and after each "
          f"of 3 steps (warmup 1): {fixed}")
    if not all(b < a for a, b in zip(fixed, fixed[1:])):
        fail(f"train {arch}: 3 steps on one batch did not lower its loss "
             f"each step: {fixed}")
    row["sign_check_losses"] = fixed
    # the optimizer alone, last (its updates move the weights): adamw_update
    # of every weight, zero grads costing what real ones do
    grads = tree_map(torch.zeros_like, params)
    row["adamw_ms"] = cuda_ms(lambda: adamw_update(
        grads, params, opt, AdamWConfig(warmup_steps=1)), 2, warmup=1)
    print(f"train {arch}: adamw_update alone {row['adamw_ms']:.1f} ms")
    del params, opt, grads
    torch.cuda.empty_cache()
    return row


def _step_close(arch, got, want, lr, grads) -> float:
    """Updated weights, card against CPU, by the limits of TRAIN_*."""
    from repro_torch.models.layers import tree_leaves

    gn = float(torch.sqrt(sum((g.double() ** 2).sum()
                              for g in tree_leaves(grads))))
    clip = min(1.0, 1.0 / gn)
    worst = {True: 0.0, False: 0.0}
    for a, b, g in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(grads)):
        err = (a.cpu().float() - b.float()).abs()
        firm = g.float().abs() * clip >= 1e-6
        for key in (True, False):
            sel = err[firm == key]
            if sel.numel():
                worst[key] = max(worst[key], float(sel.max()))
    if not (worst[True] <= 1e-3 * lr and worst[False] <= 2 * lr):
        fail(f"train smoke {arch}: updated weights differ by {worst} "
             f"(lr {lr})")
    return worst[True] / lr


def train_smoke_configs(dev) -> None:
    """One training step of each smoke config (f32) on the card against the
    CPU, same weights and batch: loss, every gradient leaf, the updated
    weights."""
    from repro_torch.configs import get, smoke
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import build_forward, init_params
    from repro_torch.train.data import TokenDataset
    from repro_torch.train.loop import _value_and_grad, make_train_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    ocfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    for arch, seq in SMOKE_PROMPTS.items():
        cfg = smoke(get(arch))
        ds = TokenDataset(cfg.vocab, seq, 2, seed=3)
        batch = {**ds.batch_at(0), **ds.extras(cfg)}
        cpu = init_params(cfg, 0, "cpu")
        gpu = tree_map(lambda t: t.to(dev, copy=True), cpu)
        loss_fn = build_forward(cfg, "loss")
        reset_counts()
        res = {}
        for name, params, device in (("cuda", gpu, dev), ("cpu", cpu, "cpu")):
            tb = {k: torch.as_tensor(v, device=device)
                  for k, v in batch.items()}
            loss, grads = _value_and_grad(lambda p, b: loss_fn(p, b, cfg),
                                          params, tb)
            step = make_train_step(cfg, opt_cfg=ocfg, device=device)
            params, _, m = step(params, adamw_init(params), batch)
            res[name] = (loss, grads, params, m)
            if name == "cuda":
                launches = read_counts()
        (gl, gg, gp, gm), (cl, cg, cp, cm) = res["cuda"], res["cpu"]
        lerr = abs(float(gl) - float(cl)) / abs(float(cl))
        if not lerr <= TRAIN_LOSS_RTOL:
            fail(f"train smoke {arch}: loss {float(gl)} against the CPU's "
                 f"{float(cl)}")
        worst = 0.0
        for i, (a, b) in enumerate(zip(tree_leaves(gg), tree_leaves(cg))):
            top = float(b.abs().max())
            err = float((a.cpu() - b).abs().max())
            if not err <= TRAIN_GRAD_RTOL * top:
                fail(f"train smoke {arch}: gradient leaf {i} differs by {err}"
                     f" (largest {top})")
            worst = max(worst, err / top if top else 0.0)
        if abs(float(gm["grad_norm"]) / float(cm["grad_norm"]) - 1) > 1e-5:
            fail(f"train smoke {arch}: grad norm {float(gm['grad_norm'])} "
                 f"against {float(cm['grad_norm'])}")
        werr = _step_close(arch, gp, cp, float(cm["lr"]), cg)
        print(f"train smoke {arch} (seq {seq}) cuda vs cpu: loss rel diff "
              f"{lerr:.3g}, worst gradient leaf {worst:.3g} of its largest, "
              f"updated weights within {werr:.3g} lr; launches "
              f"{json.dumps(launches)}")
        kinds = set(cfg.layer_kinds())
        want = {"ssd_diag"} if "m" in kinds else set()
        if seq >= 1024 and kinds & {"g", "l"}:
            want |= {"flash_fwd", "flash_bwd"}
        if not want or any(launches[k] <= 0 for k in want):
            fail(f"train smoke {arch}: {want} not all launched: {launches}")


def train_crash_resume(dev, arch: str) -> None:
    """A smoke config at 1024 tokens (the flash kernels; the MoE routing
    and dispatch; the encoder-decoder's frames): Trainer.run(6,
    ckpt_every=2) with a failure injected at step 4 equals the
    uninterrupted run bit for bit (losses, weights, moments)."""
    import shutil
    from repro_torch.configs import get, smoke
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.loop import Trainer, _InjectedFailure

    cfg = smoke(get(arch))
    base = ROOT / "build" / "chip_smoke" / "crash_resume"
    shutil.rmtree(base, ignore_errors=True)
    kw = dict(global_batch=2, seq_len=1024, device=dev)
    reset_counts()
    t1 = Trainer(cfg, ckpt_dir=base / "a", **kw)
    log1 = t1.run(6, ckpt_every=2)
    t2 = Trainer(cfg, ckpt_dir=base / "b", **kw)
    crashed = []

    def inject(step):
        if step == 4 and not crashed:
            crashed.append(step)
            raise _InjectedFailure("simulated node loss")

    log2 = t2.run(6, ckpt_every=2, failure_injector=inject)
    launches = read_counts()
    l1 = [m["loss"] for m in log1 if m["step"] < 6]
    l2 = {m["step"]: m["loss"] for m in log2}
    same = (crashed and l1 == [l2[s] for s in range(6)]
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves(t1.params), tree_leaves(t2.params)))
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves(t1.opt_state), tree_leaves(t2.opt_state))))
    print(f"train crash/resume ({cfg.name}, 1024 tokens, failure at step "
          f"4): losses {l1}; bit-identical to the uninterrupted run: "
          f"{bool(same)}; launches {json.dumps(launches)}")
    if not same:
        fail(f"crash/resume of {cfg.name} on the card does not reproduce the "
             "uninterrupted run bit for bit")
    shutil.rmtree(base, ignore_errors=True)


def flash_bwd_main_inputs(dev) -> tuple:
    """q, k, v, out, lse, dout at Llama 3.2 3B's training shape (bf16,
    causal), out and lse from the kernel's forward."""
    from repro_torch.kernels.flash_attention import ops as fops

    gen = torch.Generator(device=dev).manual_seed(2)
    fl = FLASH_MAIN
    q, k, v = flash_inputs(gen, *(fl[x] for x in ("b", "s", "h", "g", "d")),
                           torch.bfloat16, dev)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    out, lse = fops.flash_attention_fwd(q, k, v, return_lse=True)
    return q, k, v, out, lse, dout


def flash_bwd_kernel_us(fn, calls: int = 5) -> dict:
    """Device microseconds a launch of each flash_bwd kernel (D, dQ,
    dK/dV) over ``calls`` calls of ``fn``, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total: dict = {}
    for t, count, key in kernel_times(prof):
        for name in ("flash_bwd_prep", "flash_bwd_dot", "flash_bwd_dq",
                     "flash_bwd_dkdv"):
            if name in key:
                t0, n0 = total.get(name, (0.0, 0))
                total[name] = (t0 + t, n0 + count)
    return {name: t / n for name, (t, n) in total.items()}


def flash_bwd_timing(dev) -> tuple[dict, dict]:
    """flash_bwd at Llama 3.2 3B's training shape: kernel, plain version,
    bound, and the backward alone of PyTorch's SDPA on the same tensors (a
    yardstick), the kernel and the yardstick in turns; and the profiler's
    device microseconds of each of its kernels a call
    (:func:`phase_flash_bwd_versus` of this checkout)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref

    fl = FLASH_MAIN
    b, s, h, g, d = (fl[k] for k in ("b", "s", "h", "g", "d"))
    q, k, v, out, lse, dout = flash_bwd_main_inputs(dev)
    pairs = s * (s + 1) / 2
    flops = 10 * b * h * d * pairs          # five products, 2.5 x forward
    nbytes = 2 * (4 * b * s * h * d + 4 * b * s * g * d) + 4 * b * s * h
    bnd, bby = bound(nbytes, flops, PEAK_BF16_FLOPS)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    kern = lambda: fops.flash_attention_bwd(q, k, v, out, lse, dout)  # noqa
    lib = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,  # noqa: E731
                                      retain_graph=True)
    turns = [cuda_ms(kern, 10), cuda_ms(lib, 10), cuda_ms(kern, 10)]
    print(f"timing flash_bwd in turns: kernel {turns[0]:.4f} ms, SDPA "
          f"backward {turns[1]:.4f} ms, kernel {turns[2]:.4f} ms")
    row = {"ms": (turns[0] + turns[2]) / 2,
           "plain_ms": cuda_ms(lambda: fref.attention_bwd_ref(
               q, k, v, out, lse, dout), 3),
           "bound_ms": bnd, "bound_by": bby, "library_ms": turns[1]}
    print(f"timing flash_bwd main shape: kernel {row['ms']:.4f} ms "
          f"({flops / row['ms'] / 1e9:.1f} TFLOP/s, {100 * bnd / row['ms']:.1f}"
          f"% of the bound), plain {row['plain_ms']:.4f} ms, bound "
          f"{bnd:.4f} ms ({bby}; {flops:.3g} FLOP, {nbytes / 1e6:.1f} MB), "
          f"SDPA backward {row['library_ms']:.4f} ms")
    del q, k, v, out, lse, dout, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    # in a fresh process: after a long run's earlier profiles, the
    # profiler drops some of these kernels' events
    proc = subprocess.run([sys.executable, __file__, "--flash-bwd-vs",
                           str(ROOT)], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        fail(f"flash_bwd profile: {proc.stderr.strip()[-2000:]}")
    us = json.loads(proc.stdout.strip().splitlines()[-1])[
        "flash_bwd_versus"][0]["device_us"]
    print("profile flash_bwd main shape, device us a launch: " + ", ".join(
        f"{name} {t:.1f}" for name, t in us.items()))
    return row, us


def phase_flash_bwd_versus(trees: list[Path]) -> None:
    """flash_bwd of each checkout's ``backward.cu`` at the main shape,
    through this checkout's wrapper (the C interface is the same), in the
    order given: name one tree twice and another between (``OLD NEW NEW
    OLD``) to compare two kernels on one card.  Each is held to the plain
    version first; SDPA's backward is timed beside each turn."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref

    dev = torch.device("cuda", 0)
    rel = Path("src/repro_torch/kernels/flash_attention/backward.cu")
    srcs = [(tree / rel).resolve() for tree in trees]
    build.build_all(sorted(set(srcs)))
    q, k, v, out, lse, dout = flash_bwd_main_inputs(dev)
    want = fref.attention_bwd_ref(q, k, v, out, lse, dout)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    lib = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,  # noqa: E731
                                      retain_graph=True)
    kern = lambda: fops.flash_attention_bwd(q, k, v, out, lse, dout)  # noqa
    runs = []
    for tree, src in zip(trees, srcs):
        fops.BWD_SOURCE = src
        err = max(check_close("flash_bwd", x, y, f"{name} of {tree}")
                  for name, x, y in zip(("dq", "dk", "dv"), kern(), want))
        ms, sdpa = cuda_ms(kern, 20), cuda_ms(lib, 20)
        us = flash_bwd_kernel_us(kern)
        runs.append({"tree": str(tree), "ms": ms, "sdpa_backward_ms": sdpa,
                     "max_abs_err": err, "device_us": us})
        print(f"flash_bwd of {tree}: {ms:.4f} ms (SDPA backward {sdpa:.4f} "
              "ms); device us a launch " + ", ".join(
                  f"{n} {t:.1f}" for n, t in us.items()))
    print(json.dumps({"flash_bwd_versus": runs}))


def phase_shape_timings(dev, errs: dict, serve: dict, train: dict) -> list:
    """Slice 8's kernel shapes (FLASH_SHAPES): flash_fwd at DeepSeek-MoE's
    prefill and Whisper's encoder, flash_bwd at Whisper's encoder; each
    timed in turns with PyTorch's SDPA (its backward alone for flash_bwd)
    on the same tensors, beside its plain version, its bound and its
    launches a path run (a generate; a train step)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for cell, (b, s, h, g, d, causal) in FLASH_SHAPES.items():
        q, k, v = flash_inputs(gen, b, s, h, g, d, torch.bfloat16, dev)
        pairs = s * (s + 1) / 2 if causal else s * s
        fwd_flops = 4 * b * h * d * pairs
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        kern = lambda: fops.flash_attention_fwd(q, k, v, causal=causal)  # noqa
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal)
        with torch.no_grad():
            turns = [cuda_ms(kern, 20), cuda_ms(lib, 20), cuda_ms(kern, 20)]
        bnd, bby = bound(2 * (2 * b * s * h * d + 2 * b * s * g * d),
                         fwd_flops, PEAK_BF16_FLOPS)
        steps = train[cell]["launches_per_step"]
        launch = {"generate": serve[cell]["launches"],
                  "train_step": steps.get("flash_fwd", 0),
                  "train_layers": train[cell]["layers"]}
        rows.append({"name": "flash_fwd", "cell": cell,
                     "shape": dict(b=b, s=s, h=h, g=g, d=d, causal=causal),
                     "launches": launch, "max_abs_err":
                     errs[f"flash_fwd {cell}"], "ms": (turns[0] + turns[2]) / 2,
                     "plain_ms": cuda_ms(lambda: fref.attention_ref(
                         q, k, v, causal=causal), 3),
                     "bound_ms": bnd, "bound_by": bby, "library_ms": turns[1],
                     "flops": fwd_flops})
        if f"flash_bwd {cell}" in errs:
            out, lse = fops.flash_attention_fwd(q, k, v, causal=causal,
                                                return_lse=True)
            dout = torch.randn(q.shape, generator=gen, device=dev).to(
                torch.bfloat16)
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = dout.transpose(1, 2).contiguous()
            kern = lambda: fops.flash_attention_bwd(  # noqa: E731
                q, k, v, out, lse, dout, causal=causal)
            lib = lambda: torch.autograd.grad(  # noqa: E731
                ot, (qt, kt, vt), dot, retain_graph=True)
            turns = [cuda_ms(kern, 10), cuda_ms(lib, 10), cuda_ms(kern, 10)]
            flops = 2.5 * fwd_flops              # five products
            bnd, bby = bound(2 * (4 * b * s * h * d + 4 * b * s * g * d)
                             + 4 * b * s * h, flops, PEAK_BF16_FLOPS)
            rows.append({
                "name": "flash_bwd", "cell": cell, "shape": rows[-1]["shape"],
                "launches": {"train_step": steps.get("flash_bwd", 0),
                             "train_layers": train[cell]["layers"]},
                "max_abs_err": errs[f"flash_bwd {cell}"],
                "ms": (turns[0] + turns[2]) / 2,
                "plain_ms": cuda_ms(lambda: fref.attention_bwd_ref(
                    q, k, v, out, lse, dout, causal=causal), 3),
                "bound_ms": bnd, "bound_by": bby, "library_ms": turns[1],
                "flops": flops})
            del out, lse, dout, ot, dot
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    for r in rows:
        print(f"timing {r['name']} at {r['cell']}'s shape "
              f"{json.dumps(r['shape'])}: kernel {r['ms']:.4f} ms "
              f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound), SDPA "
              f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); launches "
              f"{json.dumps(r['launches'])}")
    return rows


def phase_train(dev, errs: dict) -> tuple[dict, dict]:
    """Slice 5: the training path.  Returns (per-model rows, flash_bwd's
    timing row)."""
    bwd_errs, ssd_ms = check_train_kernels(dev)
    errs.update(bwd_errs)
    timing, kernel_us = flash_bwd_timing(dev)
    torch.cuda.empty_cache()
    rows = {arch: train_full(dev, arch) for arch in TRAIN_CELLS}
    rows["mamba2-2.7b"]["ssd_backward_ms_a_layer"] = ssd_ms
    rows["llama3.2-3b"]["flash_bwd_device_us"] = kernel_us
    train_smoke_configs(dev)
    for arch in ("llama3.2-3b", "deepseek-moe-16b", "whisper-large-v3"):
        train_crash_resume(dev, arch)
    return rows, timing


def launch_cost(tree: Path) -> dict:
    """Host microseconds per call (:func:`host_us`, LAUNCH_COST_CALLS calls
    a case) of the proxy-block wrappers of the checkout ``tree`` at the
    main path's shapes, of the pieces a wrapper is made of and of two
    PyTorch calls as yardsticks; then the wall time of three warm ``run_all()`` calls and of
    ``time_all(iters=3)`` on the 64-rank trace.  Meant for a fresh process:
    it imports ``tree``'s ``repro_torch``."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core import blocks
    from repro_torch.core.synthesize import synthesize
    from repro_torch.core.trace_ir import TraceStore
    from repro_torch.kernels import build
    from repro_torch.kernels.proxy_blocks import ops
    from repro_torch.workloads import synthetic_rank_traces

    dev = torch.device("cuda", 0)
    st = blocks.init_state(0, dev)
    a, b, v = st["a"], st["b"], st["v"]
    ops.mxu_iter(a, b, 1, 1.0)          # build, load and type the launchers
    ops.stream_iter(v, 1)
    launch = build.load(ops.SOURCE).mxu_iter_launch
    cases = {
        "mxu_iter reps=5": lambda: ops.mxu_iter(a, b, 5, 1.0),
        "mxu_iter reps=0": lambda: ops.mxu_iter(a, b, 0, 1.0),
        "stream_iter reps=5": lambda: ops.stream_iter(v, 5),
        "stream_iter reps=0": lambda: ops.stream_iter(v, 0),
        "torch.matmul(a, b)": lambda: torch.matmul(a, b),
        "torch.empty_like(v)": lambda: torch.empty_like(v),
        # the pieces of a wrapper, and cheaper stand-ins
        "build.load(ops.SOURCE)": lambda: build.load(ops.SOURCE),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "a.shape[-2:] == (128, 128)": lambda: a.shape[-2:] == (128, 128),
        "a.device.type": lambda: a.device.type,
        "a.is_cuda": lambda: a.is_cuda,
        # the ctypes call alone: a batch of 0 returns before any launch
        "ctypes mxu_iter_launch, batch 0":
            lambda: launch(0, 0, 0, 0, 0, 0, 1.0, 0),
    }
    host = {name: host_us(fn, LAUNCH_COST_CALLS)
            for name, fn in cases.items()}
    store = TraceStore.from_rank_traces(synthetic_rank_traces(N_RANKS),
                                        {"x": N_RANKS})
    res = synthesize(store=store, device=dev,
                     out_dir=ROOT / "build" / "launch_cost")
    res.proxy.run_all()                 # warm
    run_all_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        res.proxy.run_all()             # ends in a synchronise
        run_all_ms.append(1e3 * (time.perf_counter() - t0))
    return {"tree": str(tree), "calls": LAUNCH_COST_CALLS, "host_us": host,
            "run_all_ms": run_all_ms,
            "time_all_ms": 1e3 * res.proxy.time_all(iters=3)}


def phase_launch_cost(trees: list[Path]) -> None:
    """:func:`launch_cost` of each tree in turn, each in a process of its
    own, in the order given: name one tree twice and another between
    (``OLD NEW NEW OLD``) to compare two launch paths on one card."""
    runs = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, __file__, "--launch-cost-child", str(tree)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"launch cost of {tree}: {proc.stderr.strip()[-2000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        for name, us in run["host_us"].items():
            print(f"launch cost {tree}: {name}: {us:.3f} us a call")
        print(f"launch cost {tree}: run_all " + ", ".join(
            f"{ms:.2f}" for ms in run["run_all_ms"]) +
            f" ms; time_all {run['time_all_ms']:.2f} ms")
    out = ROOT / "build" / "launch_cost.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(runs, indent=1))
    print(json.dumps({"launch_cost": runs}))


def main() -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--launch-cost", nargs="+", type=Path, metavar="TREE",
                   help="only time the proxy-block wrappers' host cost per "
                   "call and run_all of each checkout, in turns")
    p.add_argument("--launch-cost-child", type=Path, help=argparse.SUPPRESS)
    p.add_argument("--flash-bwd-vs", nargs="+", type=Path, metavar="TREE",
                   help="only time flash_bwd built from each checkout's "
                   "backward.cu at the main shape, in turns")
    args = p.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if args.launch_cost_child is not None:
        print(json.dumps(launch_cost(args.launch_cost_child.resolve())))
        return
    if args.launch_cost:
        phase_device()
        phase_launch_cost(args.launch_cost)
        return
    if args.flash_bwd_vs:
        phase_device()
        phase_flash_bwd_versus(args.flash_bwd_vs)
        return
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"repro_torch not importable from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda", 0)
    device = phase_device()
    phase_build()
    errs = phase_kernels(dev)
    errs.update(phase_zoo_kernels(dev))
    launches, res = phase_main_path(dev)
    phase_profile(res)
    phase_per_rank_seeds(res)
    del res
    serve = {arch: phase_serve(dev, arch) for arch in SERVE_CELLS}
    launches["flash_fwd"] = serve["llama3.2-3b"]["launches"]
    launches["ssd_diag"] = serve["mamba2-2.7b"]["launches"]
    print(json.dumps({"serve": serve}))
    phase_smoke_configs(dev)
    rows = phase_timings(dev, launches, errs)
    train, bwd = phase_train(dev, errs)
    print(json.dumps({"train": train}))
    print(json.dumps({"shapes": phase_shape_timings(dev, errs, serve,
                                                     train)}))
    t0 = time.perf_counter()
    trace = phase_trace(dev)
    trace["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"trace": trace}))
    rows.append({"name": "flash_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/"
                           "backward.cu",
                 # no TPU kernel: the reference's backward is an XLA custom
                 # VJP; the Pallas forward it pairs with
                 "replaces": "src/repro/models/flash.py:219",
                 "launches": train["llama3.2-3b"]["launches"]["flash_bwd"],
                 "max_abs_err": errs["flash_bwd"], **bwd})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
