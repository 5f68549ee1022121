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
  and ``ssd_diag_bwd``) at full width and depth, bf16, random weights
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
  trace phase, and the walker's DeepSeek and Whisper prefill and decode;
- slice 9: the VLM and the rest of the paper's single-trace pipeline.
  The roofline constants the H100's data sheet does not give
  (``repro_torch.core.metrics``), measured; ``flash_fwd`` at Llama 3.2
  Vision 90B's self-attention (GQA 64/8, causal) and cross-attention
  (2048 queries to 1601 vision states, unmasked) against their plain
  versions; the 64-rank trace's unrolled codegen flavor against the table
  flavor (delta_bar, executed comm sequences, launches, states) and its
  seeded noisy replay (bit-identical on repeat and across flavors, its
  mean inside the CPU's band); the paper's Figs. 5-6 and Table 3 rows;
  ``ServeEngine.generate`` on Llama 3.2 Vision 90B at its published widths
  and 30 of its 100 layers (``SERVE_DEPTH``; 30 self and 6 cross
  ``flash_fwd`` a generate), with its consistency on random vision
  embeddings; the VLM smoke config on the card against the CPU (serve and
  a training step);
- slice 10: the corpus tier (:func:`phase_corpus`).  The five zoo scenarios
  at 64 ranks streamed into a ``CorpusStore`` (``ingest_scenarios``) with
  the 64-rank synthetic trace; ``synthesize_corpus`` of the six in one
  batch, its one PGD fit on the card (a target alone against the same
  target in a batch of 64, the card's fits against the CPU's), a replay of
  every proxy (the proxy-block launches the tables predict) and
  ``report()``; the store ingested again by a forked pool of 4 after the
  card is initialised (bit-identical to serial); synthesis from the store
  (bit-identical to batch), unchanged (no solver call) and after a removal
  (bit-identical to a from-scratch synthesis of the survivors); a
  ``ProxyService`` over the store (single and batched queries, a refresh
  equal to a rebuilt service, ``predict_all`` over the port's cards, on
  the H100 against the walker); and the chaos sweep of every fault point
  of the store (``repro_torch.core.chaos``);
- slice 11: the mesh-sharded replay tier (:func:`phase_mesh`) on a
  one-process NCCL group started in process: the 64-rank trace's
  ``run_all(mesh=..., per_rank_seeds=True)`` bit-equal to LocalSim's, its
  800 + 800 proxy-block launches, delta_bar and the noisy distribution
  bit-identical with ``mesh_checked``, the NCCL kernels and c10d calls of
  a sweep under the profiler, one sweep's result broadcasts timed apart
  from the rest, ``time_all(mesh=)`` and ``time_local(0)``; then the four
  example scripts at their published sizes (:func:`phase_examples`: the
  quickstart, whose delta_bar must equal the CPU's to 1e-12, the pipeline,
  serve-and-proxy, and ``torch_train_e2e.py --full``, whose loss must
  drop);
- slice 12: data-parallel training (:func:`phase_dp_train`) on a
  one-process NCCL group: Llama 3.2 3B at full width, 4 x 2048, through
  ``Trainer(mesh=make_dp_mesh(1))`` bit-equal to ``Trainer(None)`` and
  through the int8 error-feedback ``make_manual_dp_train_step`` (56
  ``flash_fwd`` and 28 ``flash_bwd`` a step, one int32 all-reduce a
  parameter leaf, its falling loss, step ms, peak memory and the
  compression's ms); the smoke Llama's DP steps and mesh trainer on the
  card against the same code on the CPU under gloo, with a bit-identical
  crash/resume; and each instrumented collective wrapper on a CUDA tensor;
- slice 13: tensor parallel (:func:`phase_tp`) on two processes of the one
  card (a data 1 x model 2 mesh, gloo carrying CUDA tensors): the f32
  smoke Llama, Gemma 3 and Mamba2 against one device (prefill, greedy
  tokens, a train step), Llama 3.2 3B and Mamba2 2.7B served at full width
  against one device (Mamba2 also cut to 8 layers in f32, through a prefill
  and decode steps), one full-width Llama train step, and a process's
  kernel shapes timed;
- slice 14: the rest of sharded execution on the same two processes: the
  f32 smoke Whisper, VLM, DeepSeek-MoE, Mixtral and Jamba and a 3-head
  Llama variant in the ``"batch"`` and ``"cp"`` attention modes against one
  device; DeepSeek-MoE 16B (32 experts a process), Whisper large-v3 (10
  heads a process) and the VLM at 2 of its 20 units served at full width
  against one device, with their prefill/decode consistency on the mesh;
  one DeepSeek-MoE train step at its 9-layer cut against one device; and
  ``flash_fwd``/``flash_bwd`` with a query offset at a ``cp`` shape, held
  to their plain versions and timed beside SDPA with the equivalent mask;
- slice 15: the launch tier (:func:`phase_dryrun`): the dry run's entry
  point walks Llama 3.2 3B's ``train_4k`` on the production meshes of one
  and two pods (a fake world of 256 and 512 processes on meta tensors, in
  a subprocess that sees no card), and the train phase's own Llama step on
  one device, whose predicted argument + temp bytes must land within
  0.8-1.25x of the warm step's measured peak; no kernel launches.

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
import os
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
#: mxu_iter and stream_iter launches of one sweep of the 64-rank trace, each
N_PROXY_LAUNCHES = 800
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
#: of d 128 it drifts 0.442 (tests/test_torch_serve_drift.py::test_bf16_drift_
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
                         "whisper-large-v3": 0.05,
                         "llama-3.2-vision-90b": 0.05}
#: serve cells: prompt length (Whisper's 416 + 32 new tokens are its
#: published 448 decoder positions); each launches its kernel once an
#: attention (or SSD) layer of the prefill: the encoder's, for Whisper
SERVE_CELLS = {"llama3.2-3b": (2048, "flash_fwd"),
               "mamba2-2.7b": (2048, "ssd_diag"),
               "deepseek-moe-16b": (2048, "flash_fwd"),
               "whisper-large-v3": (416, "flash_fwd"),
               "llama-3.2-vision-90b": (2048, "flash_fwd")}
#: serve cells cut in depth: Llama 3.2 Vision 90B's 89.6 B parameters (179
#: GB in bf16) do not fit one card; 6 of its 20 units of four self-attention
#: layers and one cross-attention layer (30 of 100 layers) are 27.6 B
#: parameters, 51.5 GiB, at the published widths
SERVE_DEPTH = {"llama-3.2-vision-90b": 30}
#: the f32 consistency checks' cut depths: the f32 weights of all layers do
#: not fit beside the bf16 ones (DeepSeek-MoE's 62 GiB; the VLM's cut at
#: one unit of five layers, 20 GiB in f32)
F32_CUT = {"deepseek-moe-16b": 8, "llama-3.2-vision-90b": 5}
SSM_LAYER_BF16_RTOL = 2.0 ** -4
#: calls a case of --launch-cost: 20 processes of it fit in a quarter hour
LAUNCH_COST_CALLS = 2000
SMOKE_PROMPTS = {"llama3.2-3b": 1024, "mamba2-2.7b": 256, "gemma3-4b": 1024,
                 "deepseek-moe-16b": 1024, "mixtral-8x22b": 1024,
                 "jamba-v0.1-52b": 256, "whisper-large-v3": 1024,
                 "llama-3.2-vision-90b": 1024}


#: the card's name and power limit, as nvidia-smi gives them (phase_device)
CARD = "not read"


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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(CARD)
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
                "ssd/backward.cu": ("ssd_bwd_kernel",),
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


#: slice 9's noisy replay of the 64-rank trace
NOISE_SEED, NOISE_REPLICAS = 3, 4


def executed_comms(res, rank: int) -> list:
    """The collectives ``rank``'s replay issues, in order, on the card: a
    LocalSim that records every ``do``."""
    from repro_torch.sharding.collectives import LocalSim

    calls: list = []

    class Recorder(LocalSim):
        def do(self, st, buf, *, kind, axes, detail, shape, dtype):
            calls.append((kind, tuple(axes), tuple(detail), tuple(shape),
                          dtype))
            return super().do(st, buf, kind=kind, axes=axes, detail=detail,
                              shape=shape, dtype=dtype)

    res.proxy.module.run_rank(res.proxy.init_state(0), Recorder(), rank)
    return calls


def phase_flavors_and_noise(dev, res) -> dict:
    """Slice 9 on the 64-rank trace: the unrolled codegen flavor against
    the table flavor of phase_main_path (delta_bar and the executed comm
    sequence of every signature group bit-identical, the same
    mxu_iter/stream_iter launches, equal final states); then seeded noisy
    replay, run_all(noise=NoiseConfig(3, 4)): its ms and launches beside
    the deterministic run_all's, the distribution bit-identical on repeat
    and across the flavors, and its mean inside the CPU run's ci()."""
    import dataclasses
    import numpy as np
    from repro_torch.core import noise as N
    from repro_torch.core.replay import ProxyProgram
    from repro_torch.core.synthesize import synthesize

    t0 = time.perf_counter()
    unrolled = synthesize(store=res.store, device=dev, codegen="unrolled",
                          name="proxy_unrolled",
                          out_dir=ROOT / "build" / "chip_smoke")
    t1 = time.perf_counter()
    if unrolled.stats["codegen"] != "unrolled":
        fail(f"codegen stats {unrolled.stats['codegen']!r}")
    runs = {}
    for name, r in (("table", res), ("unrolled", unrolled)):
        r.proxy.run_all()                       # warm
        reset_counts()
        t = time.perf_counter()
        states = r.proxy.run_all()
        runs[name] = (states, 1e3 * (time.perf_counter() - t), read_counts())
    (st_t, ms_t, l_t), (st_u, ms_u, l_u) = runs["table"], runs["unrolled"]
    print(f"unrolled flavor: synthesize {1e3 * (t1 - t0):.1f} ms, "
          f"{unrolled.stats['source_lines']} source lines (table "
          f"{res.stats['source_lines']}); run_all {ms_u:.1f} ms (table "
          f"{ms_t:.1f}); launches {json.dumps(l_u)} (table {json.dumps(l_t)})")
    if l_u != l_t or l_t["mxu_iter"] <= 0 or l_t["stream_iter"] <= 0:
        fail(f"unrolled launches {l_u} != table {l_t}")
    for r in st_t:
        if any(not torch.equal(st_t[r][k], st_u[r][k]) for k in st_t[r]):
            fail(f"unrolled final state of rank {r} differs from the table's")
    ft, fu = res.fidelity(sample_ranks=None), unrolled.fidelity(
        sample_ranks=None)
    if not (np.array_equal(ft.delta, fu.delta) and ft.comm_lossless
            and fu.comm_lossless):
        fail(f"unrolled delta_bar {fu.mean!r} != table {ft.mean!r} or not "
             "lossless")
    for _sig, grp in res.proxy.signature_groups():
        got_t, got_u = executed_comms(res, grp[0]), executed_comms(
            unrolled, grp[0])
        want = [(e.kind, tuple(e.axes), tuple(e.detail), tuple(e.shape),
                 e.dtype) for e in (res.merged.table[i] for i in
                                    res.proxy.expand_rank_ids(grp[0]))
                if hasattr(e, "kind")]
        if not got_t == got_u == want:
            fail(f"executed comm sequence of rank {grp[0]} differs across "
                 "flavors or from the trace")
    print(f"unrolled flavor: delta_bar {fu.mean!r} bit-identical to the "
          f"table's; executed comm sequences of the "
          f"{len(res.proxy.signature_groups())} groups identical")

    cfg = N.NoiseConfig(seed=NOISE_SEED, n_replicas=NOISE_REPLICAS)
    res.proxy.run_all(noise=cfg)                # warm
    reset_counts()
    t = time.perf_counter()
    noisy = res.proxy.run_all(noise=cfg)
    ms_noisy = 1e3 * (time.perf_counter() - t)
    l_noisy = read_counts()
    draws = [int(noisy[g[0]][N.NOISE_KEY][0, 2])
             for _s, g in res.proxy.signature_groups()]
    print(f"noisy run_all (seed {cfg.seed}, {cfg.n_replicas} replicas): "
          f"{ms_noisy:.1f} ms, launches {json.dumps(l_noisy)}; "
          f"deterministic {ms_t:.1f} ms, {json.dumps(l_t)}; draws a "
          f"replica by group {draws}")
    if l_noisy != l_t:
        fail(f"noisy launches {l_noisy} != deterministic {l_t}")
    a = res.fidelity(sample_ranks=None, noise=cfg)
    b = res.fidelity(sample_ranks=None, noise=cfg)
    c = unrolled.fidelity(sample_ranks=None, noise=cfg)
    for what, other in (("repeat", b), ("unrolled flavor", c)):
        if not (np.array_equal(a.replica_delta, other.replica_delta)
                and np.array_equal(a.comm_bytes, other.comm_bytes)):
            fail(f"noisy distribution differs on {what}")
    cpu = dataclasses.replace(res, proxy=ProxyProgram(
        res.source, res.proxy.module, res.merged, res.proxy.combos,
        res.proxy.axis_sizes, device="cpu"))
    d = cpu.fidelity(sample_ranks=None, noise=cfg)
    lo, hi = d.ci()
    print(f"noisy delta_bar: card {a.mean!r} (ci {a.ci()}), CPU {d.mean!r} "
          f"(ci {(lo, hi)}); deterministic {ft.mean!r}; bit-identical on "
          "repeat and across flavors")
    if not lo <= a.mean <= hi:
        fail(f"the card's noisy mean {a.mean} is outside the CPU's ci "
             f"{(lo, hi)}")
    return {"unrolled_synthesize_ms": 1e3 * (t1 - t0),
            "run_all_ms": {"table": ms_t, "unrolled": ms_u,
                           "noisy": ms_noisy},
            "launches": {"table": l_t, "unrolled": l_u, "noisy": l_noisy},
            "delta_bar": ft.mean, "noisy_mean": a.mean,
            "noisy_ci": list(a.ci()), "noisy_mean_cpu": d.mean,
            "noisy_ci_cpu": [lo, hi], "draws_a_replica": draws}


def phase_mesh(dev, res) -> dict:
    """Slice 11: the mesh-sharded replay tier on a one-process NCCL group
    (started in process on a HashStore: no network).  On the 64-rank trace,
    run_all(mesh=make_replay_mesh(submesh_axis_sizes(1, axes)),
    per_rank_seeds=True) must give final states bit-equal to LocalSim's
    run_all(per_rank_seeds=True): every collective runs over a group of
    one, where each kind is the identity in exact arithmetic.  Its
    mxu_iter/stream_iter launches must equal LocalSim's (800 each);
    delta_bar must be bit-identical with mesh_checked, and the seeded noisy
    distribution bit-identical under the mesh.  Reports the NCCL kernels a
    sweep launches (profiler), run_all(mesh=) against run_all() ms, the
    split of one mesh sweep between its result broadcasts (``_share``: the
    c10d broadcast and the receivers' copies, the card synchronized before
    and after each) and the rest, time_all(mesh=) and time_local(0).
    Destroys the group at the end."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.noise import NoiseConfig
    from repro_torch.core.replay import submesh_axis_sizes
    from repro_torch.launch.mesh import make_replay_mesh

    p = res.proxy
    p.run_all(per_rank_seeds=True)              # warm
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_replay_mesh(submesh_axis_sizes(1, p.axis_sizes))
        plan = p.mesh_sweep_plan(mesh)
        p.run_all(mesh=mesh, per_rank_seeds=True)     # warm: NCCL set-up
        # in turns, LocalSim, mesh, mesh, LocalSim; counts read per run
        runs = {"local": [], "mesh": []}
        for which in ("local", "mesh", "mesh", "local"):
            reset_counts()
            t = time.perf_counter()
            out = p.run_all(mesh=mesh if which == "mesh" else None,
                            per_rank_seeds=True)
            runs[which].append((1e3 * (time.perf_counter() - t),
                                read_counts()))
            if which == "mesh":
                states = out
            else:
                local = out
        ms_mesh = [ms for ms, _ in runs["mesh"]]
        ms_local = [ms for ms, _ in runs["local"]]
        launches, l_local = runs["mesh"][0][1], runs["local"][0][1]
        print(f"mesh: {len(plan)} placements "
              f"{[(pl.device_ids, pl.axis_sizes) for pl in plan]}; "
              f"run_all(mesh=) {ms_mesh} ms, LocalSim run_all "
              f"{ms_local} ms (per-rank seeds, in turns); launches "
              f"{json.dumps(launches)} (LocalSim {json.dumps(l_local)})")
        for name in ("mxu_iter", "stream_iter"):
            for which, rows in runs.items():
                if any(c[name] != N_PROXY_LAUNCHES for _, c in rows):
                    fail(f"{which} sweep launched {name} "
                         f"{[c[name] for _, c in rows]} times, not "
                         f"{N_PROXY_LAUNCHES}")
        if sorted(states) != sorted(local):
            fail("mesh run_all did not return every rank")
        for r in local:
            for k in local[r]:
                if not torch.equal(states[r][k], local[r][k]):
                    fail(f"mesh state of rank {r} leaf {k} differs from "
                         "LocalSim's")
        stats = p.cache_stats()
        fm = res.fidelity(sample_ranks=None, mesh=mesh)
        fl = res.fidelity(sample_ranks=None)
        if not (np.array_equal(fm.delta, fl.delta) and fm.mesh_checked
                and fm.comm_lossless):
            fail(f"mesh delta_bar {fm.mean!r} != LocalSim {fl.mean!r}, or "
                 f"mesh_checked {fm.mesh_checked}")
        cfg = NoiseConfig(seed=NOISE_SEED, n_replicas=NOISE_REPLICAS)
        dm = res.fidelity(sample_ranks=None, mesh=mesh, noise=cfg)
        dl = res.fidelity(sample_ranks=None, noise=cfg)
        if not (np.array_equal(dm.replica_delta, dl.replica_delta)
                and np.array_equal(dm.comm_bytes, dl.comm_bytes)
                and dm.mesh_checked):
            fail("the noisy distribution differs under the mesh")
        print(f"mesh: states bit-equal to LocalSim's; delta_bar "
              f"{fm.mean!r} bit-identical, mesh_checked {fm.mesh_checked}; "
              f"noisy mean {dm.mean!r} bit-identical; cache {stats}")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            p.run_all(mesh=mesh, per_rank_seeds=True)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        rows = kernel_times(prof)
        nccl = {key: n for _t, n, key in rows if "nccl" in key.lower()}
        calls = {e.key: e.count for e in prof.key_averages()
                 if e.key.startswith("nccl:")}
        print(f"mesh profile: wall {wall:.1f} ms under the profiler, "
              f"{sum(r[1] for r in rows)} kernel launches, "
              f"{sum(r[0] for r in rows) / 1e3:.2f} ms of device kernels; "
              f"NCCL kernels {json.dumps(nccl)}; c10d NCCL calls "
              f"{json.dumps(calls)}")
        share_ms = []
        share = p._share

        def timed_share(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = share(*args)
            torch.cuda.synchronize()
            share_ms.append(1e3 * (time.perf_counter() - t))
            return out

        p._share = timed_share
        try:
            t = time.perf_counter()
            p.run_all(mesh=mesh, per_rank_seeds=True)
            torch.cuda.synchronize()
            ms_split = 1e3 * (time.perf_counter() - t)
        finally:
            del p._share
        t = time.perf_counter()
        p.run_all(per_rank_seeds=True)
        ms_split_local = 1e3 * (time.perf_counter() - t)
        print(f"mesh split: run_all(mesh=) {ms_split:.2f} ms, of which "
              f"{len(share_ms)} result broadcasts {sum(share_ms):.2f} ms "
              f"({[round(x, 3) for x in share_ms]}) and the rest "
              f"{ms_split - sum(share_ms):.2f} ms; LocalSim run_all "
              f"{ms_split_local:.2f} ms next ({CARD})")
        ms_time_all = 1e3 * p.time_all(mesh=mesh, per_rank_seeds=True,
                                       iters=3)
        ms_time_all_local = 1e3 * p.time_all(per_rank_seeds=True, iters=3)
        ms_local0 = 1e3 * p.time_local(0, iters=3)
        print(f"mesh: time_all(mesh=) {ms_time_all:.2f} ms, time_all() "
              f"{ms_time_all_local:.2f} ms (per-rank seeds, mean of 3); "
              f"time_local(0) {ms_local0:.3f} ms ({CARD})")
    finally:
        dist.destroy_process_group()
    return {"placements": len(plan), "run_all_mesh_ms": ms_mesh,
            "run_all_local_ms": ms_local, "launches": launches,
            "nccl_launches": sum(nccl.values()), "nccl_kernels": nccl,
            "nccl_calls": calls, "split_mesh_ms": ms_split,
            "split_share_ms": share_ms, "split_local_ms": ms_split_local,
            "time_all_mesh_ms": ms_time_all,
            "time_all_local_ms": ms_time_all_local,
            "time_local_ms": ms_local0, "delta_bar": fm.mean,
            "noisy_mean": dm.mean, "card": CARD}


#: each example at its published size (the reference's defaults; the
#: trainer at its --full size)
EXAMPLES = (("torch_quickstart", []), ("torch_pipeline_proxy", []),
            ("torch_serve_and_proxy", []), ("torch_train_e2e", ["--full"]))


def quickstart_cpu_delta(mod) -> float:
    """The quickstart's delta_bar at its published length, synthesized on
    the CPU (the value the CPU tests hold to the reference's to 1e-12)."""
    from repro_torch.core.synthesize import synthesize
    from repro_torch.core.trace_ir import TraceStore
    from repro_torch.core.tracer import trace_fn

    trace = trace_fn(mod.stencil(12), torch.ones((256, 128)),
                     torch.ones((128, 128)) * 0.01, axis_sizes={"x": mod.N})
    res = synthesize(store=TraceStore.from_template(trace, {"x": mod.N}),
                     name="stencil_proxy_cpu", device="cpu",
                     out_dir=ROOT / "build" / "chip_smoke" / "quickstart_cpu")
    return res.fidelity().mean


def phase_examples() -> dict:
    """Item 13: the four example scripts at their published sizes on the
    card, in process (each script's main(); nothing caught: a failing
    script, or a loss that does not drop, fails the run)."""
    import importlib.util
    import shutil

    import numpy as np

    ckpt = ROOT / "build" / "chip_smoke" / "train_e2e_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    out = {}
    for name, argv in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if name == "torch_train_e2e":
            argv = argv + ["--ckpt-dir", str(ckpt)]
        print(f"--- examples/{name}.py {' '.join(argv)}")
        reset_counts()
        t0 = time.perf_counter()
        got = mod.main(argv)
        secs = time.perf_counter() - t0
        row = {"s": secs, "launches": read_counts()}
        if name == "torch_quickstart":
            result, fid = got
            cpu_mean = quickstart_cpu_delta(mod)
            row.update(delta_bar=fid.mean, cpu_delta_bar=cpu_mean,
                       lossless=fid.comm_lossless)
            if not fid.comm_lossless:
                fail("quickstart: comm not lossless")
            if not abs(fid.mean - cpu_mean) <= 1e-12:
                fail(f"quickstart: delta_bar {fid.mean!r} on the card, "
                     f"{cpu_mean!r} on the CPU")
            if not all(row["launches"][k] > 0
                       for k in ("mxu_iter", "stream_iter")):
                fail(f"quickstart's replay did not go through the proxy-"
                     f"block kernels: {row['launches']}")
        elif name == "torch_pipeline_proxy":
            row.update(delta_bar=got[1].mean, lossless=got[1].comm_lossless)
        elif name == "torch_serve_and_proxy":
            gen, _result, fid = got
            row.update(tokens_per_s=gen.tokens_per_sec,
                       prefill_ms=1e3 * gen.prefill_sec, delta_bar=fid.mean)
        else:
            losses = [m["loss"] for m in got]
            row.update(steps=len(got), first_loss=losses[0],
                       last_loss=losses[-1],
                       step_ms=1e3 * float(np.median(
                           [m["sec"] for m in got[5:]])))
        print(f"--- {name}: {secs:.1f} s, {json.dumps(row)}")
        out[name] = row
    return out


def phase_baselines(dev) -> dict:
    """The paper's comparisons on the card: Figs. 5-6 (Siesta's QP fit
    against MINIME's greedy, one aggregate event and per event summed) on
    stencil2d, dp_train and the pipeline at 8 ranks, and Table 3 (events,
    trace and grammar bytes, ratio, synthesize seconds, delta_bar,
    lossless) at 4 and 8 ranks, each Table 3 row against the same
    synthesis on the CPU."""
    from repro_torch.core.baselines import fig56_rows, table3_row
    from repro_torch.core.events import ComputeEvent
    from repro_torch.core.synthesize import synthesize
    from repro_torch.core.tracer import trace_fn
    from repro_torch.workloads import PROGRAMS, pipeline_traces

    fig = []
    for name, make in PROGRAMS.items():
        fn, args, axes = make(8)
        tr = trace_fn(fn, *args, axis_sizes=axes)
        fig += fig56_rows(name, [e.vector for e in tr.compute_events()])
    fig += fig56_rows("pipeline", [e.vector for e in pipeline_traces(8)[0]
                                   if isinstance(e, ComputeEvent)])
    for r in fig:
        print(f"fig 5-6 {r['program']} {r['mode']}: siesta "
              f"{r['siesta_err']!r}, minime {r['minime_err']!r}")
        if not r["siesta_err"] < r["minime_err"]:
            fail(f"fig 5-6 {r}: the QP does not beat the greedy")
    out_dir = ROOT / "build" / "chip_smoke_table3"
    table = []
    for name in (*PROGRAMS, "pipeline"):
        for n in (4, 8):
            rows = {}
            for where in ("cuda", "cpu"):
                kw = dict(device=None if where == "cuda" else "cpu",
                          name=f"{name}_{n}", out_dir=out_dir / where)
                t0 = time.perf_counter()
                if name == "pipeline":
                    res = synthesize(rank_traces=pipeline_traces(n),
                                     axis_sizes={"stage": n}, **kw)
                else:
                    fn, args, axes = PROGRAMS[name](n)
                    res = synthesize(fn, *args, axis_sizes=axes, **kw)
                if where == "cuda":
                    torch.cuda.synchronize()
                rows[where] = table3_row(name, n, res,
                                         time.perf_counter() - t0)
            row, cpu = rows["cuda"], rows["cpu"]
            print(f"table 3 {json.dumps(row)}")
            same = {k: row[k] == cpu[k] for k in row
                    if k not in ("synth_sec", "rel_err")}
            if not all(same.values()) or not row["lossless_comm"] or \
                    abs(row["rel_err"] - cpu["rel_err"]) > TRACE_DELTA_ATOL:
                fail(f"table 3 {name} at {n}: the card's row {row} differs "
                     f"from the CPU's {cpu}")
            table.append(row)
    return {"fig56": fig, "table3": table}


#: a microbenchmark of the SFU: dependent __expf chains, four a thread
PROBE_SOURCE = r"""
#include <cuda_runtime.h>

extern "C" const char* cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}

__global__ void exp_chain_kernel(float* out, int iters) {
  float a = threadIdx.x * 1e-7f, b = a + 0.25f, c = a + 0.5f, d = a + 0.75f;
  for (int i = 0; i < iters; ++i) {
    a = __expf(-a); b = __expf(-b); c = __expf(-c); d = __expf(-d);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a + b + c + d;
}

extern "C" int exp_chain(float* out, int blocks, int threads, int iters,
                         void* stream) {
  exp_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def phase_constants(dev) -> dict:
    """Measure the roofline constants the H100's data sheet does not give
    (``repro_torch.core.metrics``: TRANS_RATE, GATHER_RATE, SCAN_OVERHEAD)
    and print them beside the module's values: exps/s of dependent
    ``__expf`` chains on every SM; f32 elements/s of ``torch.take`` of
    2^24 random indices from a 2^28-element table; seconds a turn of
    ``tracer.counted_loop`` whose body is one elementwise op."""
    import ctypes
    from repro_torch.core import metrics
    from repro_torch.core.tracer import counted_loop
    from repro_torch.kernels import build

    src = ROOT / "build" / "chip_smoke" / "probe" / "kernel.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_SOURCE)
    lib = build.load(src, {"exp_chain": ([ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p], ctypes.c_int)})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = 16 * sms, 256, 8192
    out = torch.empty(blocks * threads, device=dev)

    def chain():
        build.check(lib, lib.exp_chain(
            out.data_ptr(), blocks, threads, iters,
            torch.cuda.current_stream(dev).cuda_stream), "exp_chain")

    trans = 4 * blocks * threads * iters / (1e-3 * cuda_ms(chain, 5))
    if not torch.isfinite(out).all():
        fail("exp_chain gave non-finite values")
    table = torch.rand(2 ** 28, device=dev)
    idx = torch.randint(0, 2 ** 28, (2 ** 24,), device=dev)
    gather = 2 ** 24 / (1e-3 * cuda_ms(lambda: torch.take(table, idx), 20))
    del table, idx
    x = torch.zeros((), device=dev)
    counted_loop(100, lambda c: c + 1, x)
    torch.cuda.synchronize()
    turns = 20000
    t0 = time.perf_counter()
    y = counted_loop(turns, lambda c: c + 1, x)
    torch.cuda.synchronize()
    scan = (time.perf_counter() - t0) / turns
    if float(y) != turns:
        fail(f"counted_loop gave {float(y)}, expected {turns}")
    got = {"TRANS_RATE": trans, "GATHER_RATE": gather,
           "SCAN_OVERHEAD": scan}
    for name, v in got.items():
        print(f"constant {name}: measured {v!r} (repro_torch.core.metrics: "
              f"{getattr(metrics, name)!r})")
    return got


TRACE_SCENARIOS = ("transformer-dp", "flash-ring", "ssm-decode", "moe-ep",
                   "encdec-pipeline")
#: full-width model costs the trace phase walks: batch 4 x 2048 tokens,
#: decode against a cache of 8192 (the reference cannot walk a full-width
#: train step, and the scenarios walk only DeepSeek's and Whisper's smoke
#: train steps, so those two are walked for prefill and decode; the VLM at
#: its 100 layers, which no card holds)
TRACE_COSTS = (("llama3.2-3b", ("prefill", "decode", "train")),
               ("mamba2-2.7b", ("prefill", "decode", "train")),
               ("deepseek-moe-16b", ("prefill", "decode")),
               ("whisper-large-v3", ("prefill", "decode")),
               ("llama-3.2-vision-90b", ("prefill", "decode")))
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


#: slice 15: the production cells the dry run's entry point walks in a
#: subprocess of its own (on meta tensors, with the card hidden from it)
DRYRUN_CELL = ("llama3.2-3b", "train_4k")
#: the one-device prediction of the train phase's Llama 3.2 3B step
#: (argument + temp bytes) against its measured warm-step peak
DRYRUN_PEAK_BAND = (0.8, 1.25)


def phase_dryrun(train: dict) -> dict:
    """Slice 15: the launch tier.  The dry run's entry point
    (``python -m repro_torch.launch.dryrun``) walks DRYRUN_CELL on the
    production mesh of one pod and of two (a fake world of 256 and 512
    processes, meta tensors) in a subprocess that sees no card; both cells
    must end ``ok``.  Then the train phase's own configuration (Llama 3.2
    3B at full width, batch 4 x 2048, bf16, remat, AdamW) is dry-run on a
    one-device mesh in process: its argument + temp bytes must land in
    DRYRUN_PEAK_BAND of the train phase's measured warm-step peak, and its
    step-time bound is printed against the measured step.  Neither walk
    launches a kernel."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.configs.base import RunShape
    from repro_torch.launch import dryrun

    arch, shape = DRYRUN_CELL
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    if out_dir.exists():
        for f in out_dir.glob("*"):
            f.unlink()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    reset_counts()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--multi-pod", "both", "--out", str(out_dir)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    cells_s = time.perf_counter() - t0
    print(proc.stdout.strip())
    if proc.returncode != 0:
        fail(f"dryrun {arch} x {shape}: exit {proc.returncode}\n"
             f"{proc.stderr[-4000:]}")
    cells = {}
    for mesh in ("pod16x16", "pod2x16x16"):
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        if not path.exists():
            fail(f"dryrun: no record {path.name}")
        rec = json.loads(path.read_text())
        r = rec["roofline"]
        if not rec.get("ok") or not r["flops_per_chip"] > 0:
            fail(f"dryrun {path.name}: {rec}")
        row = {"t_compute_s": r["t_compute"], "t_memory_s": r["t_memory"],
               "t_collective_s": r["t_collective"],
               "bottleneck": r["bottleneck"],
               "roofline_fraction": rec["roofline_fraction"],
               "step_time_bound_s": rec["step_time_bound_s"],
               "per_device_gib": r["memory_per_device"] / 2 ** 30,
               "walk_s": rec["compile_sec"]}
        print(f"dryrun {arch} x {shape} x {mesh}: {json.dumps(row)}")
        cells[mesh] = row

    # the train phase's configuration on one device
    cfg = get("llama3.2-3b")
    seq, depth = TRAIN_CELLS["llama3.2-3b"]
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    measured = train["llama3.2-3b"]
    t0 = time.perf_counter()
    rec = dryrun.run_cell(cfg, RunShape("train_phase", seq, TRAIN_BATCH,
                                        "train"),
                          mesh_shape={"data": 1, "model": 1})
    walk_s = time.perf_counter() - t0
    launched = {k: v for k, v in read_counts().items() if v}
    if launched:
        fail(f"the dry-run walks launched kernels: {launched}")
    mem = rec["memory_analysis"]
    predicted = (mem["argument_bytes"] + mem["temp_bytes"]) / 2 ** 30
    peak = measured["peak_gib_warm_step"]
    ratio = predicted / peak
    bound_s = rec["step_time_bound_s"]
    step_s = measured["step_ms"] / 1e3
    one = {"argument_gib": mem["argument_bytes"] / 2 ** 30,
           "temp_gib": mem["temp_bytes"] / 2 ** 30,
           "predicted_gib": predicted, "measured_peak_gib": peak,
           "predicted_over_measured": ratio, "band": DRYRUN_PEAK_BAND,
           "step_time_bound_s": bound_s, "measured_step_s": step_s,
           "bound_over_step": bound_s / step_s,
           "bottleneck": rec["roofline"]["bottleneck"], "walk_s": walk_s}
    print(f"dryrun one device, Llama 3.2 3B train {TRAIN_BATCH} x {seq} "
          f"({CARD}): predicted {predicted:.2f} GiB (arguments "
          f"{one['argument_gib']:.2f} + temp {one['temp_gib']:.2f}) against "
          f"the measured warm-step peak {peak:.2f} GiB: {ratio:.3f}x; "
          f"step-time bound {bound_s:.4f} s against the measured step "
          f"{step_s:.4f} s ({bound_s / step_s:.3f})")
    lo, hi = DRYRUN_PEAK_BAND
    if not lo <= ratio <= hi:
        fail(f"dryrun: predicted {predicted:.2f} GiB is {ratio:.3f}x the "
             f"measured {peak:.2f} GiB, outside {DRYRUN_PEAK_BAND}")
    return {"cells": cells, "cells_s": cells_s, "one_device": one}


#: slice 10: the corpus tier at the paper's 64-rank scale (the zoo's five
#: scenarios at their default steps, and the 64-rank synthetic trace)
CORPUS_RANKS = 64
#: per-scenario delta_bar, the card's corpus fit against the CPU's where
#: a fitted count differs (the reference's own drift allowance,
#: tests/test_fidelity_regression.py:48); equal counts give equal
#: delta_bar, held to 1e-12
CORPUS_DRIFT_ATOL = 0.05
CORPUS_QUERIES = 20
#: predict_profile on the h100 against the walker's rank totals through
#: HloCost.from_metric_vector: the walker also charges the element ops and
#: bytes of a counted loop's bookkeeping, which the predictor leaves out by
#: design (scan steps are not hardware work); the reference's predictor
#: does the same, and on the same store its gap is the port's to the bit
#: (tests/test_torch_proxy_service.py, which pins flash-ring's at 8 ranks:
#: 2.08e-5 of a rank's bytes); 0 where no loop is counted.  chip_smoke
#: prints the corpus's largest as h100_walker_rel_gap.
CORPUS_WALKER_GAP = 1e-4


def store_state(cs) -> dict:
    """A CorpusStore's state: names, content hashes, cluster assignments,
    representatives, manifest fingerprint."""
    ids, reps = cs.cluster_assignments()
    return {"names": list(cs.names),
            "hashes": {n: cs.content_hash(n) for n in cs.names},
            "ids": {n: ids[n].tobytes() for n in cs.names},
            "reps": {int(k): v.tobytes() for k, v in reps.items()},
            "fingerprint": cs.manifest_fingerprint()}


def corpus_deltas(corp) -> dict:
    return {n: r.fidelity(sample_ranks=None).mean
            for n, r in corp.results.items()}


def corpus_launches(corp) -> tuple[dict, dict]:
    """mxu_iter / stream_iter launches of one run_all of every scenario's
    proxy, counted and as the fitted tables predict."""
    want = {"mxu_iter": 0, "stream_iter": 0}
    reset_counts()
    for res in corp.results.values():
        res.proxy.run_all()
        for k, v in predicted_launches(res).items():
            want[k] += v
    torch.cuda.synchronize()
    got = read_counts()
    return {k: got[k] for k in want}, want


def pgd_targets(corp):
    """The corpus's compute-terminal targets, one row each."""
    import numpy as np
    from repro_torch.core.events import is_comm
    return np.stack([corp.reps[ev.cluster_id] if ev.cluster_id >= 0
                     else ev.vector for ev in corp.table.events
                     if not is_comm(ev)])


def check_pgd(dev, targets) -> dict:
    """The corpus's one PGD dispatch on the card: its time, its kernel
    launches (torch.profiler), a target alone against the same target in a
    batch of 64, and the card's fits against the CPU's."""
    import numpy as np
    from repro_torch.core import blocks, proxy_search
    batch = np.concatenate([targets] * (64 // len(targets) + 1))[:64]
    gpu = proxy_search.fit_batch(batch, device=dev)
    cpu = proxy_search.fit_batch(batch, device="cpu")
    for i in range(len(targets)):
        one = proxy_search.fit_batch(batch[i:i + 1], device=dev)[0]
        if (list(one.x) != list(gpu[i].x) or one.unroll != gpu[i].unroll
                or list(gpu[i].x) != list(cpu[i].x)):
            fail(f"pgd target {i} {list(batch[i])}: alone {list(one.x)} "
                 f"u{one.unroll}, in 64 {list(gpu[i].x)} u{gpu[i].unroll}, "
                 f"cpu {list(cpu[i].x)} u{cpu[i].unroll}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        proxy_search.fit_batch(targets, device=dev)
        torch.cuda.synchronize()
    rows = kernel_times(prof)
    t0 = time.perf_counter()
    proxy_search.fit_batch(targets, device=dev)
    ms = 1e3 * (time.perf_counter() - t0)
    b = blocks.calibration_matrix()
    bss = np.stack([proxy_search.substituted_matrix(b, u)
                    for u in proxy_search._UNROLLS])
    t0 = time.perf_counter()
    proxy_search._pgd_grid(
        np.repeat(targets, len(bss), axis=0),
        np.tile(bss, (len(targets), 1, 1)), device=dev)
    grid_ms = 1e3 * (time.perf_counter() - t0)
    return {"targets": len(targets), "fit_batch_ms": ms,
            "pgd_grid_ms": grid_ms,
            "kernel_launches": sum(r[1] for r in rows),
            "device_ms": sum(r[0] for r in rows) / 1e3,
            "batch_invariant_and_cpu_equal": True}


def phase_corpus(dev) -> dict:
    """Slice 10: the corpus tier on the card.

    Ingests the five zoo scenarios at 64 ranks (``ingest_scenarios``) and
    the 64-rank synthetic trace into a CorpusStore; synthesizes the corpus
    in one batch (one PGD fit on the card for every compute terminal),
    replays every proxy (the proxy-block launches the tables predict) and
    reports; holds the card's fits to the CPU's; builds the store again
    with a forked pool of 4 (bit-identical to serial); synthesizes from
    the store (bit-identical to batch), unchanged (no solver call), and
    after a removal (bit-identical to batch over the survivors); serves
    queries from a ProxyService (batched equals sequential; a refreshed
    service equals a rebuilt one), predicts each proxy on the port's cards
    (on the H100 within CORPUS_WALKER_GAP of the walker's); and sweeps
    every fault point of the store (recovery and survivor parity)."""
    import dataclasses
    import shutil
    import numpy as np
    from repro_torch.configs.registry import ingest_scenarios
    from repro_torch.core import chaos
    from repro_torch.core.corpus_store import CorpusStore
    from repro_torch.core.portability import CHIPS, predict_all
    from repro_torch.core.synthesize import synthesize_corpus
    from repro_torch.core.trace_ir import TraceStore
    from repro_torch.launch.hlo_cost import HloCost
    from repro_torch.serve.proxy_service import ProxyService
    from repro_torch.workloads import synthetic_rank_traces

    work = ROOT / "build" / "chip_smoke_corpus"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}

    # the store, streamed in: five scenarios built and appended one at a
    # time, then the synthetic trace as a (name, TraceStore) pair
    t0 = time.perf_counter()
    cs = CorpusStore(work / "serial")
    ingest_scenarios(cs, n_ranks=CORPUS_RANKS)
    cs.add_scenario(f"halo-{CORPUS_RANKS}", TraceStore.from_rank_traces(
        synthetic_rank_traces(CORPUS_RANKS), {"x": CORPUS_RANKS}))
    out["build_and_ingest_ms"] = 1e3 * (time.perf_counter() - t0)
    names = cs.names
    stores = {n: cs.load_scenario(n) for n in names}
    items = sorted(stores.items())
    out["events"] = {n: stores[n].n_events for n in names}
    for workers, key in ((0, "ingest_serial_ms"), (4, "ingest_parallel_ms")):
        t0 = time.perf_counter()
        other = CorpusStore(work / f"workers{workers}")
        other.add_scenarios(items, n_workers=workers)
        out[key] = 1e3 * (time.perf_counter() - t0)
        if store_state(other) != store_state(cs):
            fail(f"corpus: ingest with {workers} workers differs from the "
                 "streamed store")
    print(f"corpus on {CARD}: {len(names)} scenarios, "
          f"{sum(out['events'].values())} events: {out['events']}; build and "
          f"ingest {out['build_and_ingest_ms']:.1f} ms, ingest again serial "
          f"{out['ingest_serial_ms']:.1f} ms, 4 workers "
          f"{out['ingest_parallel_ms']:.1f} ms")

    # 1. batch synthesis in manifest order, replay, report
    pairs = [(n, stores[n]) for n in names]
    t0 = time.perf_counter()
    corp = synthesize_corpus(pairs, device=dev, out_dir=work / "batch")
    out["batch_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    got, want = corpus_launches(corp)
    out["run_all_ms"] = 1e3 * (time.perf_counter() - t0)
    out["launches"], out["predicted_launches"] = got, want
    if got != want or not all(got.values()):
        fail(f"corpus: launches {got} != predicted {want}")
    launched = {k: v for k, v in read_counts().items()
                if k not in want and v}
    if launched:
        fail(f"corpus: a model kernel launched in replay: {launched}")
    t0 = time.perf_counter()
    rep = corp.report()
    out["report_ms"] = 1e3 * (time.perf_counter() - t0)
    deltas = {n: r["mean_delta"] for n, r in rep["scenarios"].items()}
    out["delta_bar"] = deltas
    out["stats"] = corp.stats
    if not rep["all_comm_lossless"]:
        fail("corpus: comm sequences not lossless")
    if corp.stats["n_solver_calls"] != 1:
        fail(f"corpus: {corp.stats['n_solver_calls']} solver calls")
    print(f"corpus batch on {CARD}: synthesize_corpus "
          f"{out['batch_ms']:.1f} ms, run_all of every proxy "
          f"{out['run_all_ms']:.1f} ms, report {out['report_ms']:.1f} ms, "
          f"launches {json.dumps(got)} as predicted")
    print(f"corpus batch stats: {json.dumps(corp.stats)}")
    print(f"corpus delta_bar: {json.dumps(deltas)}")

    # 2. the card's fits against the CPU's
    cpu = synthesize_corpus(pairs, device="cpu", out_dir=work / "cpu")
    diff = [g for g in corp.fits
            if list(corp.fits[g].x) != list(cpu.fits[g].x)
            or corp.fits[g].unroll != cpu.fits[g].unroll]
    for g in diff:
        print(f"corpus fit differs: terminal {g} target "
              f"{list(corp.fits[g].target)}: card {list(corp.fits[g].x)} "
              f"u{corp.fits[g].unroll}, cpu {list(cpu.fits[g].x)} "
              f"u{cpu.fits[g].unroll}")
    cpu_deltas = {n: r["mean_delta"] for n, r in
                  cpu.report()["scenarios"].items()}
    tol = CORPUS_DRIFT_ATOL if diff else TRACE_DELTA_ATOL
    for n in names:
        if abs(deltas[n] - cpu_deltas[n]) > tol:
            fail(f"corpus {n}: delta_bar {deltas[n]!r} on the card, "
                 f"{cpu_deltas[n]!r} on the CPU")
    out["fits_differing_from_cpu"] = len(diff)
    out["pgd"] = check_pgd(dev, pgd_targets(corp))
    print(f"corpus pgd on {CARD}: {json.dumps(out['pgd'])}")

    # 3. the store: incremental synthesis, unchanged, after a removal
    t0 = time.perf_counter()
    inc = synthesize_corpus(store=cs, device=dev, out_dir=work / "store")
    out["store_cold_ms"] = 1e3 * (time.perf_counter() - t0)
    if corpus_deltas(inc) != corpus_deltas(corp):
        fail("corpus: store synthesis delta_bar differs from batch")
    t0 = time.perf_counter()
    again = synthesize_corpus(store=cs, device=dev, out_dir=work / "store")
    out["store_unchanged_ms"] = 1e3 * (time.perf_counter() - t0)
    if again.stats["n_solver_calls"] != 0:
        fail(f"corpus: unchanged store re-solved: {again.stats}")
    cs.remove_scenario("transformer-dp")
    t0 = time.perf_counter()
    after = synthesize_corpus(store=cs, device=dev, out_dir=work / "store")
    out["store_after_removal_ms"] = 1e3 * (time.perf_counter() - t0)
    out["n_refit_terminals_after_removal"] = after.stats["n_refit_terminals"]
    scratch = synthesize_corpus([(n, stores[n]) for n in cs.names],
                                device=dev, out_dir=work / "survivors")
    if corpus_deltas(after) != corpus_deltas(scratch):
        fail("corpus: delta_bar after the removal differs from a "
             "from-scratch synthesis of the survivors")
    cs.add_scenario("transformer-dp-replay", stores["transformer-dp"])
    print(f"corpus store on {CARD}: cold {out['store_cold_ms']:.1f} ms, "
          f"unchanged {out['store_unchanged_ms']:.1f} ms, after removing "
          f"transformer-dp {out['store_after_removal_ms']:.1f} ms "
          f"({out['n_refit_terminals_after_removal']} terminals refit)")

    # 4. the service
    t0 = time.perf_counter()
    svc = ProxyService(cs, device=dev, out_dir=work / "serve")
    out["service_build_ms"] = 1e3 * (time.perf_counter() - t0)
    pool = [stores[n] for n in names]
    pool += [dataclasses.replace(stores[n], metrics=stores[n].metrics * 1.7
                                 + 13.0) for n in names]
    pool += [TraceStore.from_rank_traces(synthetic_rank_traces(r), {"x": r})
             for r in (8, 16, 32)]
    pool += [dataclasses.replace(stores[n], metrics=stores[n].metrics * 0.5)
             for n in names]
    queries = (pool * (CORPUS_QUERIES // len(pool) + 1))[:CORPUS_QUERIES]
    times = []
    for q in queries:
        t0 = time.perf_counter()
        svc.query(q)
        times.append(1e3 * (time.perf_counter() - t0))
    out["query_mean_ms"] = float(np.mean(times))
    out["query_p50_ms"] = float(np.median(times))
    many = (pool * (60 // len(pool) + 1))[:60]
    seq = [svc.query(q) for q in many]
    t0 = time.perf_counter()
    bat = svc.query_batch(many)
    out["batched_queries_per_s"] = len(many) / (time.perf_counter() - t0)
    for s, b in zip(seq, bat):
        if (s.name, s.distance, s.distances) != (b.name, b.distance,
                                                 b.distances):
            fail(f"corpus service: batched {b.name} {b.distance!r} != "
                 f"sequential {s.name} {s.distance!r}")
    for n in cs.names:
        ans = svc.query(cs.load_scenario(n))
        if ans.distances.get(n, ans.distance) != ans.distance:
            fail(f"corpus service: {n}'s own trace is not its nearest "
                 f"({ans.name} at {ans.distance!r})")
    half = CORPUS_RANKS // 2
    cs.add_scenario(f"halo-{half}", TraceStore.from_rank_traces(
        synthetic_rank_traces(half), {"x": half}))
    t0 = time.perf_counter()
    svc.refresh()
    out["refresh_ms"] = 1e3 * (time.perf_counter() - t0)
    rebuilt = ProxyService(CorpusStore(cs.root), device=dev,
                           out_dir=work / "serve")
    if svc._names != rebuilt._names or any(
            not np.array_equal(svc.embedding(n), rebuilt.embedding(n))
            for n in svc._names):
        fail("corpus service: the refreshed service differs from a "
             "rebuilt one")
    for q in many[:10]:
        a, b = svc.query(q), rebuilt.query(q)
        if (a.name, a.distance) != (b.name, b.distance):
            fail("corpus service: refreshed and rebuilt answer differently")
    if svc.stats["n_warm_synthesis"] != 1:
        fail(f"corpus service: {svc.stats['n_warm_synthesis']} warm syntheses")
    h100 = CHIPS["h100"]
    worst = 0.0
    profiles = {}
    for n, res in svc.corpus.results.items():
        preds = predict_all(res.proxy.module)
        profiles[n] = {c: p.step_time for c, p in preds.items()}
        for r in range(res.proxy.module.N_RANKS):
            hc = HloCost.from_metric_vector(res.proxy.rank_metrics(r))
            for want, got in ((hc.flops / h100.peak_flops,
                               preds["h100"].t_compute[r]),
                              (hc.bytes / h100.hbm_bw,
                               preds["h100"].t_memory[r])):
                if want > 0:
                    worst = max(worst, abs(got - want) / want)
    out["predicted_step_s"] = profiles
    out["h100_walker_rel_gap"] = worst
    if worst > CORPUS_WALKER_GAP:
        fail(f"corpus: h100 prediction off the walker by {worst!r}")
    svc.close(), rebuilt.close()
    print(f"corpus service on {CARD}: query mean "
          f"{out['query_mean_ms']:.3f} ms, p50 {out['query_p50_ms']:.3f} ms, "
          f"{out['batched_queries_per_s']:.1f} batched queries/s, refresh "
          f"{out['refresh_ms']:.1f} ms")

    # 5. the chaos sweep over the store's fault points
    t0 = time.perf_counter()
    zoo = {"a": stores["ssm-decode"], "b": stores["moe-ep"],
           "c": stores["encdec-pipeline"]}
    rows = chaos.smoke(zoo, n_workers=4, base=work / "chaos")
    out["chaos_s"] = time.perf_counter() - t0
    out["chaos_points"] = len(rows) - 3
    print(f"corpus chaos on {CARD}: {len(rows) - 3} fault points "
          f"recovered to survivor parity in {out['chaos_s']:.2f} s")
    shutil.rmtree(work, ignore_errors=True)
    return out


def flash_inputs(gen, b, s, h, g, d, dtype, dev, t=None):
    """q (b, s, h, d) and k, v (b, t, g, d) (t = s unless given), N(0, 1)."""
    t = s if t is None else t
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, g, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, g, d), generator=gen, device=dev).to(dtype)
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
#: slice 9's flash shapes (bf16): Llama 3.2 Vision 90B's prefill
#: self-attention (GQA 64/8, causal) and its cross-attention of the 2048
#: queries to the 1601 vision states (unmasked, s != t); (b, s, t, h, g, d,
#: causal) by name; the self shape's launches are the serve cell's causal
#: calls, the cross shape's its unmasked ones
VLM = "llama-3.2-vision-90b"
VLM_FLASH_SHAPES = {VLM: (4, 2048, 2048, 64, 8, 128, True),
                    f"{VLM} cross": (4, 2048, 1601, 64, 8, 128, False)}


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
    # slice 9's shapes, from a generator of their own (the sweep's inputs
    # above stay as they were)
    vgen = torch.Generator(device=dev).manual_seed(9)
    for cell, (b, s, t, h, g, d, causal) in VLM_FLASH_SHAPES.items():
        q, k, v = flash_inputs(vgen, b, s, h, g, d, torch.bfloat16, dev, t)
        got = fops.flash_attention_fwd(q, k, v, causal=causal)
        want = fref.attention_ref(q, k, v, causal=causal)
        errs[f"flash_fwd {cell}"] = check_close(
            "flash_fwd", got, want, f"{cell}: b={b} s={s} t={t} h={h} g={g} "
            f"d={d} causal={causal} bfloat16")
        del q, k, v, got, want
        torch.cuda.empty_cache()
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
    (b, n_audio_frames, d), for the VLM random N(0, 1) vision embeddings
    (b, n_vision_tokens, d), in the config's dtype, from ``seed``: the
    checks that call the prefill directly feed the encoder and the
    cross-attention something that is not zero (the serve engine feeds the
    reference's zeros, which make every cross-attention output 0)."""
    out = {"tokens": tokens}
    for key, n in (("audio_frames", cfg.n_audio_frames),
                   ("vision_embeds", cfg.n_vision_tokens)):
        if n:
            gen = torch.Generator(device=dev).manual_seed(100 + seed)
            out[key] = torch.randn((tokens.shape[0], n, cfg.d_model),
                                   generator=gen, device=dev).to(
                getattr(torch, cfg.dtype))
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


@contextlib.contextmanager
def flash_calls(records: list):
    """Record the ``causal`` flag of each flash-attention call of the
    models (self-attention: True; cross-attention: False)."""
    from repro_torch.models import attention as A

    flash = A.flash_attention

    def spy(*args, **kwargs):
        records.append(bool(kwargs.get("causal", True)))
        return flash(*args, **kwargs)

    A.flash_attention = spy
    try:
        yield
    finally:
        A.flash_attention = flash


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
    if arch in SERVE_DEPTH:
        print(f"serve {arch}: cut to {SERVE_DEPTH[arch]} of {cfg.n_layers} "
              "layers at the published widths")
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
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
    causal: list = []
    with flash_calls(causal):
        res = engine.generate(prompts, SERVE_NEW)
    launches = read_counts()
    print(f"serve {arch} launches: {json.dumps(launches)}")
    # one a layer of the prefill (the encoder's for Whisper); the VLM's
    # cross-attention layers launch once more, unmasked
    n_cross = cfg.layer_kinds().count("x")
    want = (cfg.enc_layers or cfg.n_layers) + n_cross
    if launches[kernel] != want:
        fail(f"{arch}: {kernel} launched {launches[kernel]} times per "
             f"generate, expected {want} (one per layer)")
    calls = {"self": causal.count(True), "cross": causal.count(False)}
    if cfg.n_vision_tokens:
        print(f"serve {arch} flash_fwd a generate: {json.dumps(calls)}")
        if calls != {"self": cfg.n_layers, "cross": n_cross}:
            fail(f"{arch}: flash_fwd calls {calls}, expected "
                 f"{cfg.n_layers} self and {n_cross} cross")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    if others:
        fail(f"{arch}: unexpected launches {others}")
    if res.tokens.shape != (SERVE_BATCH, SERVE_NEW) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all():
        fail(f"{arch}: tokens {res.tokens.shape} out of range")
    warm = engine.generate(prompts, SERVE_NEW)      # the same run, warm
    if not (warm.tokens == res.tokens).all():
        fail(f"{arch}: a second generate gave other tokens")
    row = {"launches": launches[kernel], "flash_calls": calls,
           "layers": cfg.n_layers,
           "parameters": n_params,
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
        prof: dict = {}
        profile_call(lambda: engine._prefill(params, batch, cfg),
                     f"{arch} prefill", prof)
        row["prefill_busy_share"] = prof.get("busy_share")
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
    if arch in F32_CUT:
        ccfg, params = cut_depth(ccfg, params, F32_CUT[arch])
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
        return {"ssd_diag": 2 * cfg.n_layers, "ssd_diag_bwd": cfg.n_layers}
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


def check_train_kernels(dev) -> tuple[dict, dict]:
    """flash_bwd, the LSE output and the SSD gradient at the training
    path's shapes, against their plain versions.  Returns flash_bwd's
    max|kernel - plain| at the main shape and at Whisper's (by name), and
    the SSD backward's ms a Mamba2 layer, the kernel's and the plain
    version's."""
    from repro_torch.kernels import tolerance
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

    def grads(fn):
        leaves = [x.detach().requires_grad_(True) for x in ins]
        return torch.autograd.grad(fn(*leaves, r, torch.float32), leaves, gy)

    got, want = grads(sops.ssd_diag), grads(sref.ssd_diag_ref)
    ssd_err = max(
        check_close("ssd_diag_bwd", a, w, f"gradient of {name} at the Mamba2 "
                    "2.7B shape (b 4, c 8, q 256, h 80, p 64, n 128, bf16)")
        for name, a, w in zip(("x", "dt", "cum", "B", "C"), got, want))
    ssd_excess = max(tolerance.kernel_excess("ssd_diag_bwd", a, w)
                     for a, w in zip(got, want))
    again = sops.ssd_diag_bwd(*ins, r, gy)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("ssd_diag_bwd: two calls differ (not deterministic)")
    print("kernel ssd_diag_bwd: every gradient within its limit of plain "
          "autograd through ssd_diag_ref; two calls bit-identical")
    del got, want, again

    def plain_backward():
        """What the SSD Function's backward ran before its kernel: the
        plain version recomputed under autograd and differentiated."""
        return grads(sref.ssd_diag_ref)

    turns = [cuda_ms(lambda: sops.ssd_diag_bwd(*ins, r, gy), 10),
             cuda_ms(plain_backward, 5),
             cuda_ms(lambda: sops.ssd_diag_bwd(*ins, r, gy), 10)]
    # the plain algorithm's transposed products, twice the forward's, over
    # the causal pairs of each chunk; the bytes: the inputs and dY read,
    # the five gradients (the inputs' dtypes) written
    b, c, q, g, p, n = (sm[k] for k in ("b", "c", "q", "g", "p", "n"))
    flops = 4.0 * b * c * q * (q + 1) / 2 * (g * n + g * r * p)
    nbytes = (2 * sum(t.numel() * t.element_size() for t in ins)
              + gy.numel() * gy.element_size())
    bnd, bby = bound(nbytes, flops, PEAK_BF16_FLOPS)
    ssd_ms = {"kernel": min(turns[0], turns[2]), "plain": turns[1],
              "max_abs_err": ssd_err, "worst_excess": ssd_excess,
              "bound_ms": bnd, "bound_by": bby}
    print(f"timing ssd_diag's backward at the Mamba2 2.7B shape in turns: "
          f"kernel {turns[0]:.4f} ms, plain {turns[1]:.3f} ms, kernel "
          f"{turns[2]:.4f} ms a layer; bound {bnd:.4f} ms ({bby}; "
          f"{flops:.3g} FLOP, {nbytes / 1e6:.1f} MB), "
          f"{100 * bnd / ssd_ms['kernel']:.1f}% of it")
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
        if seq >= 1024 and kinds & {"g", "l", "s", "x"}:
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
    prefill and Whisper's encoder, flash_bwd at Whisper's encoder; and
    slice 9's (VLM_FLASH_SHAPES): flash_fwd at the VLM's self- and
    cross-attention; each timed in turns with PyTorch's SDPA (its backward
    alone for flash_bwd) on the same tensors, beside its plain version, its
    bound and its launches a path run (a generate; a train step)."""
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
    for cell, (b, s, t, h, g, d, causal) in VLM_FLASH_SHAPES.items():
        q, k, v = flash_inputs(gen, b, s, h, g, d, torch.bfloat16, dev, t)
        pairs = s * (s + 1) / 2 if causal else s * t
        flops = 4 * b * h * d * pairs
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kern = lambda: fops.flash_attention_fwd(q, k, v, causal=causal)  # noqa
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        with torch.no_grad():
            turns = [cuda_ms(kern, 20), cuda_ms(lib, 20), cuda_ms(kern, 20)]
        bnd, bby = bound(2 * (2 * b * s * h * d + 2 * b * t * g * d), flops,
                         PEAK_BF16_FLOPS)
        calls = serve[VLM]["flash_calls"]
        rows.append({"name": "flash_fwd", "cell": cell,
                     "shape": dict(b=b, s=s, t=t, h=h, g=g, d=d,
                                   causal=causal),
                     "launches": {"generate": calls["self" if causal
                                                    else "cross"],
                                  "serve_layers": serve[VLM]["layers"]},
                     "max_abs_err": errs[f"flash_fwd {cell}"],
                     "ms": (turns[0] + turns[2]) / 2,
                     "plain_ms": cuda_ms(lambda: fref.attention_ref(
                         q, k, v, causal=causal), 3),
                     "bound_ms": bnd, "bound_by": bby, "library_ms": turns[1],
                     "flops": flops})
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
    rows["mamba2-2.7b"]["ssd_backward_ms_a_layer"] = ssd_ms["kernel"]
    rows["mamba2-2.7b"]["ssd_plain_backward_ms_a_layer"] = ssd_ms["plain"]
    rows["mamba2-2.7b"]["ssd_backward_check"] = ssd_ms
    rows["llama3.2-3b"]["flash_bwd_device_us"] = kernel_us
    train_smoke_configs(dev)
    for arch in ("llama3.2-3b", "deepseek-moe-16b", "whisper-large-v3"):
        train_crash_resume(dev, arch)
    return rows, timing


#: slice 12's smoke cells: the Llama smoke at 2 × 1024 tokens (attention
#: through flash on the card), card against the CPU under a one-process
#: group of each backend
DP_SMOKE_ARCH, DP_SMOKE_BATCH, DP_SMOKE_SEQ = "llama3.2-3b", 2, 1024
#: steps of the full-width mesh trainer against the single-device one
DP_BIT_STEPS = 2
#: steps of the full-width int8 DP step, on one fixed batch (warmup 1)
DP_INT8_STEPS = 3
#: the DP train level, card against CPU (tests/test_torch_dp_train.py's
#: limits against the JAX reference): the loss within 1e-5 relative, each
#: parameter leaf within 1e-4 of its largest value
DP_PARAM_RTOL = 1e-4
#: the norm of an int8 step's reduced gradient, relative, card against CPU
DP_GRAD_NORM_RTOL = 1e-4


def _dp_smoke(dev, base: Path) -> dict:
    """The smoke cells on ``dev`` under the current one-process group: two
    int8 DP steps (their losses, weights, error states, the norms of their
    reduced gradients and each leaf's quantum at the last step) and a mesh
    trainer's 4 steps (with a crash/resume that must equal them bit for
    bit), all from the same CPU-drawn weights."""
    import repro_torch.train.loop as loop_mod
    from repro_torch.configs import get, smoke
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import init_params
    from repro_torch.train.compression import init_error_state
    from repro_torch.train.data import TokenDataset
    from repro_torch.train.loop import (
        Trainer, _InjectedFailure, make_manual_dp_train_step,
    )
    from repro_torch.train.optimizer import adamw_init

    cfg = smoke(get(DP_SMOKE_ARCH))
    init = init_params(cfg, 0, "cpu")
    out = {}
    params = tree_map(lambda t: t.to(dev, copy=True), init)
    opt, err = adamw_init(params), init_error_state(params)
    step = make_manual_dp_train_step(cfg, make_dp_mesh(1))
    ds = TokenDataset(cfg.vocab, DP_SMOKE_SEQ, DP_SMOKE_BATCH, seed=3)
    real = loop_mod.compressed_psum
    quanta = []

    def quantum(x, group, e):          # the leaf's scale, before the update
        quanta.append(float((e + x.float()).abs().max()) / 127.0)
        return real(x, group, e)

    reset_counts()
    losses, norms = [], []
    loop_mod.compressed_psum = quantum
    try:
        for i in range(2):
            quanta.clear()
            params, opt, err, m = step(params, opt, err, ds.batch_at(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        loop_mod.compressed_psum = real
    out["manual_launches"] = read_counts()
    out["manual"] = (losses, [t.cpu() for t in tree_leaves(params)],
                     [t.cpu() for t in tree_leaves(err)], norms, quanta)
    logs, final = {}, {}
    reset_counts()
    for name in ("plain", "crash"):
        t = Trainer(cfg, make_dp_mesh(1), global_batch=DP_SMOKE_BATCH,
                    seq_len=DP_SMOKE_SEQ, ckpt_dir=base / name)
        t.params = tree_map(lambda x: x.to(t.device, copy=True), init)
        t.opt_state = adamw_init(t.params)
        crashed = []

        def inject(s):
            if name == "crash" and s == 3 and not crashed:
                crashed.append(s)
                raise _InjectedFailure("simulated node loss")

        log = t.run(4, ckpt_every=2, failure_injector=inject)
        logs[name] = {m["step"]: m["loss"] for m in log}
        final[name] = [x.cpu() for x in tree_leaves(t.params)] + \
            [x.cpu() for x in tree_leaves(t.opt_state)]
        if name == "crash" and not crashed:
            fail("dp_train smoke: the failure was not injected")
    out["trainer_launches"] = read_counts()
    out["trainer"] = ([logs["plain"][s] for s in range(4)],
                      final["plain"][:len(tree_leaves(init))])
    out["crash_same"] = (logs["plain"] == logs["crash"] and all(
        torch.equal(a, b) for a, b in zip(final["plain"], final["crash"])))
    return out


def _dp_close(what: str, got: tuple, want: tuple) -> float:
    """Losses and parameter leaves at the DP train level."""
    worst = 0.0
    for a, b in zip(got[0], want[0]):
        if not abs(a - b) <= TRAIN_LOSS_RTOL * abs(b):
            fail(f"dp_train smoke {what}: losses {got[0]} against the "
                 f"CPU's {want[0]}")
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        top = float(b.abs().max())
        err = float((a.float() - b.float()).abs().max())
        if not err <= DP_PARAM_RTOL * top:
            fail(f"dp_train smoke {what}: leaf {i} differs by {err} "
                 f"(largest {top})")
        worst = max(worst, err / top if top else 0.0)
    return worst


def _dp_wrappers(dev) -> list[str]:
    """Each instrumented wrapper kind on a CUDA tensor over a group of one,
    against its plain semantics there; a CPU tensor under NCCL raises."""
    from repro_torch.launch.mesh import make_replay_mesh
    from repro_torch.sharding import collectives as C

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((4, 6, 8), generator=g, device=dev)
    s = x[:1]                                     # a dim of the group's size
    with C.bind_mesh(make_replay_mesh({"x": 1})):
        cases = {
            "psum": (C.psum(x, "x"), x),
            "pmax": (C.pmax(x, "x"), x),
            "all_gather": (C.all_gather(x, "x", gather_dim=1), x[:, None]),
            "all_gather tiled": (C.all_gather(x, "x", gather_dim=2,
                                              tiled=True), x),
            "psum_scatter": (C.psum_scatter(x, "x", scatter_dim=1), x),
            "psum_scatter untiled": (C.psum_scatter(s, "x", tiled=False),
                                     s[0]),
            "all_to_all": (C.all_to_all(x, "x", 0, 2), x),
            "all_to_all untiled": (C.all_to_all(s, "x", 0, 2, tiled=False),
                                   s.movedim(0, 2)),
            "ppermute": (C.ppermute(x, "x", [(0, 0)]), x),
            "ppermute empty": (C.ppermute(x, "x", []), torch.zeros_like(x)),
        }
        for name, (got, want) in cases.items():
            if not (got.device == x.device and got.shape == want.shape
                    and torch.equal(got, want)):
                fail(f"dp_train: the {name} wrapper on a CUDA tensor differs "
                     "from its plain semantics over one rank")
        other = torch.ones(3, device="cpu" if x.is_cuda else "meta")
        if x.is_cuda:
            try:
                C.psum(other, "x")
            except RuntimeError as e:
                if "stages nothing" not in str(e):
                    raise
            else:
                fail("dp_train: a CPU tensor under NCCL did not raise")
    return sorted(cases)


def phase_dp_train(dev) -> dict:
    """Slice 12: data-parallel training on a one-process NCCL group (started
    in process on a HashStore, as phase_mesh's): (a) at full width, Llama
    3.2 3B at 4 × 2048 in bf16, Trainer(mesh=make_dp_mesh(1)) for 2 steps
    equal to Trainer(None) bit for bit in every parameter leaf, 56
    flash_fwd and 28 flash_bwd a step each; (b) at full width,
    make_manual_dp_train_step for 3 steps on one batch: finite, falling
    loss, the same launches a step, one int32 all-reduce a parameter leaf;
    its step ms and peak GiB, and quantize + all-reduce + dequantize of
    every leaf timed apart (and the all-reduces alone); (c) the smoke Llama
    at 2 × 1024: the card's int8 DP steps and mesh trainer against the same
    code on the CPU under a one-process gloo group, at the DP train level,
    the int8 steps' error states within one quantum a leaf and the norms
    of their reduced gradients within 1e-4 relative, and the card's mesh
    crash/resume bit-identical; (d) each instrumented
    wrapper kind on a CUDA tensor.  Destroys its groups at the end."""
    import shutil
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.compression import compressed_psum, init_error_state
    from repro_torch.train.data import TokenDataset
    from repro_torch.train.loop import Trainer, make_manual_dp_train_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    base = ROOT / "build" / "chip_smoke" / "dp_train"
    shutil.rmtree(base, ignore_errors=True)
    row = {"card": CARD}
    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cpu = _dp_smoke("cpu", base / "cpu")
    finally:
        dist.destroy_process_group()
    row["smoke_cpu_s"] = time.perf_counter() - t0
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        # (a) the mesh trainer against the single-device one, full width
        cfg = get("llama3.2-3b")
        want = train_launches(cfg)
        kw = dict(global_batch=TRAIN_BATCH, seq_len=2048, seed=0)
        torch.cuda.empty_cache()
        reset_counts()
        t = Trainer(cfg, make_dp_mesh(1), ckpt_dir=base / "mesh", **kw)
        mesh_log = t.run(DP_BIT_STEPS)
        launches_mesh = read_counts()
        mesh_params = t.params
        del t
        torch.cuda.empty_cache()
        reset_counts()
        t = Trainer(cfg, None, ckpt_dir=base / "single", device=dev, **kw)
        single_log = t.run(DP_BIT_STEPS)
        launches_single = read_counts()
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(mesh_params), tree_leaves(t.params)))
        losses = ([m["loss"] for m in mesh_log],
                  [m["loss"] for m in single_log])
        print(f"dp_train: Trainer(mesh=make_dp_mesh(1)) against Trainer(None)"
              f", Llama 3.2 3B 4 x 2048, {DP_BIT_STEPS} steps: losses "
              f"{losses[0]} and {losses[1]}; every parameter leaf equal: "
              f"{same}; step ms {[1e3 * m['sec'] for m in mesh_log]} and "
              f"{[1e3 * m['sec'] for m in single_log]}; launches "
              f"{json.dumps(launches_mesh)} and {json.dumps(launches_single)}")
        if not same or losses[0] != losses[1]:
            fail("dp_train: the one-process mesh trainer is not bit-equal to "
                 "the single-device trainer")
        for k, n in want.items():
            for which, got in (("mesh", launches_mesh),
                               ("single", launches_single)):
                if got[k] != n * DP_BIT_STEPS:
                    fail(f"dp_train {which} trainer launched {k} {got[k]} "
                         f"times in {DP_BIT_STEPS} steps, not {n} a step")
        row["bit_equal"] = same
        row["trainer_losses"] = losses[0]
        row["trainer_step_ms"] = [1e3 * m["sec"] for m in mesh_log]
        row["single_step_ms"] = [1e3 * m["sec"] for m in single_log]
        row["trainer_launches"] = launches_mesh

        # (b) the int8 error-feedback DP step, full width, one fixed batch
        params = t.params
        del t, mesh_params
        torch.cuda.empty_cache()
        opt, err = adamw_init(params), init_error_state(params)
        step = make_manual_dp_train_step(cfg, make_dp_mesh(1),
                                         AdamWConfig(warmup_steps=1))
        batch = TokenDataset(cfg.vocab, 2048, TRAIN_BATCH, seed=1).batch_at(0)
        real = dist.all_reduce
        reduced = []

        def counting(tensor, *a, **k):
            reduced.append(str(tensor.dtype).replace("torch.", ""))
            return real(tensor, *a, **k)

        n_leaves = len(tree_leaves(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        int8 = {"losses": [], "step_ms": [], "launches": [],
                "int32_all_reduces": []}
        dist.all_reduce = counting
        try:
            for _ in range(DP_INT8_STEPS):
                reset_counts()
                reduced.clear()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                params, opt, err, m = step(params, opt, err, batch)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                int8["step_ms"].append(1e3 * (time.perf_counter() - t1))
                int8["losses"].append(loss)
                int8["launches"].append(read_counts())
                int8["int32_all_reduces"].append(reduced.count("int32"))
        finally:
            dist.all_reduce = real
        int8["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        int8["leaves"] = n_leaves
        print(f"dp_train int8 step, Llama 3.2 3B 4 x 2048, one batch: "
              f"losses {int8['losses']}; step ms {int8['step_ms']}; peak "
              f"{int8['peak_gib']:.2f} GiB; int32 all-reduces a step "
              f"{int8['int32_all_reduces']} ({n_leaves} leaves); launches "
              f"{json.dumps(int8['launches'])}")
        ls = int8["losses"]
        if not (all(map(math.isfinite, ls))
                and all(b < a for a, b in zip(ls, ls[1:]))):
            fail(f"dp_train int8: losses {ls} not finite and falling")
        for c in int8["launches"]:
            if any(c[k] != n for k, n in want.items()):
                fail(f"dp_train int8: launches {c}, not {want} a step")
        if any(n != n_leaves for n in int8["int32_all_reduces"]):
            fail(f"dp_train int8: {int8['int32_all_reduces']} int32 "
                 f"all-reduces a step, not one a leaf ({n_leaves})")
        # the compression alone: every leaf (the weights as stand-in
        # gradients, bf16 as the step's are), then the all-reduces alone
        leaves, errs = tree_leaves(params), tree_leaves(err)
        times, ar = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for g, e in zip(leaves, errs):
                compressed_psum(g, None, e)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t1))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for g in leaves:
                buf = torch.empty(g.shape, dtype=torch.int32, device=dev)
                dist.all_reduce(buf)
                del buf
            torch.cuda.synchronize()
            ar.append(1e3 * (time.perf_counter() - t1))
        int8["compression_ms"] = times
        int8["all_reduce_alone_ms"] = ar
        print(f"dp_train int8: quantize + int32 all-reduce + dequantize of "
              f"every leaf {[round(x, 2) for x in times]} ms (the "
              f"all-reduces with an allocation each, alone: "
              f"{[round(x, 2) for x in ar]} ms) ({CARD})")
        row["int8"] = int8
        del params, opt, err, leaves, errs
        torch.cuda.empty_cache()

        # (c) the smoke cells, card against the CPU
        gpu = _dp_smoke(dev, base / "cuda")
        w_manual = _dp_close("manual int8 step", gpu["manual"][:2],
                             cpu["manual"][:2])
        # the error state within one quantum a leaf (the CPU's scale at the
        # last step: a rounding may move by one step), and the norm of the
        # reduced gradient, which the weights at warmup lr cannot show
        diffs = [float((a - b).abs().max()) for a, b in
                 zip(gpu["manual"][2], cpu["manual"][2])]
        quanta = cpu["manual"][4]
        if len(quanta) != len(diffs):
            fail(f"dp_train smoke: {len(quanta)} quanta for {len(diffs)} "
                 "error leaves")
        for i, (d, q) in enumerate(zip(diffs, quanta)):
            if not d <= q * (1 + 1e-3):
                fail(f"dp_train smoke: error leaf {i} differs by {d}, more "
                     f"than one quantum ({q})")
        err_diff = max(d / q if q else 0.0 for d, q in zip(diffs, quanta))
        for a, b in zip(gpu["manual"][3], cpu["manual"][3]):
            if not abs(a - b) <= DP_GRAD_NORM_RTOL * b:
                fail(f"dp_train smoke: reduced-gradient norms "
                     f"{gpu['manual'][3]} against the CPU's "
                     f"{cpu['manual'][3]}")
        w_trainer = _dp_close("mesh trainer", gpu["trainer"], cpu["trainer"])
        if not gpu["crash_same"]:
            fail("dp_train smoke: the card's mesh crash/resume does not "
                 "reproduce the uninterrupted run bit for bit")
        for k in ("manual_launches", "trainer_launches"):
            if gpu[k]["flash_fwd"] <= 0 or gpu[k]["flash_bwd"] <= 0:
                fail(f"dp_train smoke: {k} {gpu[k]} went around flash")
        print(f"dp_train smoke ({DP_SMOKE_ARCH} smoke, {DP_SMOKE_BATCH} x "
              f"{DP_SMOKE_SEQ}) card against CPU: int8 losses "
              f"{gpu['manual'][0]} and {cpu['manual'][0]}, worst leaf "
              f"{w_manual:.3g} of its largest, error states within "
              f"{err_diff:.3g} quanta, reduced-gradient norms "
              f"{gpu['manual'][3]} and {cpu['manual'][3]}; mesh trainer "
              f"losses {gpu['trainer'][0]} and "
              f"{cpu['trainer'][0]}, worst leaf {w_trainer:.3g}; crash/resume "
              f"bit-identical; launches {json.dumps(gpu['manual_launches'])}"
              f", {json.dumps(gpu['trainer_launches'])}")
        row["smoke"] = {"manual_worst_leaf": w_manual,
                        "err_max_diff_quanta": err_diff,
                        "grad_norms": [gpu["manual"][3], cpu["manual"][3]],
                        "trainer_worst_leaf": w_trainer,
                        "crash_resume_bit_identical": True}

        # (d) the instrumented wrappers on CUDA tensors
        row["wrappers"] = _dp_wrappers(dev)
        print(f"dp_train: wrappers on CUDA tensors over one rank equal their "
              f"plain semantics: {row['wrappers']}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(base, ignore_errors=True)
    return row


#: slice 13: tensor parallel on two processes of the one card (a data 1 x
#: model 2 mesh over gloo carrying CUDA tensors: NCCL refuses two ranks on
#: one device).  Every collective goes through the host, so the phase's wall
#: times are gloo's, not a tensor-parallel speed.
TP_MODEL = 2
TP_SMOKE = ("llama3.2-3b", "gemma3-4b", "mamba2-2.7b")
TP_SMOKE_BATCH, TP_SMOKE_NEW = 2, 8
#: f32 smoke configs, the mesh against one device on the card: prefill
#: logits within 1e-4 of the largest (tests/test_torch_tp.py's level
#: against the reference); the train level for one step's gradients
TP_LOGIT_RTOL = 1e-4
#: full width, bf16: prefill logits against one device's within 2^-4 of
#: the largest (the serve level of bf16 logits) for Llama; Mamba2's 64
#: random layers amplify bf16 rounding in another order to O(1), as its
#: prefill against its decode (CONSISTENCY_BF16_RTOL), so its whole model
#: is held to the reference's drift, and one of its layers alone, fed the
#: same input on the mesh and on one device, to 2^-4 (SSM_LAYER_BF16_RTOL);
#: a train step's loss within 2^-7 relative (the bf16 sums of the
#: row-parallel products in another order).  With random weights the loss
#: sits near ln(vocab) whatever the forward computes, so the step's
#: reduced-gradient norm is held too, within 1e-3 relative of one device's
#: (the card measured 1.9e-5 apart); a row-parallel sum dropped or doubled
#: moves the gradients of every layer below it
TP_BF16_LOGIT_RTOL = {"llama3.2-3b": 2.0 ** -4,
                      "mamba2-2.7b": CONSISTENCY_BF16_RTOL["mamba2-2.7b"]}
TP_BF16_LOSS_RTOL = 2.0 ** -7
TP_BF16_GRAD_NORM_RTOL = 1e-3
#: full width in f32, cut in depth, the mesh against one device: (layers
#: kept, prefill length, decode steps after it), the prefill's and every
#: step's logits within TP_LOGIT_RTOL of the largest.  Mamba2's bf16 logits
#: are held only to its drift (above), so every layer's prefill and the
#: sharded decode at 40 heads a process (its re-dealt conv columns) are held
#: here; 8 layers' f32 weights fit beside the bf16 ones
TP_F32_CUT = {"mamba2-2.7b": (8, 1792, 8)}
#: the full-width serve cells on the mesh: prompt length (SERVE_BATCH rows,
#: SERVE_NEW new tokens), the kernel whose launches a generate counts per
#: process, and the consistency check's (length, decode steps): the last
#: position's logits of a prefill of that length against a prefill of all
#: but the last steps, then teacher-forced decode steps through them.
#: Every decode step's collectives go through the host (0.5-0.8 s a step),
#: so the steps are few; Mamba2's shorter prefill must be a multiple of its
#: SSD chunk of 256 or shorter than it
TP_CELLS = {"llama3.2-3b": (2048, "flash_fwd", (2048, 8)),
            "mamba2-2.7b": (2048, "ssd_diag", (256, 32))}
#: their depth on model 2, cut to pay for model 3's full-depth serve cells
#: (phase_tp3): every layer of a kind runs the same code, and every check
#: stays; and the Llama train step's (its limits do not depend on depth)
TP_SERVE_LAYERS = {"llama3.2-3b": 14, "mamba2-2.7b": 32}
TP_TRAIN_LAYERS = 14
#: a process's kernel shapes at model 2: Llama 3.2 3B's 24/8 heads halved,
#: Mamba2 2.7B's 80 SSD heads halved
TP_FLASH = dict(b=4, s=2048, h=12, g=4, d=128)
TP_SSD = dict(b=4, c=8, q=256, g=1, r=40, p=64, n=128)
#: seconds phase_tp waits for its processes
TP_TIMEOUT = 900
#: slice 16: a model axis of 3 on three processes of the card, which
#: divides neither Llama 3.2 3B's 8 kv heads nor its 2048 + 32 cache, nor
#: Mamba2 2.7B's 80 SSM heads: each process runs 8 q heads with one kv head
#: each (their groups expanded by the index map, so the flash kernels run
#: MHA), a whole cache, and every SSM head (TP_CELLS' serve cells and the
#: Llama train step, at the levels of model 2)
TP3_MODEL = 3
#: the Llama train step's layers at model 3: its FFN's 8192 columns do
#: not divide 3, so each process holds every layer's FFN and its AdamW
#: moments, and three processes of all 28 layers (about 36 GB each) do not
#: fit the one card
TP3_TRAIN_LAYERS = 14
TP3_FLASH = dict(b=4, s=2048, h=8, g=8, d=128)
TP3_SSD = dict(b=4, c=8, q=256, g=1, r=80, p=64, n=128)
#: slice 14, (a): the f32 smoke configs of the families PR 23 left, against
#: one device at the levels above, and a 3-head variant of the Llama smoke
#: config (48 flat q columns, 1.5 heads a process) in the two modes the
#: heads do not divide: batch 4 runs "batch" (each process 2 rows, every
#: head), batch 1 runs "cp" (each process 512 query positions against every
#: key: the flash kernels' q_offset 0 and 512), at 1024-token prompts
TP_SMOKE_FAMILIES = ("whisper-large-v3", "llama-3.2-vision-90b",
                     "deepseek-moe-16b", "mixtral-8x22b", "jamba-v0.1-52b")
TP_MODE_BATCH = {"batch": 4, "cp": 1}
TP_MODE_PROMPT = 1024
#: (b): full width, bf16, SERVE_BATCH rows, SERVE_NEW new tokens on the
#: mesh: (prompt, the consistency's (length, decode steps), layers kept or
#: None).  Whisper's 416 + 32 are its 448 decoder positions; its decoder
#: runs 16 of its 32 layers since slice 16 (its encoder whole: the flash
#: kernel's 32 launches a generate).  The VLM's 20 units of five layers
#: are 179 GB in bf16; the one-device prefill every check is held to runs
#: on the same card after the two processes have freed theirs, so one unit
#: (5 of 100 layers: 4 self-attention and 1 cross-attention layer; 2 units
#: before slice 16) keeps the phase short beside slice 9's 6 units on one
#: device.
TP_FAMILY_CELLS = {"deepseek-moe-16b": (2048, (2048, 8), 14),
                   "whisper-large-v3": (416, (416, 8), 16),
                   VLM: (2048, (2048, 8), 5)}
#: their bf16 prefill logits against one device's, as a share of the
#: largest: 2^-4 for Whisper and the VLM (the serve level of bf16 logits).
#: DeepSeek-MoE's routing takes its top 6 of 64 experts from a bf16 router
#: product: the mesh's sums in another order move a layer's input by bf16
#: rounding, which flips near-tied picks and which tokens an over-full
#: expert drops, and depth amplifies the flips as it amplifies the
#: reference's own prefill-against-decode drift (0.135 of max|logits| at d
#: 128 and 28 layers).  At 28 layers the card read 0.224 and was held to
#: twice that drift, 0.27: 1.2 times the reading.  At the 14 layers it runs
#: now (TP_FAMILY_CELLS) the card read 0.1175, so the limit keeps that room
#: over the 14-layer reading (0.27 / 0.224 of it, 0.1416) and not the
#: 28-layer allowance, which would leave it 2.3 times (the readings by
#: depth: another depth needs its own).  Its sharded MoE layers are held in
#: f32 (TP_FAMILY_F32_CUT), where no pick flips, to 1e-4
TP_DEEPSEEK_BF16_GAP = {28: 0.224, 14: 0.1175}
TP_FAMILY_LOGIT_RTOL = {
    "deepseek-moe-16b": 2 * REFERENCE_MOE_BF16_DRIFT
    / TP_DEEPSEEK_BF16_GAP[28]
    * TP_DEEPSEEK_BF16_GAP[TP_FAMILY_CELLS["deepseek-moe-16b"][2]],
    "whisper-large-v3": 2.0 ** -4, VLM: 2.0 ** -4}
#: full width in f32, cut in depth, the mesh against one device (layers
#: kept, prefill length, decode steps), at capacity factor n_experts /
#: top_k (nothing drops), each step's logits within TP_LOGIT_RTOL
TP_FAMILY_F32_CUT = {"deepseek-moe-16b": (4, 1024, 4)}
#: (c): flash_fwd and flash_bwd with a query offset at a "cp" shape: Llama
#: 3.2 3B's heads, the q rows 1024-2047 of a 2048-token sequence against all
#: 2048 keys, causal; and a process's flash_fwd at model 2 of DeepSeek-MoE
#: 16B's prefill (8 of 16 heads, causal) and Whisper large-v3's encoder (10
#: of 20 heads, 1500 frames, unmasked): (b, s, t, h, g, d, causal, q_offset)
TP_CP_FLASH = (4, 1024, 2048, 24, 8, 128, True, 1024)
TP_FAMILY_FLASH = {"deepseek-moe-16b": (4, 2048, 2048, 8, 8, 128, True, 0),
                   "whisper-large-v3": (4, 1500, 1500, 10, 10, 64, False,
                                        0)}


class _TPCheck(AssertionError):
    """A check of phase_tp that failed in one of its processes."""


def _tp_require(ok: bool, msg: str) -> None:
    if not ok:
        raise _TPCheck(msg)


@contextlib.contextmanager
def _tp_kernel_shapes(records: list):
    """Record the heads of every flash-attention call of the models ((h,
    g)) and of every SSD diagonal block ((h,))."""
    from repro_torch.models import attention as A, ssm as S

    flash, ssd = A.flash_attention, S.ssd_diag

    def f(q, k, v, **kw):
        records.append(("flash_fwd", q.shape[2], k.shape[2]))
        return flash(q, k, v, **kw)

    def s(x, *a, **kw):
        records.append(("ssd_diag", x.shape[3]))
        return ssd(x, *a, **kw)

    A.flash_attention, S.ssd_diag = f, s
    try:
        yield
    finally:
        A.flash_attention, S.ssd_diag = flash, ssd


def _tp_block(x, axes, mesh, cfg):
    """This process's block of a whole array under the config's rules."""
    from repro_torch.configs.registry import rules_for
    from repro_torch.sharding.partition import local_shard, sharding_for_shape
    return local_shard(x, sharding_for_shape(tuple(x.shape), axes, mesh,
                                             rules_for(cfg)), mesh)


def _tp_smoke(arch: str, mesh, dev, cfg=None, rows: int = TP_SMOKE_BATCH,
              plen: int = 0) -> dict:
    """An f32 smoke config (``cfg``, else ``arch``'s) on the mesh against one
    device on the card: prefill logits (random vision or audio inputs, where
    the config takes them), 8 greedy tokens, one train step's loss and
    gradients, at ``rows`` rows of ``plen`` tokens (``SMOKE_PROMPTS``' by
    default).  ``mesh_launches``: the kernel launches of the mesh's calls
    alone."""
    import repro_torch.train.loop as loop_mod
    from repro_torch.configs import get, smoke
    from repro_torch.configs.registry import rules_for
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import (
        build_forward, init_params, logical_axes_tree,
    )
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.partition import local_shard, shard_params
    from repro_torch.train.data import TokenDataset
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import adamw_init

    cfg = smoke(get(arch)) if cfg is None else cfg
    plen = plen or SMOKE_PROMPTS[arch]
    whole = init_params(cfg, 0, dev)
    params = shard_params(whole, logical_axes_tree(cfg), mesh, rules_for(cfg))
    prompts = serve_prompts(cfg, rows, plen)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    batch = model_batch(cfg, toks, dev)
    prefill = build_forward(cfg, "prefill")
    on_mesh: dict = {}

    def counted(fn):
        before = read_counts()
        out = fn()
        for k, n in read_counts().items():
            on_mesh[k] = on_mesh.get(k, 0) + n - before[k]
        return out

    with torch.inference_mode():
        local = {k: _tp_block(v, ("batch",) + (None,) * (v.dim() - 1), mesh,
                              cfg) for k, v in batch.items()}
        got = counted(lambda: prefill(params, local, cfg, mesh)[0])
        want = _tp_block(prefill(whole, batch, cfg)[0],
                         ("batch", "vocab"), mesh, cfg)
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    _tp_require(err <= TP_LOGIT_RTOL * top, f"tp smoke {arch}: prefill "
                f"logits {err} apart, largest {top}")
    logit_err = err / top
    n = plen + TP_SMOKE_NEW
    t_mesh = counted(lambda: ServeEngine(cfg, params, mesh, max_len=n)
                     .generate(prompts, TP_SMOKE_NEW).tokens)
    t_one = ServeEngine(cfg, whole, device=dev, max_len=n).generate(
        prompts, TP_SMOKE_NEW).tokens
    _tp_require((t_mesh == t_one).all(), f"tp smoke {arch}: tokens "
                f"{t_mesh.tolist()} against one device's {t_one.tolist()}")
    ds = TokenDataset(cfg.vocab, plen, rows, seed=3)
    batch = {**ds.batch_at(0), **ds.extras(cfg)}
    real, seen = loop_mod.adamw_update, []

    def spy(grads, *a, **k):
        seen.append([g.detach().clone() for g in tree_leaves(grads)])
        return real(grads, *a, **k)

    loop_mod.adamw_update = spy
    try:
        step = make_train_step(cfg, mesh)
        _, _, m_mesh = counted(lambda: step(params, adamw_init(params),
                                            batch))
        _, _, m_one = make_train_step(cfg, device=dev)(
            whole, adamw_init(whole), batch)
    finally:
        loop_mod.adamw_update = real
    loss = (float(m_mesh["loss"]), float(m_one["loss"]))
    _tp_require(abs(loss[0] - loss[1]) <= TRAIN_LOSS_RTOL * abs(loss[1]),
                f"tp smoke {arch}: losses {loss}")
    worst = 0.0
    for i, (g, w, spec) in enumerate(zip(seen[0], seen[1],
                                         step.data_parallel.specs)):
        blk = local_shard(w, spec, mesh)
        top = float(w.abs().max())
        e = float((g - blk).abs().max())
        _tp_require(e <= TRAIN_GRAD_RTOL * top, f"tp smoke {arch}: gradient "
                    f"leaf {i} {e} apart, largest {top}")
        worst = max(worst, e / top if top else 0.0)
    return {"logit_err": logit_err, "tokens_equal": True, "losses": loss,
            "mesh_launches": {k: n for k, n in on_mesh.items() if n},
            "grad_norms": (float(m_mesh["grad_norm"]),
                           float(m_one["grad_norm"])), "worst_grad": worst}


def _tp_ssm_layer(cfg, whole, params, mesh, dev, plen: int) -> float:
    """The first Mamba2 layer's mixer on the mesh against one device, fed
    the same N(0, 1) input: max|diff| as a share of max|output|, held to
    SSM_LAYER_BF16_RTOL."""
    from repro_torch.models import ssm as S
    from repro_torch.sharding import spmd

    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((SERVE_BATCH, plen, cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
              n_groups=cfg.ssm_groups, expand=cfg.ssm_expand,
              chunk=cfg.ssm_chunk)
    mixer = lambda tree: {k: v[0] for k, v in tree["unit"][0][  # noqa
        "mixer"].items()}
    want = S.ssm_apply(mixer(whole), x, **kw).float()
    got = S.ssm_apply(mixer(params), x, mesh=spmd.context(mesh, cfg),
                      **kw).float()
    err = float((got - want).abs().max()) / float(want.abs().max())
    _tp_require(err <= SSM_LAYER_BF16_RTOL, f"tp {cfg.name}: a layer on the "
                f"mesh {err} of max|output| from one device's")
    return err


def _tp_f32_cut(cfg, whole, mesh, dev, toks, layers: int, plen: int,
                steps: int) -> float:
    """``cfg`` cut to ``layers``, in f32, on the mesh against one device: a
    prefill of ``plen`` tokens, then ``steps`` decode steps through the
    next tokens of ``toks``; the worst max|diff| of the prefill's and each
    step's logits as a share of their max|logits|, held to
    TP_LOGIT_RTOL."""
    import dataclasses
    from repro_torch.configs.registry import rules_for
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import build_forward, logical_axes_tree
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.partition import shard_params

    ccfg, cut = cut_depth(cfg, whole, layers)
    ccfg = dataclasses.replace(ccfg, dtype="float32")
    one = tree_map(lambda t: t.float(), cut)
    params = shard_params(one, logical_axes_tree(ccfg), mesh,
                          rules_for(ccfg))
    prefill, decode = (build_forward(ccfg, k) for k in ("prefill", "decode"))
    got, pre = prefill(params, {"tokens": toks[:, :plen]}, ccfg, mesh)
    c_mesh = ServeEngine(ccfg, params, mesh, max_len=plen + steps
                         ).decode_cache(pre, SERVE_BATCH)
    want, pre = prefill(one, {"tokens": toks[:, :plen]}, ccfg)
    c_one = ServeEngine(ccfg, one, device=dev, max_len=plen + steps
                        ).decode_cache(pre, SERVE_BATCH)
    del pre
    worst = 0.0
    for i in range(plen, plen + steps + 1):
        w = _tp_block(want, ("batch", "vocab"), mesh, ccfg)
        err = float((got - w).abs().max()) / float(w.abs().max())
        _tp_require(err <= TP_LOGIT_RTOL, f"tp {cfg.name} f32 at {layers} "
                    f"layers: logits at position {i - 1} {err} of max|logits| "
                    "from one device's")
        worst = max(worst, err)
        if i < plen + steps:
            tok = {"tokens": toks[:, i:i + 1]}
            got, c_mesh = decode(params, c_mesh, tok, i, ccfg, mesh)
            want, c_one = decode(one, c_one, tok, i, ccfg)
    return worst


def _tp_peak_gib(dev):
    """The process's peak GiB on the card since the last reset (None off
    the card)."""
    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)


def _tp_serve(arch: str, mesh, dev, rank: int, layers: int | None = None
              ) -> dict:
    """A full-width bf16 config served on the mesh (at ``layers`` where
    given): prefill logits against one device's, a generate (its launches
    and their heads), and the prefill/decode consistency on the mesh."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.configs.registry import rules_for
    from repro_torch.models.model import (
        build_forward, init_params, logical_axes_tree,
    )
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.partition import shard_params

    cfg = get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    plen, kernel, (clen, steps) = TP_CELLS[arch]
    prompts = serve_prompts(cfg, SERVE_BATCH, plen)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    prefill = build_forward(cfg, "prefill")
    decode = build_forward(cfg, "decode")
    whole = init_params(cfg, 0, dev)
    row = {"layers": cfg.n_layers}
    with torch.inference_mode():
        want = _tp_block(prefill(whole, {"tokens": toks}, cfg)[0],
                         ("batch", "vocab"), mesh, cfg).float().clone()
        params = shard_params(whole, logical_axes_tree(cfg), mesh,
                              rules_for(cfg))
        if cfg.family == "ssm":
            row["layer_err"] = _tp_ssm_layer(cfg, whole, params, mesh, dev,
                                             plen)
        if arch in TP_F32_CUT:
            row["f32_cut_err"] = _tp_f32_cut(cfg, whole, mesh, dev, toks,
                                             *TP_F32_CUT[arch])
    del whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    engine = ServeEngine(cfg, params, mesh, max_len=plen + SERVE_NEW)
    seen = []
    real = engine._prefill
    engine._prefill = lambda *a: seen.append(real(*a)) or seen[-1]
    shapes = []
    reset_counts()
    with _tp_kernel_shapes(shapes):
        res = engine.generate(prompts, SERVE_NEW)
    row["launches"] = read_counts()
    full = seen[0][0].float()                   # the generate's prefill
    del seen
    err = float((full - want).abs().max())
    top = float(want.abs().max())
    row["logit_err"] = err / top
    _tp_require(err <= TP_BF16_LOGIT_RTOL[arch] * top, f"tp {arch}: prefill "
                f"logits {err} apart from one device's, largest {top}")
    row["heads"] = sorted(set(tuple(x[1:]) for x in shapes if x[0] == kernel))
    row["kernel_calls"] = sum(1 for x in shapes if x[0] == kernel)
    row["generate_prefill_ms_gloo"] = 1e3 * res.prefill_sec
    row["generate_decode_ms_gloo"] = 1e3 * res.decode_sec
    t0 = time.perf_counter()
    with torch.inference_mode():
        if clen != plen:
            full = prefill(params, {"tokens": toks[:, :clen]}, cfg,
                           mesh)[0].float()
        logits, pre = prefill(params, {"tokens": toks[:, :clen - steps]},
                              cfg, mesh)
        cache = ServeEngine(cfg, params, mesh, max_len=clen).decode_cache(
            pre, SERVE_BATCH)
        del pre
        for i in range(clen - steps, clen):
            logits, cache = decode(params, cache, {"tokens": toks[:, i:i + 1]},
                                   i, cfg, mesh)
    row["consistency"] = (float((logits.float() - full).abs().max()),
                          float(full.abs().max()))
    row["consistency_ms_gloo"] = 1e3 * (time.perf_counter() - t0)
    row["tokens"] = res.tokens.tolist()
    row["peak_gib"] = _tp_peak_gib(dev)
    return row


def _tp_train(mesh, dev, rank: int, layers: int | None = None) -> dict:
    """One Llama 3.2 3B train step at 4 x 2048 on the mesh (launches, ms,
    peak), then, on process 0 alone, the same step on one device; at
    ``layers`` of its 28 where given."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.models.model import init_params
    from repro_torch.train.data import TokenDataset
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import adamw_init

    cfg = get("llama3.2-3b")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    batch = TokenDataset(cfg.vocab, 2048, TRAIN_BATCH, seed=1).batch_at(0)
    params = init_params(cfg, 0, dev, mesh=mesh)
    opt = adamw_init(params)
    step = make_train_step(cfg, mesh)
    row = {"layers": cfg.n_layers}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    row["loss"] = float(m["loss"])
    row["grad_norm"] = float(m["grad_norm"])
    row["step_ms_gloo"] = 1e3 * (time.perf_counter() - t0)
    row["launches"] = read_counts()
    row["peak_gib"] = _tp_peak_gib(dev)
    del params, opt, step, m
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        whole = init_params(cfg, 0, dev)
        _, _, m = make_train_step(cfg, device=dev)(whole, adamw_init(whole),
                                                   batch)
        row["one_device"] = (float(m["loss"]), float(m["grad_norm"]))
        del whole, m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    return row


def _tp_gloo(dev, rank: int) -> dict:
    """The collectives of the sharded model on CUDA tensors over gloo: the
    sum and max all-reduce, the all-gather, the reduce-scatter and the
    all-to-all (attention's "batch" and "cp" modes), exact on small
    integers in bf16 and f32 (no upcast); and the ms of a 64 MiB sum
    all-reduce of each (the mean of 3)."""
    import torch.distributed as dist
    out = {}
    w = dist.get_world_size()
    for dt in (torch.bfloat16, torch.float32):
        x = torch.full((2 * w, 5), float(rank + 1), device=dev, dtype=dt)
        s, m = x.clone(), x.clone()
        dist.all_reduce(s)
        dist.all_reduce(m, dist.ReduceOp.MAX)
        g = x.new_empty((w * 2 * w, 5))
        dist.all_gather_into_tensor(g, x)
        r = x.new_empty((2, 5))
        dist.reduce_scatter_tensor(r, x)
        # all-to-all: block k of each process to process k
        a = (torch.arange(2 * w, device=dev)[:, None] + 100 * rank).to(dt) \
            .expand(2 * w, 5).contiguous()
        a2 = torch.empty_like(a)
        dist.all_to_all_single(a2, a)
        want_a = (torch.arange(2 * rank, 2 * rank + 2, device=dev)[None]
                  + 100 * torch.arange(w, device=dev)[:, None]).reshape(-1)
        tot = w * (w + 1) // 2
        each = torch.arange(1, w + 1, device=dev).repeat_interleave(2 * w)
        _tp_require(all(t.dtype == dt for t in (s, m, g, r, a2))
                    and bool((s == tot).all()) and bool((m == w).all())
                    and bool((g == each[:, None].to(dt)).all())
                    and bool((r == tot).all())
                    and bool((a2 == want_a[:, None].to(dt)).all()),
                    f"gloo's collectives of a {dt} CUDA tensor gave sum {s}, "
                    f"max {m}, all-gather {g}, reduce-scatter {r}, "
                    f"all-to-all {a2}")
        big = torch.ones(64 * 2 ** 20 // x.element_size(), device=dev,
                         dtype=dt)
        dist.all_reduce(big)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_reduce(big)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[str(dt).replace("torch.", "")] = 1e3 * (time.perf_counter()
                                                    - t0) / 3
        del big
    return out


def _tp_modes(mesh, dev) -> dict:
    """(a) of slice 14's modes: the 3-head Llama smoke variant at batch 4
    ("batch") and 1 ("cp") against one device (``_tp_smoke``), with the
    mode each ran in and its flash calls' (q rows, heads, q_offset)."""
    import dataclasses
    from repro_torch.configs import get, smoke
    from repro_torch.models import attention as A
    from repro_torch.sharding import spmd

    base = smoke(get("llama3.2-3b"))
    cfg = dataclasses.replace(base, n_heads=3, n_kv_heads=1,
                              name=base.name + "-3h")
    ctx = spmd.context(mesh, cfg)
    flash, out = A.flash_attention, {}
    for mode, rows in TP_MODE_BATCH.items():
        calls: list = []

        def spy(q, k, v, **kw):
            calls.append((q.shape[1], q.shape[2], kw.get("q_offset", 0)))
            return flash(q, k, v, **kw)

        ran = A._mode(ctx, cfg.n_heads, rows)
        _tp_require(ran == mode, f"tp modes: {rows} rows ran {ran!r}, not "
                    f"{mode!r}")
        A.flash_attention = spy
        try:
            reset_counts()
            row = _tp_smoke("llama3.2-3b", mesh, dev, cfg, rows,
                            TP_MODE_PROMPT)
        finally:
            A.flash_attention = flash
        row["flash_calls"] = sorted(set(calls))
        out[mode] = row
    return out


def _tp_init(cfg, dev, mesh, rank: int):
    """This process's blocks of ``cfg``'s weights (seed 0), the processes
    drawing in turn: each leaf is drawn whole in f32 before it is cut, and
    two full-size draws at once would not fit the one card."""
    import torch.distributed as dist
    from repro_torch.models.model import init_params
    from repro_torch.sharding import spmd
    spmd.context(mesh, cfg)     # collective the first time: every process
    params = None
    for r in range(dist.get_world_size()):
        if r == rank:
            params = init_params(cfg, 0, dev, mesh=mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
        dist.barrier()
    return params


def _tp_family(arch: str, mesh, dev, rank: int) -> dict:
    """(b) of slice 14: a full-width bf16 config served on the mesh (a
    generate: its launches, heads and expert-drop shares; the prefill/decode
    consistency on the mesh), then, on process 0 alone once both have freed
    their blocks, the same prefill on one device, which the mesh's whole
    logits (both vocab blocks) are held to."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.models.model import build_forward, init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import spmd

    cfg = get(arch)
    plen, (clen, steps), depth = TP_FAMILY_CELLS[arch]
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    prompts = serve_prompts(cfg, SERVE_BATCH, plen)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    batch = model_batch(cfg, toks, dev)
    prefill = build_forward(cfg, "prefill")
    decode = build_forward(cfg, "decode")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = _tp_init(cfg, dev, mesh, rank)
    ctx = spmd.context(mesh, cfg)
    row: dict = {"layers": cfg.n_layers}
    with torch.inference_mode():
        got = ctx.all_gather(prefill(params, batch, cfg, mesh)[0], 1)
    got = got.float().cpu()
    engine = ServeEngine(cfg, params, mesh, max_len=plen + SERVE_NEW)
    shapes, routes = [], []
    reset_counts()
    with _tp_kernel_shapes(shapes), moe_routes(routes):
        res = engine.generate(prompts, SERVE_NEW)
    row["launches"] = read_counts()
    row["heads"] = sorted(set(tuple(x[1:]) for x in shapes
                              if x[0] == "flash_fwd"))
    row["kernel_calls"] = sum(1 for x in shapes if x[0] == "flash_fwd")
    if routes:
        n = cfg.n_layers
        row["picks_prefill"] = drop_shares(routes[:n])
        row["picks_decode_step"] = drop_shares(routes[n:2 * n])
    row["generate_prefill_ms_gloo"] = 1e3 * res.prefill_sec
    row["generate_decode_ms_gloo"] = 1e3 * res.decode_sec
    row["tokens"] = res.tokens.tolist()
    del engine
    ccfg = cfg
    if cfg.n_experts:       # cap = tokens: nothing drops at any step
        ccfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                   / cfg.top_k)
    t0 = time.perf_counter()
    with torch.inference_mode():
        full = prefill(params, {k: v[:, :clen] if k == "tokens" else v
                                for k, v in batch.items()}, ccfg,
                       mesh)[0].float()
        logits, pre = prefill(params, {k: v[:, :clen - steps]
                                       if k == "tokens" else v
                                       for k, v in batch.items()}, ccfg, mesh)
        cache = ServeEngine(ccfg, params, mesh, max_len=clen).decode_cache(
            pre, SERVE_BATCH)
        del pre
        for i in range(clen - steps, clen):
            logits, cache = decode(params, cache, {"tokens": toks[:, i:i + 1]},
                                   i, ccfg, mesh)
    row["consistency"] = (float((logits.float() - full).abs().max()),
                          float(full.abs().max()))
    row["consistency_ms_gloo"] = 1e3 * (time.perf_counter() - t0)
    row["peak_gib"] = _tp_peak_gib(dev)
    del cache, logits, full
    cut_mesh = None
    if arch in TP_FAMILY_F32_CUT:
        cut_mesh = _tp_f32_steps(arch, ccfg, params, mesh, batch, ctx)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        whole = init_params(cfg, 0, dev)
        with torch.inference_mode():
            want = prefill(whole, batch, cfg)[0].float().cpu()
        if cut_mesh is not None:
            cut_one = _tp_f32_steps(arch, ccfg, whole, None, batch, None)
            row["f32_cut_err"] = max(
                float((a - w).abs().max()) / float(w.abs().max())
                for a, w in zip(cut_mesh, cut_one))
            _tp_require(row["f32_cut_err"] <= TP_LOGIT_RTOL, f"tp {arch} "
                        f"f32 cut: logits {row['f32_cut_err']} of max|logits|"
                        " from one device's")
        del whole
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        err, top = float((got - want).abs().max()), float(want.abs().max())
        row["logit_err"] = err / top
        _tp_require(err <= TP_FAMILY_LOGIT_RTOL[arch] * top, f"tp {arch}: "
                    f"prefill "
                    f"logits {err} apart from one device's, largest {top}")
    dist.barrier()
    return row


def _tp_f32_steps(arch: str, cfg, params, mesh, batch, ctx) -> list:
    """``cfg`` cut to TP_FAMILY_F32_CUT's layers, in f32: the logits (whole
    vocab, on the host) of a prefill and of each decode step after it,
    teacher-forced through the batch's next tokens, on the mesh (``params``
    this process's blocks, ``ctx`` its context) or on one device."""
    import dataclasses
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import build_forward
    from repro_torch.serve.engine import ServeEngine

    layers, plen, steps = TP_FAMILY_F32_CUT[arch]
    ccfg, cut = cut_depth(cfg, params, layers)
    ccfg = dataclasses.replace(ccfg, dtype="float32")
    cut = tree_map(lambda t: t.float(), cut)
    args = () if mesh is None else (mesh,)
    toks = batch["tokens"]
    whole = (lambda x: x) if ctx is None else \
        (lambda x: ctx.all_gather(x, 1))
    prefill, decode = (build_forward(ccfg, k) for k in ("prefill", "decode"))
    out = []
    with torch.inference_mode():
        logits, pre = prefill(cut, {"tokens": toks[:, :plen]}, ccfg, *args)
        out.append(whole(logits).float().cpu())
        eng = (ServeEngine(ccfg, cut, mesh, max_len=plen + steps) if mesh
               is not None else ServeEngine(ccfg, cut, device=toks.device,
                                            max_len=plen + steps))
        cache = eng.decode_cache(pre, toks.shape[0])
        del pre
        for i in range(plen, plen + steps):
            logits, cache = decode(cut, cache, {"tokens": toks[:, i:i + 1]},
                                   i, ccfg, *args)
            out.append(whole(logits).float().cpu())
    return out


def _tp_train_moe(mesh, dev, rank: int) -> dict:
    """(b) of slice 14: one DeepSeek-MoE 16B train step at its 9-layer cut
    (DEEPSEEK_TRAIN_LAYERS), 4 x 2048, on the mesh (launches, ms, peak),
    then, on process 0 alone, the same step on one device."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.models.model import init_params
    from repro_torch.train.data import TokenDataset
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import adamw_init

    cfg = dataclasses.replace(get("deepseek-moe-16b"),
                              n_layers=DEEPSEEK_TRAIN_LAYERS)
    batch = TokenDataset(cfg.vocab, 2048, TRAIN_BATCH, seed=1).batch_at(0)
    params = _tp_init(cfg, dev, mesh, rank)
    opt = adamw_init(params)
    step = make_train_step(cfg, mesh)
    row = {"layers": cfg.n_layers}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    row["loss"] = float(m["loss"])
    row["grad_norm"] = float(m["grad_norm"])
    row["step_ms_gloo"] = 1e3 * (time.perf_counter() - t0)
    row["launches"] = read_counts()
    row["peak_gib"] = _tp_peak_gib(dev)
    del params, opt, step, m
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        whole = init_params(cfg, 0, dev)
        _, _, m = make_train_step(cfg, device=dev)(whole, adamw_init(whole),
                                                   batch)
        row["one_device"] = (float(m["loss"]), float(m["grad_norm"]))
        del whole, m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    return row


def _tp_worker(rank: int, world: int, store: str, queue, opts: dict) -> None:
    """One process of phase_tp: gloo on a FileStore, the mesh's tensors on
    ``opts["device"]`` (CUDA: the opt-in of ``make_test_mesh``)."""
    import datetime
    import traceback
    import torch.distributed as dist
    try:
        dev = torch.device(opts["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
            torch.backends.cuda.matmul.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TP_TIMEOUT))
        try:
            from repro_torch.launch.mesh import make_test_mesh
            mesh = make_test_mesh(1, world, device=(
                "cuda" if dev.type == "cuda" else None))
            out = {"gloo_64mib_ms": _tp_gloo(dev, rank), "world": world}
            out["smoke"] = {a: _tp_smoke(a, mesh, dev) for a in opts["smoke"]}
            out["serve"] = {a: _tp_serve(a, mesh, dev, rank, opts.get(
                "serve_layers", {}).get(a)) for a in opts["serve"]}
            if opts["train"]:
                out["train"] = _tp_train(mesh, dev, rank,
                                         opts.get("train_layers"))
            out["modes"] = _tp_modes(mesh, dev) if opts["modes"] else {}
            out["families"] = {a: _tp_family(a, mesh, dev, rank)
                               for a in opts["families"]}
            if opts["moe_train"]:
                out["moe_train"] = _tp_train_moe(mesh, dev, rank)
        finally:
            dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def tp_processes(opts: dict, base: Path, world: int = TP_MODEL
                 ) -> list[dict]:
    """phase_tp's processes (spawned, ``world`` of them: the model axis):
    each one's result, in rank order; fails, ending them all, when one
    fails or they do not end within TP_TIMEOUT."""
    import queue as queue_mod
    import shutil
    import torch.multiprocessing as mp

    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_tp_worker,
                         args=(r, world, str(base / "store"), q, opts))
             for r in range(world)]
    for p in procs:
        p.start()
    outs, err = {}, None
    try:
        deadline = time.perf_counter() + TP_TIMEOUT
        while len(outs) < world and err is None:
            try:
                rank, out = q.get(timeout=max(1.0, deadline -
                                              time.perf_counter()))
            except queue_mod.Empty:
                err = f"no result within {TP_TIMEOUT} s"
                break
            if isinstance(out, str):
                err = f"process {rank}:\n{out}"
            outs[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if err is None else 1)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(base, ignore_errors=True)
    if err is not None:
        fail(f"tp: {err}")
    return [outs[r] for r in range(world)]


def tp_kernel_rows(dev, launches: dict) -> list[dict]:
    """A process's kernel shapes at model 2 (TP_FLASH, TP_SSD; slice 14's
    TP_FAMILY_FLASH) and the offset flash kernels at TP_CP_FLASH, against
    their plain versions, then timed in turns with PyTorch's SDPA (flash)
    beside the plain version and the bound (:func:`tp_flash_rows`)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    b, s, h, g, d = (TP_FLASH[k] for k in "bshgd")
    cp, fam = launches["cp"], launches["families"]
    rows = tp_flash_rows(dev, gen, [
        ("tp llama3.2-3b", (b, s, s, h, g, d, True, 0),
         launches["flash_fwd"], launches["flash_bwd"]),
        ("cp llama3.2-3b", TP_CP_FLASH, cp["flash_fwd"], cp["flash_bwd"])]
        + [(f"tp {a}", x, fam[a], None) for a, x in TP_FAMILY_FLASH.items()])
    rows.append(tp_ssd_row(dev, gen, TP_SSD, launches["ssd_diag"],
                           "tp mamba2-2.7b"))
    for row in rows:
        print(f"tp timing {row['name']} at {row['cell']}'s process shape "
              f"{json.dumps(row['shape'])}: kernel {row['ms']:.4f} ms, "
              f"library {row['library_ms']}, plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); launches "
              f"{json.dumps(row['launches'])} ({CARD})")
    return rows


def tp_ssd_row(dev, gen, shape: dict, launches: dict, cell: str) -> dict:
    """ssd_diag at a process's Mamba2 shape against its plain version,
    timed in turns beside the plain version and the bound."""
    from repro_torch.kernels.ssd import ops as sops, ref as sref

    b, c, qq, g, r, p, n = (shape[k] for k in ("b", "c", "q", "g", "r",
                                                 "p", "n"))
    x, dt, cum, bm, cm = ssd_inputs(gen, b, c, qq, g, r, p, n,
                                    torch.bfloat16, dev)
    err = check_close("ssd_diag", sops.ssd_diag(
        x, dt, cum, bm, cm, r, out_dtype=torch.float32), sref.ssd_diag_ref(
        x, dt, cum, bm, cm, r, out_dtype=torch.float32),
        f"at a process's Mamba2 shape ({g * r} heads)")
    # zoo_timings' bound: the bytes once, the products on the tensor cores
    pairs = qq * (qq + 1) / 2
    h = g * r
    nbytes = b * c * qq * (h * p * 2 + 2 * h * 4 + 2 * g * n * 2 + h * p * 4)
    y_flops, s_flops = 2 * b * c * pairs * h * p, 2 * b * c * pairs * g * n
    tc_flops = 2 * y_flops + s_flops * PEAK_TF32_FLOPS / PEAK_BF16_FLOPS
    bnd, bby = bound(nbytes, tc_flops, PEAK_TF32_FLOPS)
    ins = (x, dt, cum, bm, cm)
    turns = [cuda_ms(lambda: sops.ssd_diag(*ins, r, out_dtype=torch.float32),
                     20),
             cuda_ms(lambda: sref.ssd_diag_ref(*ins, r, torch.float32), 5),
             cuda_ms(lambda: sops.ssd_diag(*ins, r, out_dtype=torch.float32),
                     20)]
    return {"name": "ssd_diag", "cell": cell, "shape": dict(shape),
            "launches": launches, "max_abs_err": err,
            "ms": (turns[0] + turns[2]) / 2, "plain_ms": turns[1],
            "bound_ms": bnd, "bound_by": bby, "library_ms": None,
            "flops": tc_flops}


def tp_flash_rows(dev, gen, cells: list) -> list[dict]:
    """flash_fwd (and flash_bwd where its launches are given) at each of
    ``cells`` — (cell, (b, s, t, h, g, d, causal, q_offset), flash_fwd's
    launches, flash_bwd's or None) — against its plain version, timed in
    turns with SDPA (its causal flag at offset 0, else the boolean mask of
    the offset) beside the plain version and the bound of the keys the
    mask leaves visible."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref

    rows = []
    for cell, (b, s, t, h, g, d, causal, off), fwd_l, bwd_l in cells:
        q, k, v = flash_inputs(gen, b, s, h, g, d, torch.bfloat16, dev, t)
        kw = dict(causal=causal, q_offset=off)
        out, lse = fops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        what = f"at {cell}'s process shape (h {h}, g {g}, q_offset {off})"
        err = check_close("flash_fwd", out, fref.attention_ref(q, k, v, **kw),
                          what)
        # the keys each query row sees: all of them, or positions <= its own
        pairs = s * t if not causal else s * off + s * (s + 1) / 2
        fwd_flops = 4 * b * h * d * pairs
        mask = None
        if causal and off:
            i = off + torch.arange(s, device=dev)[:, None]
            mask = torch.arange(t, device=dev)[None] <= i
        sdpa = dict(attn_mask=mask, is_causal=causal and not off,
                    enable_gqa=True)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        kern = lambda: fops.flash_attention_fwd(q, k, v, **kw)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, **sdpa)
        with torch.no_grad():
            turns = [cuda_ms(kern, 20), cuda_ms(lib, 20), cuda_ms(kern, 20)]
        bnd, bby = bound(2 * (2 * b * s * h * d + 2 * b * t * g * d),
                         fwd_flops, PEAK_BF16_FLOPS)
        shape = dict(b=b, s=s, t=t, h=h, g=g, d=d, causal=causal,
                     q_offset=off)
        rows.append({"name": "flash_fwd", "cell": cell, "shape": shape,
                     "launches": fwd_l, "max_abs_err": err,
                     "ms": (turns[0] + turns[2]) / 2,
                     "plain_ms": cuda_ms(lambda: fref.attention_ref(
                         q, k, v, **kw), 3),
                     "bound_ms": bnd, "bound_by": bby,
                     "library_ms": turns[1], "flops": fwd_flops})
        if bwd_l is not None:
            dout = torch.randn(q.shape, generator=gen, device=dev).to(
                torch.bfloat16)
            got = fops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            want = fref.attention_bwd_ref(q, k, v, out, lse, dout, **kw)
            err = max(check_close("flash_bwd", a, w, f"d{n} {what}")
                      for n, a, w in zip("qkv", got, want))
            ot = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
            dot = dout.transpose(1, 2).contiguous()
            kern = lambda: fops.flash_attention_bwd(  # noqa: E731
                q, k, v, out, lse, dout, **kw)
            lib = lambda: torch.autograd.grad(  # noqa: E731
                ot, (qt, kt, vt), dot, retain_graph=True)
            turns = [cuda_ms(kern, 10), cuda_ms(lib, 10), cuda_ms(kern, 10)]
            flops = 2.5 * fwd_flops
            bnd, bby = bound(2 * (4 * b * s * h * d + 4 * b * t * g * d)
                             + 4 * b * s * h, flops, PEAK_BF16_FLOPS)
            rows.append({"name": "flash_bwd", "cell": cell, "shape": shape,
                         "launches": bwd_l, "max_abs_err": err,
                         "ms": (turns[0] + turns[2]) / 2,
                         "plain_ms": cuda_ms(lambda: fref.attention_bwd_ref(
                             q, k, v, out, lse, dout, **kw), 3),
                         "bound_ms": bnd, "bound_by": bby,
                         "library_ms": turns[1], "flops": flops})
            del dout, got, want, ot, dot
        del q, k, v, out, lse, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def tp_want_heads(kernel: str, world: int) -> list:
    """The heads of a process's flash_fwd ((q, kv)) or ssd_diag ((heads,))
    calls at a model axis of ``world``: Llama 3.2 3B's 24 q heads dealt
    (its 8 kv heads too where they divide, else one a q head by the index
    map), Mamba2 2.7B's 80 dealt where they divide, else all of them."""
    if kernel == "flash_fwd":
        q = 24 // world
        return [[q, 8 // world if 8 % world == 0 else q]]
    return [[80 // world if 80 % world == 0 else 80]]


def tp_report(outs: list[dict]) -> dict:
    """phase_tp's checks across its processes' results (:func:`_tp_worker`),
    printed; the phase's row."""
    row = tp_report_serve(outs)
    row.update(tp_report_families(outs))
    return row


def tp_report_serve(outs: list[dict]) -> dict:
    """The checks of the full-width serve cells (TP_CELLS) and the Llama
    train step across the processes, at the model axis they ran on."""
    import dataclasses
    world = outs[0]["world"]
    where = f"data 1 x model {world}"
    row = {"card": CARD, "model": world, "smoke": outs[0]["smoke"],
           "gloo_64mib_ms": [o["gloo_64mib_ms"] for o in outs]}
    print(f"tp: gloo's sum and max all-reduce, all-gather and reduce-scatter "
          f"of bf16 and f32 CUDA tensors exact, no upcast; a 64 MiB sum "
          f"all-reduce a process: {json.dumps(row['gloo_64mib_ms'])} ms "
          f"({CARD})")
    for arch in outs[0]["smoke"]:
        print(f"tp smoke {arch} (f32) on {where} against one "
              f"device: {json.dumps(outs[0]['smoke'][arch])}")
    for arch, (plen, kernel, (clen, steps)) in TP_CELLS.items():
        rows = [o["serve"][arch] for o in outs]
        cfg_layers = rows[0]["layers"]
        for r, got in enumerate(rows):
            if got["launches"][kernel] != cfg_layers or \
                    got["kernel_calls"] != cfg_layers:
                fail(f"tp {arch}: process {r} launched {kernel} "
                     f"{got['launches'][kernel]} times a generate "
                     f"({got['kernel_calls']} calls), not {cfg_layers}")
            want = tp_want_heads(kernel, world)
            if [list(x) for x in got["heads"]] != want:
                fail(f"tp {arch}: process {r} ran {kernel} at heads "
                     f"{got['heads']}, not {want}")
        if any(g["tokens"] != rows[0]["tokens"] for g in rows):
            fail(f"tp {arch}: the processes returned other tokens")
        err = max(g["consistency"][0] for g in rows)
        top = max(g["consistency"][1] for g in rows)
        limit = CONSISTENCY_BF16_RTOL[arch]
        layer = [g["layer_err"] for g in rows if "layer_err" in g]
        cut = [g["f32_cut_err"] for g in rows if "f32_cut_err" in g]
        print(f"tp {arch} bf16 at {cfg_layers} layers on {where}: prefill "
              f"logits within "
              f"{max(g['logit_err'] for g in rows):.4g} of one device's "
              f"(limit {TP_BF16_LOGIT_RTOL[arch]:.4g}); "
              + (f"its first layer alone within {max(layer):.4g} (limit "
                 f"{SSM_LAYER_BF16_RTOL:.4g}); " if layer else "")
              + (f"f32 at {TP_F32_CUT[arch][0]} layers, prefill "
                 f"{TP_F32_CUT[arch][1]} + {TP_F32_CUT[arch][2]} decode "
                 f"steps, within {max(cut):.4g} of one device's (limit "
                 f"{TP_LOGIT_RTOL:.4g}); " if cut else "")
              + f"consistency prefill "
              f"{clen} vs prefill {clen - steps} + {steps} decode "
              f"steps: {err:.4g} of max|logits| {top:.4g} (limit "
              f"{limit * top:.4g}; {rows[0]['consistency_ms_gloo']:.0f} ms); "
              f"launches a generate a process "
              f"{json.dumps(rows[0]['launches'])}; heads {rows[0]['heads']}; "
              f"gloo through the host: generate prefill "
              f"{rows[0]['generate_prefill_ms_gloo']:.1f} ms, decode "
              f"{rows[0]['generate_decode_ms_gloo']:.1f} ms; peak GiB "
              f"{[g['peak_gib'] for g in rows]} ({CARD})")
        if not err <= limit * top:
            fail(f"tp {arch}: prefill/decode consistency {err} > {limit} * "
                 f"{top}")
        row[arch] = {k: [g[k] for g in rows if k in g] for k in
                     ("logit_err", "layer_err", "f32_cut_err",
                      "consistency_ms_gloo",
                      "generate_prefill_ms_gloo", "generate_decode_ms_gloo",
                      "peak_gib")}
        row[arch].update(consistency=(err, top), launches=rows[0]["launches"],
                         heads=rows[0]["heads"], layers=cfg_layers)
    train = [o["train"] for o in outs]
    one_loss, one_norm = train[0]["one_device"]
    from repro_torch.configs import get
    layers = outs[0]["train"]["layers"]
    want = train_launches(dataclasses.replace(get("llama3.2-3b"),
                                              n_layers=layers))
    for r, got in enumerate(train):
        if any(got["launches"][k] != n for k, n in want.items()):
            fail(f"tp train: process {r} launched {got['launches']}, not "
                 f"{want} a step")
        if not abs(got["loss"] - one_loss) <= TP_BF16_LOSS_RTOL * one_loss:
            fail(f"tp train: process {r}'s loss {got['loss']} against one "
                 f"device's {one_loss}")
        if not abs(got["grad_norm"] - one_norm) <= \
                TP_BF16_GRAD_NORM_RTOL * one_norm:
            fail(f"tp train: process {r}'s reduced-gradient norm "
                 f"{got['grad_norm']} against one device's {one_norm}")
    print(f"tp train Llama 3.2 3B at {layers} of 28 layers, 4 x 2048 bf16 "
          f"on {where}: losses "
          f"{[g['loss'] for g in train]} against one device's {one_loss} "
          f"(limit {TP_BF16_LOSS_RTOL:.4g} relative); reduced-gradient norms "
          f"{[g['grad_norm'] for g in train]} against {one_norm} (limit "
          f"{TP_BF16_GRAD_NORM_RTOL:.4g} relative); launches a "
          f"process {json.dumps(train[0]['launches'])}; step ms (gloo "
          f"through the host) {[round(g['step_ms_gloo'], 1) for g in train]}"
          f"; peak GiB {[g['peak_gib'] for g in train]} ({CARD})")
    row["train"] = {"layers": layers, "losses": [g["loss"] for g in train],
                    "one_device": [one_loss, one_norm],
                    "grad_norms": [g["grad_norm"] for g in train],
                    "launches": train[0]["launches"],
                    "step_ms_gloo": [g["step_ms_gloo"] for g in train],
                    "peak_gib": [g["peak_gib"] for g in train]}
    return row


def tp_report_families(outs: list[dict]) -> dict:
    """slice 14's checks across the processes' results, printed; its part
    of the phase's row."""
    from repro_torch.configs import get
    row = {"smoke_modes": outs[0]["modes"]}
    for mode, got in outs[0]["modes"].items():
        calls = [[tuple(c) for c in o["modes"][mode]["flash_calls"]]
                 for o in outs]
        n = TP_MODE_PROMPT // TP_MODEL
        ok = all(c[1] == 3 for cs in calls for c in cs) and (
            all(c[2] == 0 for cs in calls for c in cs) if mode == "batch"
            else all((n, 3, r * n) in cs for r, cs in enumerate(calls)))
        if not ok:
            fail(f"tp mode {mode}: flash calls (q rows, heads, q_offset) "
                 f"{calls}: every head, and in 'cp' each process's block of "
                 f"{n} positions at its offset")
        print(f"tp smoke llama3.2-3b 3 heads (f32) in {mode!r} mode, "
              f"{TP_MODE_BATCH[mode]} rows of {TP_MODE_PROMPT}, on data 1 x "
              f"model 2 against one device: {json.dumps(got)}; flash calls "
              f"(q rows, heads, q_offset) a process {calls}")
    # flash_fwd a generate a process, one a prefill attention: DeepSeek's
    # layers, Whisper's encoder layers (its 416-token decoder prefill takes
    # the direct path), the VLM's layers and its cross-attention (one a
    # unit of five)
    depth = {arch: cell[2] for arch, cell in TP_FAMILY_CELLS.items()}
    cut_layers = {"deepseek-moe-16b": depth["deepseek-moe-16b"],
                  "whisper-large-v3": get("whisper-large-v3").enc_layers,
                  VLM: depth[VLM] + depth[VLM] // 5}
    for arch in TP_FAMILY_CELLS:
        rows = [o["families"][arch] for o in outs]
        cfg = get(arch)
        want_heads = {"deepseek-moe-16b": [[8, 8]],
                      "whisper-large-v3": [[10, 10]], VLM: [[32, 4]]}[arch]
        for r, got in enumerate(rows):
            n = cut_layers[arch]
            if got["launches"]["flash_fwd"] != n or got["kernel_calls"] != n:
                fail(f"tp {arch}: process {r} launched flash_fwd "
                     f"{got['launches']['flash_fwd']} times a generate "
                     f"({got['kernel_calls']} calls), not {n}")
            if [list(x) for x in got["heads"]] != want_heads:
                fail(f"tp {arch}: process {r} ran flash_fwd at heads "
                     f"{got['heads']}, not {want_heads}")
        if rows[0]["tokens"] != rows[1]["tokens"]:
            fail(f"tp {arch}: the processes returned other tokens")
        err = max(g["consistency"][0] for g in rows)
        top = max(g["consistency"][1] for g in rows)
        limit = CONSISTENCY_BF16_RTOL[arch]
        plen, (clen, steps), _ = TP_FAMILY_CELLS[arch]
        picks = (f"expert picks (shares) prefill "
                 f"{json.dumps(rows[0]['picks_prefill'])}, a decode step "
                 f"{json.dumps(rows[0]['picks_decode_step'])}; "
                 if "picks_prefill" in rows[0] else "")
        print(f"tp {arch} bf16 at {rows[0]['layers']} of {cfg.n_layers} "
              f"layers on data 1 x model 2: prefill logits within "
              f"{rows[0]['logit_err']:.4g} of one device's (limit "
              f"{TP_FAMILY_LOGIT_RTOL[arch]:.4g}); "
              + (f"f32 at {TP_FAMILY_F32_CUT[arch][0]} layers, prefill "
                 f"{TP_FAMILY_F32_CUT[arch][1]} + {TP_FAMILY_F32_CUT[arch][2]}"
                 f" decode steps, within {rows[0]['f32_cut_err']:.4g} of one "
                 f"device's (limit {TP_LOGIT_RTOL:.4g}); "
                 if "f32_cut_err" in rows[0] else "")
              + f"consistency prefill {clen} vs "
              f"prefill {clen - steps} + {steps} decode steps: {err:.4g} of "
              f"max|logits| {top:.4g} (limit {limit * top:.4g}; "
              f"{rows[0]['consistency_ms_gloo']:.0f} ms); {picks}launches a "
              f"generate a process {json.dumps(rows[0]['launches'])}; heads "
              f"{rows[0]['heads']}; gloo through the host: generate prefill "
              f"{rows[0]['generate_prefill_ms_gloo']:.1f} ms, decode "
              f"{rows[0]['generate_decode_ms_gloo']:.1f} ms; peak GiB "
              f"{[g['peak_gib'] for g in rows]} ({CARD})")
        if not err <= limit * top:
            fail(f"tp {arch}: prefill/decode consistency {err} > {limit} * "
                 f"{top}")
        row[arch] = {k: [g[k] for g in rows if k in g] for k in
                     ("consistency_ms_gloo", "generate_prefill_ms_gloo",
                      "generate_decode_ms_gloo", "peak_gib")}
        row[arch].update(logit_err=rows[0]["logit_err"],
                         consistency=(err, top), layers=rows[0]["layers"],
                         launches=rows[0]["launches"],
                         heads=rows[0]["heads"],
                         **{k: rows[0][k] for k in ("picks_prefill",
                                                    "picks_decode_step")
                            if k in rows[0]})
    train = [o["moe_train"] for o in outs]
    one_loss, one_norm = train[0]["one_device"]
    for r, got in enumerate(train):
        n = DEEPSEEK_TRAIN_LAYERS
        if got["launches"]["flash_fwd"] != 2 * n or \
                got["launches"]["flash_bwd"] != n:
            fail(f"tp train deepseek: process {r} launched "
                 f"{got['launches']}, not {2 * n}/{n} flash_fwd/flash_bwd")
        if not abs(got["loss"] - one_loss) <= TP_BF16_LOSS_RTOL * one_loss:
            fail(f"tp train deepseek: process {r}'s loss {got['loss']} "
                 f"against one device's {one_loss}")
        if not abs(got["grad_norm"] - one_norm) <= \
                TP_BF16_GRAD_NORM_RTOL * one_norm:
            fail(f"tp train deepseek: process {r}'s reduced-gradient norm "
                 f"{got['grad_norm']} against one device's {one_norm}")
    print(f"tp train DeepSeek-MoE 16B at {DEEPSEEK_TRAIN_LAYERS} layers, 4 x "
          f"2048 bf16 on data 1 x model 2 (32 experts a process): losses "
          f"{[g['loss'] for g in train]} against one device's {one_loss} "
          f"(limit {TP_BF16_LOSS_RTOL:.4g} relative); reduced-gradient norms "
          f"{[g['grad_norm'] for g in train]} against {one_norm} (limit "
          f"{TP_BF16_GRAD_NORM_RTOL:.4g} relative); launches a process "
          f"{json.dumps(train[0]['launches'])}; step ms (gloo through the "
          f"host) {[round(g['step_ms_gloo'], 1) for g in train]}; peak GiB "
          f"{[g['peak_gib'] for g in train]} ({CARD})")
    row["moe_train"] = {"losses": [g["loss"] for g in train],
                        "one_device": [one_loss, one_norm],
                        "grad_norms": [g["grad_norm"] for g in train],
                        "launches": train[0]["launches"],
                        "step_ms_gloo": [g["step_ms_gloo"] for g in train],
                        "peak_gib": [g["peak_gib"] for g in train]}
    return row


def phase_tp(dev) -> dict:
    """Slice 13: tensor parallel on two processes of the one card (a data 1
    x model 2 mesh, gloo carrying CUDA tensors): (a) the f32 smoke Llama,
    Gemma 3 and Mamba2 on the mesh against one device (prefill logits
    within 1e-4 of the largest, 8 greedy tokens equal, one train step's
    loss within 1e-5 relative and each gradient leaf within 1e-4 of its
    largest); (b) at full width, bf16, batch 4 x 2048 + 32 new tokens:
    Llama 3.2 3B and Mamba2 2.7B served on the mesh (Llama's prefill
    logits within 2^-4 of one device's, Mamba2's to its bf16 drift, its
    first layer to 2^-4 and its first 8 layers in f32 to 1e-4 through a
    prefill and 8 decode steps; a generate's flash_fwd at 12 q and 4 kv
    heads and ssd_diag at 40 heads a process, one a layer, prefill/decode
    consistency at the serve limits; since slice 16 at 14 and 32 of their
    28 and 64 layers, TP_SERVE_LAYERS), and one Llama train step (since
    slice 16 at 14 of 28 layers, TP_TRAIN_LAYERS: loss within 2^-7 and the
    reduced-gradient norm within 1e-3 of one device's, 28/14
    flash_fwd/flash_bwd a process, peak GiB a process);
    (c) a process's kernel shapes against their plain versions, timed
    beside SDPA and their bounds.  Wall times of (a) and (b) are gloo's
    through the host, not a tensor-parallel speed.

    Slice 14 adds to each: (a) the f32 smoke Whisper, VLM, DeepSeek-MoE,
    Mixtral and Jamba, and a 3-head Llama variant in the "batch" and "cp"
    modes; (b) DeepSeek-MoE 16B, Whisper large-v3 and the VLM served
    against one device (since slice 16 at 14 of 28 layers, 16 of 32
    decoder layers and one unit: TP_FAMILY_CELLS), with their consistency
    on the mesh, and a
    DeepSeek-MoE train step at 9 layers; (c) flash_fwd and flash_bwd with a
    query offset at a "cp" shape, and a process's flash_fwd at DeepSeek's
    and Whisper's heads."""
    torch.cuda.empty_cache()
    outs = tp_processes({"device": "cuda",
                         "smoke": list(TP_SMOKE) + list(TP_SMOKE_FAMILIES),
                         "serve": list(TP_CELLS),
                         "serve_layers": TP_SERVE_LAYERS, "train": True,
                         "train_layers": TP_TRAIN_LAYERS, "modes": True,
                         "families": list(TP_FAMILY_CELLS),
                         "moe_train": True},
                        ROOT / "build" / "chip_smoke" / "tp")
    row = tp_report(outs)
    step = row["train"]["launches"]
    launches = {"flash_fwd": {"generate": row["llama3.2-3b"]["launches"][
        "flash_fwd"], "train_step": step["flash_fwd"]},
        "flash_bwd": {"train_step": step["flash_bwd"]},
        "ssd_diag": {"generate": row["mamba2-2.7b"]["launches"]["ssd_diag"]}}
    cp = row["smoke_modes"]["cp"]["mesh_launches"]
    launches.update(
        cp={"flash_fwd": {"cp smoke": cp.get("flash_fwd", 0)},
            "flash_bwd": {"cp smoke": cp.get("flash_bwd", 0)}},
        families={a: {"generate": row[a]["launches"]["flash_fwd"]}
                  for a in TP_FAMILY_FLASH})
    row["kernels"] = tp_kernel_rows(dev, launches)
    return row


def phase_tp3(dev) -> dict:
    """Slice 16: a model axis of 3 on three processes of the one card
    (gloo carrying CUDA tensors), which divides neither Llama 3.2 3B's 8 kv
    heads nor its 2048 + 32 cache, nor Mamba2 2.7B's 80 SSM heads.  At full
    width, bf16, batch 4 x 2048 + 32 new tokens: both served on the mesh
    at model 2's levels (Llama's prefill logits within 2^-4 of one
    device's, Mamba2's to its bf16 drift, its first layer to 2^-4 and its
    first 8 layers in f32 to 1e-4 through a prefill and 8 decode steps;
    a generate's 28 flash_fwd at 8 q heads with one kv head each and 64
    ssd_diag at all 80 heads a process; prefill/decode consistency at the
    serve limits), one Llama train step at TP3_TRAIN_LAYERS (14 of 28
    layers: loss within 2^-7, reduced-gradient norm within 1e-3 relative of
    one device's; 28/14 flash_fwd/flash_bwd a process); then a process's kernel shapes against their plain versions,
    timed beside SDPA and their bounds."""
    torch.cuda.empty_cache()
    outs = tp_processes({"device": "cuda", "smoke": [],
                         "serve": list(TP_CELLS), "train": True,
                         "train_layers": TP3_TRAIN_LAYERS, "modes": False,
                         "families": [], "moe_train": False},
                        ROOT / "build" / "chip_smoke" / "tp3", TP3_MODEL)
    row = tp_report_serve(outs)
    step = row["train"]["launches"]
    gen = torch.Generator(device=dev).manual_seed(17)
    b, s, h, g, d = (TP3_FLASH[k] for k in "bshgd")
    rows = tp_flash_rows(dev, gen, [
        ("tp3 llama3.2-3b", (b, s, s, h, g, d, True, 0),
         {"generate": row["llama3.2-3b"]["launches"]["flash_fwd"],
          "train_step": step["flash_fwd"]},
         {"train_step": step["flash_bwd"]})])
    rows.append(tp_ssd_row(dev, gen, TP3_SSD, {
        "generate": row["mamba2-2.7b"]["launches"]["ssd_diag"]},
        "tp3 mamba2-2.7b"))
    for r in rows:
        print(f"tp3 timing {r['name']} at {r['cell']}'s process shape "
              f"{json.dumps(r['shape'])}: kernel {r['ms']:.4f} ms, library "
              f"{r['library_ms']}, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); launches "
              f"{json.dumps(r['launches'])} ({CARD})")
    row["kernels"] = rows
    return row


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
    constants = phase_constants(dev)
    launches, res = phase_main_path(dev)
    phase_profile(res)
    phase_per_rank_seeds(res)
    proxy = phase_flavors_and_noise(dev, res)
    t0 = time.perf_counter()
    mesh = phase_mesh(dev, res)
    mesh["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"mesh": mesh}))
    del res
    t0 = time.perf_counter()
    baselines = phase_baselines(dev)
    baselines["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"constants": constants, "proxy": proxy,
                      "baselines": baselines}))
    serve = {arch: phase_serve(dev, arch) for arch in SERVE_CELLS}
    launches["flash_fwd"] = serve["llama3.2-3b"]["launches"]
    launches["ssd_diag"] = serve["mamba2-2.7b"]["launches"]
    print(json.dumps({"serve": serve}))
    phase_smoke_configs(dev)
    rows = phase_timings(dev, launches, errs)
    train, bwd = phase_train(dev, errs)
    print(json.dumps({"train": train}))
    t0 = time.perf_counter()
    dp_train = phase_dp_train(dev)
    dp_train["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"dp_train": dp_train}))
    t0 = time.perf_counter()
    tp = phase_tp(dev)
    tp["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"tp": tp}))
    t0 = time.perf_counter()
    tp3 = phase_tp3(dev)
    tp3["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"tp3": tp3}))
    print(json.dumps({"shapes": phase_shape_timings(dev, errs, serve,
                                                     train)}))
    t0 = time.perf_counter()
    trace = phase_trace(dev)
    trace["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"trace": trace}))
    t0 = time.perf_counter()
    dry = phase_dryrun(train)
    dry["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"dryrun": dry}))
    t0 = time.perf_counter()
    corpus = phase_corpus(dev)
    corpus["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"corpus": corpus}))
    t0 = time.perf_counter()
    examples = phase_examples()
    print(json.dumps({"examples": examples,
                      "phase_s": time.perf_counter() - t0}))
    rows.append({"name": "flash_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/"
                           "backward.cu",
                 # no TPU kernel: the reference's backward is an XLA custom
                 # VJP; the Pallas forward it pairs with
                 "replaces": "src/repro/models/flash.py:219",
                 "launches": train["llama3.2-3b"]["launches"]["flash_bwd"],
                 "max_abs_err": errs["flash_bwd"], **bwd})
    ssd = train["mamba2-2.7b"]["ssd_backward_check"]
    rows.append({"name": "ssd_diag_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/ssd/backward.cu",
                 # no TPU kernel: the reference differentiates the diagonal
                 # block's XLA einsums
                 "replaces": "src/repro/models/ssm.py:100",
                 "launches": train["mamba2-2.7b"]["launches"]["ssd_diag_bwd"],
                 "max_abs_err": ssd["max_abs_err"],
                 "worst_excess": ssd["worst_excess"], "ms": ssd["kernel"],
                 "plain_ms": ssd["plain"], "bound_ms": ssd["bound_ms"],
                 "bound_by": ssd["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
