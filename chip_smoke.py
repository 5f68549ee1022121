"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — synthesize → run_all → fidelity on the
64-rank synthetic trace (51,204 events) — on the card, builds the
hand-written CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version, checks that the main path went
through the kernels, and times them.  Imports nothing of JAX or of the JAX
package.  Exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.  The last line of its output is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
STATE_ATOL = 1e-4  # f32 leaves, CUDA vs CPU: see check_states


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
        for line in build.BUILD_LOG.get(str(src), "").splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {line.strip()}")
    print(f"build: {secs:.2f} s")


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


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card, same inputs."""
    import numpy as np
    from repro_torch.core import blocks
    from repro_torch.kernels.proxy_blocks import ops, ref

    rng = np.random.RandomState(0)
    errs = {}
    for reps in (1, 5, 7, 32):
        for scale in (ref.MXU_SCALE, 1.0):
            a, b = (x.to(dev, torch.bfloat16) for x in mxu_inputs(rng, scale))
            got = ops.mxu_iter(a, b, reps, scale)
            err = check_mxu(got, ref.mxu_ref(a, b, reps, scale),
                            f"reps={reps} scale={scale:g}", reps)
            if reps > 1:    # the last turn alone, at the one-turn limit
                prev = ops.mxu_iter(a, b, reps - 1, scale)
                check_mxu(got, ref.mxu_ref(prev, b, 1, scale),
                          f"reps={reps} scale={scale:g}, last turn")
            if reps == 5 and scale == 1.0:
                errs["mxu_iter"] = err
    # batched a and b (the per-rank-seeds replay)
    a, b = (x.to(dev, torch.bfloat16) for x in mxu_inputs(rng, 1.0, (3,)))
    check_mxu(ops.mxu_iter(a, b, 5, 1.0), ref.mxu_ref(a, b, 5, 1.0),
              "batched (3,128,128) reps=5", 5)
    # the main path's own inputs: init_state's b shrinks a about 20-fold a
    # turn, so its outputs are small but far from bf16's underflow at reps=5
    st = blocks.init_state(0, dev)
    check_mxu(ops.mxu_iter(st["a"], st["b"], 5, 1.0),
              ref.mxu_ref(st["a"], st["b"], 5, 1.0), "main-path state reps=5",
              5)

    for n, reps in ((2048, 3), (4096, 17), (32768, 5), (2 * 32768, 5)):
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
            if not rel <= 1e-6:
                fail(f"stream_iter disagrees with stream_ref: {rel}")
            print("  not bit-exact: within rtol 1e-6")
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


def phase_main_path(dev) -> tuple[dict, object]:
    from repro_torch.core.replay import ProxyProgram
    from repro_torch.core.synthesize import synthesize
    from repro_torch.core.trace_ir import TraceStore
    from repro_torch.kernels.proxy_blocks import ops
    from repro_torch.workloads import synthetic_rank_traces

    store = TraceStore.from_rank_traces(synthetic_rank_traces(N_RANKS),
                                        {"x": N_RANKS})
    ops.reset_counts()
    t0 = time.perf_counter()
    res = synthesize(store=store, device=dev,
                     out_dir=ROOT / "build" / "chip_smoke")
    t1 = time.perf_counter()
    states = res.proxy.run_all()
    t2 = time.perf_counter()
    fid = res.fidelity(sample_ranks=None)
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    print(f"main path: synthesize {1e3 * (t1 - t0):.1f} ms, run_all "
          f"{1e3 * (t2 - t1):.1f} ms, fidelity {1e3 * (t3 - t2):.1f} ms")
    print("main path stats: " + json.dumps(res.stats))
    print(f"main path combos: {res.proxy.combos}")
    print(f"main path: delta_bar = {fid.mean!r}, comm_lossless = "
          f"{fid.comm_lossless}")
    print(f"main path launches: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
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
    """Device busy share of one warm run_all, from torch.profiler: the
    summed time of the device's kernels over the host wall time of the
    call (the profiler itself slows the host side)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res.proxy.run_all()                  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res.proxy.run_all()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue                     # host ops carry their kernels' time too
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        rows.append((dev, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("profile run_all: device time not measured (the profiler "
              "recorded no device activity)")
        return
    print(f"profile run_all: wall {wall_us / 1e3:.1f} ms under the profiler, "
          f"device kernels {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}% "
          f"busy), {sum(r[1] for r in rows)} kernel launches")
    for dev, count, key in sorted(rows, reverse=True)[:6]:
        print(f"  {dev / 1e3:8.2f} ms  {count:6d}x  {key[:70]}")


def phase_per_rank_seeds(res) -> None:
    t0 = time.perf_counter()
    batched = res.proxy.run_all(per_rank_seeds=True)
    t1 = time.perf_counter()
    single = res.proxy.run_all(per_rank_seeds=True, batched=False)
    t2 = time.perf_counter()
    worst = check_states(batched, single, "per_rank_seeds batched vs per-rank")
    print(f"per-rank seeds: batched {1e3 * (t1 - t0):.1f} ms, per-rank "
          f"{1e3 * (t2 - t1):.1f} ms, max |diff| = {worst:.3g}")


def phase_timings(dev, launches: dict, errs: dict) -> list[dict]:
    """Kernel, plain and bound times at the main path's shapes."""
    from repro_torch.kernels.proxy_blocks import ops, ref
    from repro_torch.core import blocks

    st = blocks.init_state(0, dev)
    a, b, v = st["a"], st["b"], st["v"]
    rows = []
    table = {}
    for reps in (5, 4096):
        iters = 200 if reps == 5 else 20
        mxu_bytes = 3 * a.numel() * 2
        mxu_flops = reps * 2 * 128 ** 3
        mxu = {
            "ms": cuda_ms(lambda: ops.mxu_iter(a, b, reps, 1.0), iters),
            "plain_ms": cuda_ms(lambda: ref.mxu_ref(a, b, reps, 1.0),
                                max(iters // 10, 2)),
            "bound_ms": 1e3 * max(mxu_bytes / PEAK_BYTES,
                                  mxu_flops / PEAK_BF16_FLOPS),
            "bound_by": ("bytes" if mxu_bytes / PEAK_BYTES
                         >= mxu_flops / PEAK_BF16_FLOPS else "operations"),
            # no single PyTorch call iterates: see the reps=1 yardstick
            "library_ms": None,
        }
        st_bytes = 2 * v.numel() * 4
        st_ops = reps * 2 * v.numel()
        stream = {
            "ms": cuda_ms(lambda: ops.stream_iter(v, reps), iters),
            "plain_ms": cuda_ms(lambda: ref.stream_ref(v, reps),
                                max(iters // 10, 2)),
            "bound_ms": 1e3 * max(st_bytes / PEAK_BYTES,
                                  st_ops / PEAK_F32_FLOPS),
            "bound_by": ("bytes" if st_bytes / PEAK_BYTES
                         >= st_ops / PEAK_F32_FLOPS else "operations"),
            "library_ms": None,
        }
        table[("mxu_iter", reps)] = mxu
        table[("stream_iter", reps)] = stream
        for name, row in (("mxu_iter", mxu), ("stream_iter", stream)):
            print(f"timing {name} reps={reps}: kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} "
                  f"ms ({row['bound_by']})")
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
    print(json.dumps({"timings": {f"{n}@reps={r}": v
                                  for (n, r), v in table.items()}}))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"repro_torch not importable from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda", 0)
    device = phase_device()
    phase_build()
    errs = phase_kernels(dev)
    launches, res = phase_main_path(dev)
    phase_profile(res)
    phase_per_rank_seeds(res)
    rows = phase_timings(dev, launches, errs)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
