"""Quickstart on the PyTorch port: synthesize a proxy-app for a per-rank
torch program (the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--smoke]

Traces a halo-exchange stencil (the paper's Fig. 2 pattern) over 8 ranks:
the reference runs it under ``shard_map`` on 8 devices; here it is the same
per-rank program, written with the port's collectives and walked on meta
tensors (``trace_fn(axis_sizes={"x": 8})``), so nothing of it runs.  Then
it compresses the trace to a context-free grammar, fits basic-block
combinations to every compute segment, emits an executable proxy module,
verifies fidelity and losslessness, and replays the proxy on ``--device``
(the CUDA card by default).  ``--smoke`` runs 3 stencil iterations instead
of 12 and times one sweep.
"""
import argparse
from pathlib import Path

import torch

from repro_torch.core.synthesize import synthesize
from repro_torch.core.trace_ir import TraceStore
from repro_torch.core.tracer import scan_loop, trace_fn
from repro_torch.sharding import collectives as C

ROOT = Path(__file__).resolve().parents[1]
N = 8


def stencil(length: int):
    """``length`` iterations of: halo exchange -> compute -> global
    residual; ``u`` is one rank's (256, 128) block of the (256, 128 * N)
    field."""
    def stencil_step(u, w):
        def body(carry):
            u, w = carry
            left = C.ppermute(u[:, :1], "x",
                              [(i, (i + 1) % N) for i in range(N)])
            right = C.ppermute(u[:, -1:], "x",
                               [(i, (i - 1) % N) for i in range(N)])
            u = u + 0.1 * (left + right - 2.0 * u)
            for _ in range(3):
                u = torch.tanh(u @ w)
            residual = C.psum(torch.sum(u), "x")
            return (u, w), residual

        (u, _), rs = scan_loop(length, body, (u, w), stack_ys=True)
        return u, rs
    return stencil_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="3 iterations, one timed sweep (the CPU test)")
    ap.add_argument("--out-dir", default=str(ROOT / "build" / "proxies"))
    args = ap.parse_args(argv)
    length, iters = (3, 1) if args.smoke else (12, 3)

    u = torch.ones((256, 128))
    w = torch.ones((128, 128)) * 0.01
    trace = trace_fn(stencil(length), u, w, axis_sizes={"x": N})
    store = TraceStore.from_template(trace, {"x": N})
    result = synthesize(store=store, name="stencil_proxy",
                        out_dir=args.out_dir, device=args.device)
    print("=== synthesis stats ===")
    for k, v in result.stats.items():
        print(f"  {k}: {v}")

    fid = result.fidelity()
    print("\n=== fidelity (paper Table 3 columns) ===")
    print("  comm lossless:", fid.comm_lossless)
    print(f"  mean relative error: {fid.mean:.4f}")
    print(fid.heatmap_csv())

    print("\n=== replaying all ranks (batched by signature group) ===")
    states = result.proxy.run_all()
    n_groups = len(result.proxy.signature_groups())
    print(f"  {len(states)} ranks replayed in {n_groups} signature group(s)")
    t_batched = result.proxy.time_all(iters=iters)
    t_per_rank = result.proxy.time_all(iters=iters, batched=False)
    print(f"  full sweep: batched {t_batched*1e3:.2f} ms"
          f" vs per-rank {t_per_rank*1e3:.2f} ms"
          f" ({t_per_rank / max(t_batched, 1e-12):.1f}x)")
    print(f"  single-rank replay: "
          f"{result.proxy.time_local(0, iters=iters)*1e3:.2f} ms")
    print(f"\ngenerated proxy source: {result.proxy.module.__proxy_path__}")
    return result, fid


if __name__ == "__main__":
    main()
