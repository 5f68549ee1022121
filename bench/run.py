"""Run one cell of ``BENCHMARK.json`` once on the CUDA card and print the
result as the last line of standard output:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy time in the traced window and a breakdown.  Every run checks what its
timed path produced against the plain reference; each compared number and
its limit are the last lines of standard error and the ``checks`` key of
the line.  Exits non-zero, printing no result, without enough CUDA cards,
where the program is missing, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "bench" / sub))

    import torch

    from bench import core
    from bench.harness import Run, report, result

    chips = core.cell(core.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    r = Run(args.workload, args.seed, args.seconds, bool(args.trace))
    core.driver(r.traffic["kind"]).run(r)
    print(f"{args.workload} seed {args.seed}: set-up {r.setup_s:.2f} s, "
          f"window {r.window_s:.2f} s, check {r.check_s:.2f} s",
          file=sys.stderr)
    loaded = core.forbidden_loaded(sys.modules)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures repro_torch "
              "alone", file=sys.stderr)
        return 3
    report(r, result(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
