"""Heterogeneous-rank example on the PyTorch port (the reference's
``examples/pipeline_proxy.py``): a pipeline-parallel schedule traced
through the host-level TraceSession (the PMPI-interposition analog),
exercising Algorithm 1's main-rule clustering — different pipeline stages
produce different main rules, merged with rank-set branches.

    PYTHONPATH=src python examples/torch_pipeline_proxy.py [--device cpu] [--smoke]

``--smoke`` records 4 microbatches instead of 16.
"""
import argparse

import torch

from repro_torch.core.events import CommEvent, ComputeEvent
from repro_torch.core.synthesize import synthesize
from repro_torch.core.tracer import TraceSession, compute_cost

STAGES = 8
MICROBATCHES = 16


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="4 microbatches (the CPU test)")
    args = ap.parse_args(argv)
    microbatches = 4 if args.smoke else MICROBATCHES

    fwd = compute_cost(lambda a, b: torch.tanh(a @ b),
                       torch.ones((64, 512)), torch.ones((512, 512)))
    with TraceSession(n_ranks=STAGES) as sess:
        for _ in range(microbatches):
            for r in range(STAGES):
                sess.emit([r], ComputeEvent(tuple(fwd)))
                if r < STAGES - 1:
                    sess.emit([r, r + 1],
                              CommEvent("ppermute", (64, 512), "float32",
                                        ("stage",), ("shift", 1)))
        for r in range(STAGES):
            sess.emit([r], CommEvent("psum", (512, 512), "float32", ("stage",)))

    res = synthesize(rank_traces=sess.rank_streams,
                     axis_sizes={"stage": STAGES}, name="pp_proxy",
                     device=args.device)
    print("clusters:", len(res.merged.mains),
          "| cluster ranks:", [sorted(r) for r in res.merged.cluster_ranks])
    fid = res.fidelity()
    print("lossless:", fid.comm_lossless, "| mean delta:", round(fid.mean, 4))
    print("\n--- generated main rules (rank-set branches) ---")
    in_main = False
    for line in res.source.splitlines():
        if line.startswith("def main"):
            in_main = True
        if in_main:
            print(line)
        if in_main and line.strip() == "return st":
            in_main = False
    return res, fid


if __name__ == "__main__":
    main()
