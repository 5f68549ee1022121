"""End-to-end training script on the PyTorch port (the reference's
``examples/train_e2e.py``): train a qwen3-family model for a few hundred
steps with the full single-device stack — prefetching data pipeline,
AdamW, async checkpointing, crash-resume.

    PYTHONPATH=src python examples/torch_train_e2e.py [--full] [--steps 200] [--device cpu]

``--full`` trains the ~100M-parameter member (the deliverable config, on
the card); the default is the reference's ~20M member; ``--smoke`` a
2-layer member for 30 steps (the CPU test).  Asserts that the mean loss of
the last 10 steps is below that of the first 10.
"""
import argparse
import dataclasses
from pathlib import Path

import numpy as np

from repro_torch.configs import get
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig

ROOT = Path(__file__).resolve().parents[1]


def small_qwen(full: bool, smoke: bool = False):
    """--full: the ~100M-param qwen3-family member.  Default: a ~20M
    member.  --smoke: a 2-layer, 64-wide member."""
    cfg = get("qwen3-8b")
    if full:
        return dataclasses.replace(
            cfg, name="qwen3-100m", n_layers=8, d_model=512, n_heads=8,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32000,
            dtype="float32", remat=False, loss_chunk=0)
    if smoke:
        return dataclasses.replace(
            cfg, name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
            dtype="float32", remat=False, loss_chunk=0)
    return dataclasses.replace(
        cfg, name="qwen3-20m", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab=8000,
        dtype="float32", remat=False, loss_chunk=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="default 200 (30 with --smoke)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="train the ~100M config (on the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer member, 30 steps of 2 x 32 (the CPU test)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" /
                                              "torch_train_e2e_ckpt"))
    args = ap.parse_args(argv)
    steps = args.steps or (30 if args.smoke else 200)
    batch, seq = (2, 32) if args.smoke else (args.batch, args.seq)
    warmup, every = (5, 10) if args.smoke else (20, 50)

    cfg = small_qwen(args.full, args.smoke)
    print(f"model: {cfg.name}, params ~{cfg.approx_params()/1e6:.0f}M")
    tr = Trainer(cfg, None, global_batch=batch, seq_len=seq,
                 ckpt_dir=args.ckpt_dir, device=args.device,
                 opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=warmup,
                                     total_steps=steps))
    log = tr.run(steps, ckpt_every=every)
    losses = [m["loss"] for m in log]
    t_step = float(np.median([m["sec"] for m in log[5:]]))
    print(f"step time (median): {t_step*1e3:.1f} ms")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(first 10 avg {np.mean(losses[:10]):.3f}, "
          f"last 10 avg {np.mean(losses[-10:]):.3f})")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "loss did not drop"
    print("checkpoints:", tr.ckpt.all_steps())
    return log


if __name__ == "__main__":
    main()
