"""Serve a small model with batched requests on the PyTorch port, then
synthesize a proxy-app for the *prefill step* (the reference's
``examples/serve_and_proxy.py``): the Siesta pipeline applied to an
inference workload (the technique consumes any step function).

    PYTHONPATH=src python examples/torch_serve_and_proxy.py [--device cpu] [--smoke]

The prefill step is walked on meta tensors, so tracing it runs nothing.
``--smoke`` serves a 2-layer, 64-wide member: 2 requests of 8 tokens, 4
new tokens.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core.synthesize import synthesize
from repro_torch.models.model import build_forward, init_params
from repro_torch.serve.engine import ServeEngine


def small_llama(smoke: bool = False):
    cfg = get("llama3.2-3b")
    if smoke:
        return dataclasses.replace(
            cfg, name="llama-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
            dtype="float32", remat=False, loss_chunk=0)
    return dataclasses.replace(
        cfg, name="llama-60m", n_layers=6, d_model=384, n_heads=6,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab=16000,
        dtype="float32", remat=False, loss_chunk=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer member, 2 x 8 tokens (the CPU test)")
    args = ap.parse_args(argv)
    (b, plen, n_new) = (2, 8, 4) if args.smoke else (8, 32, 64)

    cfg = small_llama(args.smoke)
    params = init_params(cfg, 0, args.device)
    eng = ServeEngine(cfg, params, device=args.device, max_len=160)

    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (b, plen)).astype(np.int32)
    res = eng.generate(prompts, n_new=n_new)
    print(f"batched serve: {res.tokens.shape[0]} requests x "
          f"{res.tokens.shape[1]} new tokens")
    print(f"  prefill: {res.prefill_sec*1e3:.1f} ms, "
          f"decode: {res.decode_sec*1e3:.1f} ms, "
          f"{res.tokens_per_sec:.0f} tok/s")

    # Siesta on the serving path: trace + synthesize the prefill step
    prefill = build_forward(cfg, "prefill")
    batch = {"tokens": torch.as_tensor(prompts)}
    result = synthesize(lambda p, bt: prefill(p, bt, cfg), params, batch,
                        axis_sizes={}, name="prefill_proxy",
                        device=args.device)
    print("\nprefill proxy:")
    print("  events:", result.stats["n_events"],
          "| compression:", round(result.stats["compression_ratio"], 1), "x",
          "| fit err:", round(result.stats["mean_fit_rel_err"], 4))
    fid = result.fidelity()
    print("  fidelity mean delta:", round(fid.mean, 4))
    return res, result, fid


if __name__ == "__main__":
    main()
