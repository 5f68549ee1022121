"""The output check's readings for setting its limits, on the card at the
cell's own size (the benchmark's own runs never run this):

    python3 bench/control.py --workload <cell> --seeds 1,2,3

For each seed of ``--seeds``, one JSON line with the compared numbers of
the program (``sound``) and of the control: the plain reference put in the
program's place and computed in fp8 (e4m3, the precision below the
configuration's bf16).  Each set of numbers is judged as a run's is, by
``Run.compare`` and ``Run.correct`` against ``checks/<cell>.json``: the
line's ``<name>_correct`` is the verdict a run reading those numbers would
print.  A training cell also reads its planted fault, half of the batch
left out (``half_batch``); a prefill cell also reads the control's widest
gap at every position of the checked prompts (``control_all_positions``).
``--witness <layers>`` (prefill cells) reads, on each seed of ``--seeds``,
the program computing in f32 at that depth against the reference: a second
witness of what the bf16 program's readings owe to rounding.  ``--fault
token`` (prefill cells) reads the program with a served token altered where
it is produced, ``--fault long_logits`` with the longest prompts' logits
scaled by 1.25 (their argmax kept).  Lines also go to
``chiprun_out/control_<cell>.jsonl``.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def judged(r, values: dict) -> dict:
    """``values`` judged as run ``r``'s own numbers would be: through
    ``Run.compare`` and ``Run.correct``, against the cell's limits."""
    j = copy.copy(r)
    j.numbers, j.info = {}, {}
    j.setup_s = j.setup_s or 0.0
    j.compare(values)
    return {"correct": j.correct(),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in j.numbers.items()}}


def train_readings(workload: str, seed: int, control: bool) -> dict:
    from bench import verdict
    from bench.drivers import train
    from bench.harness import Run
    from bench.reference import common
    r = Run(workload, seed, 0.0, False)
    n, b1 = r.traffic["check_steps"], r.traffic["optimizer"]["b1"]
    out, prog = {}, {}
    for fault in (None, "half_batch") if control else (None,):
        r.fault = fault
        step, params, opt, ds = train.build(r)
        params, opt, prog[fault] = train.program_readings(
            r, step, params, opt, ds, n, b1)
        del step, params, opt
        r.free()
    ref = train.reference_readings(r, ds, n)
    out["sound"] = verdict.train_numbers(prog[None], ref)
    out["sound_correct"] = judged(r, out["sound"])["correct"]
    out["worst"] = {k: verdict.worst_slices(prog[None][k], ref[k])
                    for k in ("grad1", "change")}
    out["steps"] = {"program": {k: prog[None][k] for k in
                                ("loss", "grad_norm")},
                    "reference": {k: ref[k] for k in ("loss", "grad_norm")}}
    if control:
        out["half_batch"] = verdict.train_numbers(prog["half_batch"], ref)
        out["half_batch_correct"] = judged(r, out["half_batch"])["correct"]
        fp8 = train.reference_readings(r, ds, n, common.Numerics(True))
        out["control"] = verdict.train_numbers(fp8, ref)
        out["control_correct"] = judged(r, out["control"])["correct"]
    return out


def prefill_readings(workload: str, seed: int, control: bool,
                     cfg_cut=None, fault=None) -> dict:
    import torch

    from bench import verdict
    from bench.drivers import prefill
    from bench.harness import Run
    from bench.reference import common
    r = Run(workload, seed, 1e-3, False, cfg_cut=cfg_cut, fault=fault)
    prefill.run(r)
    out = {"sound": r.info["readings"],
           "sound_quantiles": r.info["logit_err_quantiles"],
           "sound_correct": r.correct()}
    if not control:
        return out
    toks, ref = r.info["check_tokens"], r.info["ref_logits"]
    fp8 = common.Numerics(True)
    last = torch.cat(prefill.reference_logits(r, toks, fp8))
    info = {}
    out["control"] = prefill.numbers(last, ref, last.argmax(1),
                                     r.info["check_lengths"], info)
    out["control_correct"] = judged(r, out["control"])["correct"]
    out["control"]["logit_err_quantiles"] = info["logit_err_quantiles"]
    tree8, h8 = prefill.reference_hidden(r, toks, fp8)
    del tree8
    tree, h32 = prefill.reference_hidden(r, toks)
    widest = 0.0
    with common.exact_f32(), torch.no_grad():
        for a, b in zip(h32, h8):
            a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
            for i in range(0, a.shape[0], 1024):
                l32 = common.lm_logits(a[i:i + 1024], tree)
                l8 = common.lm_logits(b[i:i + 1024], tree, fp8)
                widest = max(widest, float(verdict.token_gaps(
                    l32, l8.argmax(1)).max()))
    out["control_all_positions"] = {"token_gap": widest}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--fault", default=None,
                    help="read the program with a planted fault (token)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import core
    if not torch.cuda.is_available():
        print("control.py runs on the CUDA card", file=sys.stderr)
        return 2
    kind = core.traffic_file(core.cell(core.benchmark(), args.workload)[
        "traffic"])["kind"]
    read = {"train": train_readings, "prefill": prefill_readings}[kind]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    seeds = [(int(s), True) for s in args.seeds.split(",") if s]
    if args.witness:
        import dataclasses

        def cut(cfg):
            return dataclasses.replace(cfg, dtype="float32",
                                       n_layers=args.witness)
        seeds = [(s, "witness") for s, c in seeds if c]
    for seed, control in seeds:
        t = time.perf_counter()
        if control == "witness":
            got = read(args.workload, seed, False, cut)
        elif args.fault:
            got = read(args.workload, seed, False, fault=args.fault)
        else:
            got = read(args.workload, seed, control)
        line = {"workload": args.workload, "seed": seed,
                "witness_f32_layers": args.witness or None, **got,
                "seconds": time.perf_counter() - t,
                "card": torch.cuda.get_device_name()}
        print(json.dumps(line), flush=True)
        with open(out_dir / f"control_{args.workload}.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
