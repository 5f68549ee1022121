"""Traffic kind ``prefill``: a closed-loop prefill pool.  Batches of one
prompt length fill a budget of prompt tokens; each batch is served by
``ServeEngine.generate(prompts, n_new)``, one engine a length over the same
weights with ``max_len`` the length plus ``n_new``, as a deployment sizes
its buckets.  The mix's file gives the budget and a round: how many batches
of each length it holds.  Every seed serves the same rounds, each in an
order drawn from the seed, with prompts of Zipf tokens from the
benchmark's copy of ``TokenDataset``; the window ends at the first round's
end after ``--seconds``.

``prefill_tokens_per_s`` is every prompt token of the window over its wall
time.  Set-up serves one batch of each length, so nothing is first run
inside the window.  Once the window has closed and the program's state is
freed, the plain reference runs the prompts of a sample of the window's
batches, drawn from the seed with some of every length, and judges every
request in them: the widest served-token gap, the widest logit error, and
the worst over the lengths of the median logit error within a length.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import verdict, weights
from bench.data import TokenDataset
from bench.harness import Run, window
from bench.reference import common


def round_lengths(tr: dict) -> list[int]:
    """One round's batches, by prompt length, in a fixed order."""
    return [int(L) for L, n in sorted(tr["round"].items(),
                                      key=lambda kv: int(kv[0]))
            for _ in range(n)]


def round_order(tr: dict, seed: int, k: int) -> list[int]:
    """Round ``k``'s batches in the order the seed draws."""
    lengths = round_lengths(tr)
    rng = np.random.RandomState((seed * 7_919 + k) % 2 ** 31)
    return [lengths[i] for i in rng.permutation(len(lengths))]


def prompts(tr: dict, vocab: int, seed: int, length: int, index: int):
    rows = tr["token_budget"] // length
    return TokenDataset(vocab, length, rows, seed,
                        tr["zipf_a"]).batch_at(index)["tokens"]


def check_sample(tr: dict, checks: dict, seed: int, batches: list) -> list:
    """Indices of the window's batches the reference judges: for each
    length, the number ``checks`` asks for, drawn from the seed."""
    rng = np.random.RandomState((seed * 104_729 + 1) % 2 ** 31)
    out = []
    for L, n in sorted(checks["check_batches"].items(),
                       key=lambda kv: int(kv[0])):
        of_len = [i for i, b in enumerate(batches) if b["length"] == int(L)]
        out += sorted(rng.choice(of_len, size=min(n, len(of_len)),
                                 replace=False).tolist())
    return out


def run(r: Run) -> None:
    from repro_torch.serve.engine import ServeEngine
    tr, vocab = r.traffic, r.sizes["vocab"]
    n_new = tr["n_new"]
    params = weights.make(r.family.param_specs(r.sizes), r.seed, r.device)
    engines, kept = {}, []
    max_len = max(int(x) for x in tr["round"])
    for L in sorted({int(x) for x in tr["round"]}):
        eng = ServeEngine(r.cfg, params, device=r.device, max_len=L + n_new)
        inner = eng._prefill
        scale = 1.25 if r.fault == "long_logits" and L == max_len else None

        def keep(*args, _inner=inner, _scale=scale):
            logits, cache = _inner(*args)
            if _scale is not None:      # a wrong logit, the same argmax
                logits = logits * _scale
            kept.append(logits)
            return logits, cache

        eng._prefill = keep
        if r.fault == "token":
            argmax = eng._argmax
            eng._argmax = lambda lg, _a=argmax: (_a(lg) + 1) % lg.shape[-1]
        elif r.fault not in (None, "long_logits"):
            raise ValueError(f"no fault {r.fault!r} for a prefill cell")
        engines[L] = eng
    for L, eng in engines.items():           # every shape once
        eng.generate(prompts(tr, vocab, r.seed, L, -1 - L), n_new)
    kept.clear()
    r.setup_done()

    batches = []

    def unit():
        for L in round_order(tr, r.seed, len(batches)):
            toks = prompts(tr, vocab, r.seed, L, len(batches))
            t = time.perf_counter()
            with torch.profiler.record_function("bench.generate"):
                res = engines[L].generate(toks, n_new)
            batches.append({"length": L, "rows": toks.shape[0],
                            "seconds": time.perf_counter() - t,
                            "index": len(batches), "served": res.tokens[:, 0]})

    wall = window(r, unit, 1)
    n_tokens = sum(b["length"] * b["rows"] for b in batches)
    r.values["prefill_tokens_per_s"] = n_tokens / wall
    r.attempted = sum(b["rows"] for b in batches)
    served = np.concatenate([b["served"] for b in batches])
    r.failed = int(((served < 0) | (served >= r.cfg.padded_vocab)).sum())
    r.info.update(batches=[(b["length"], b["rows"], b["seconds"])
                           for b in batches])
    r.read_peak()
    sample = check_sample(tr, r.checks, r.seed, batches)
    prog_logits = [kept[i] for i in sample]
    del engines, params, kept
    r.free()
    toks = [prompts(tr, vocab, r.seed, batches[i]["length"], i)
            for i in sample]
    ref_last = torch.cat(reference_logits(r, toks))
    served = np.concatenate([batches[i]["served"] for i in sample])
    lengths = torch.tensor([batches[i]["length"] for i in sample
                            for _ in range(batches[i]["rows"])])
    r.info.update(check_tokens=toks, ref_logits=ref_last,
                  check_lengths=lengths)
    r.compare(numbers(torch.cat(prog_logits), ref_last, served, lengths,
                      r.info))


def numbers(logits, ref_last, served, lengths, info: dict) -> dict:
    """The compared numbers of the checked requests (last-position
    ``logits`` and ``served`` tokens against the reference's ``ref_last``,
    each request of prompt length ``lengths``), with the per-length medians
    as readings; the logit error's quantiles go to ``info``."""
    err = verdict.logit_errors(logits, ref_last)
    info["logit_err_quantiles"] = [float(x) for x in torch.quantile(
        err, torch.tensor([0.1, 0.25, 0.5, 0.75, 0.9], device=err.device))]
    by_len = verdict.median_by_group(err, lengths)
    return {
        "token_gap": float(verdict.token_gaps(ref_last, served).max()),
        "logit_err": float(err.max()),
        "logit_err_len_median": verdict.worst(by_len.values()),
        **{f"logit_err_median_{L}": v for L, v in by_len.items()},
    }


def reference_hidden(r: Run, token_batches, num=common.F32):
    """The reference's final-normed hidden states of each batch, from the
    seeded weights drawn again."""
    tree = weights.make(r.family.param_specs(r.sizes), r.seed, r.device)
    toks = [torch.as_tensor(t, device=r.device) for t in token_batches]
    with common.exact_f32():
        hs = common.final_hidden(r.family, r.sizes, tree, toks, num)
    return tree, hs


def reference_logits(r: Run, token_batches, num=common.F32) -> list:
    """The reference's last-position logits (rows, padded vocab) of each
    batch."""
    tree, hs = reference_hidden(r, token_batches, num)
    with common.exact_f32(), torch.no_grad():
        out = [common.lm_logits(h[:, -1], tree, num) for h in hs]
    del tree, hs
    r.free()
    return out
