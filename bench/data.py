"""The benchmark's token stream: a copy of the port's
``train/data.py::TokenDataset`` (numpy; batch i a pure function of the seed
and i), so the benchmark makes its inputs itself.  ``test_bench_pieces``
holds it to the port's bit for bit."""
from __future__ import annotations

import numpy as np


class TokenDataset:
    """Zipf-distributed token stream; batch i is a pure function of (seed, i)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.zipf_a = zipf_a

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2 ** 31)
        z = rng.zipf(self.zipf_a, size=(self.global_batch, self.seq_len + 1))
        toks = (z - 1) % self.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
