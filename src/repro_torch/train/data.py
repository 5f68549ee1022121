"""Deterministic synthetic LM data pipeline with host prefetch.

A copy of ``src/repro/train/data.py`` (numpy and threads, no JAX): the
port imports nothing of the reference, so it keeps its own.

Real deployments swap :class:`TokenDataset` for a storage-backed reader; the
contract the trainer relies on is (a) deterministic batches given (seed,
step) — so checkpoint-restart resumes on the exact same stream — and (b) a
background prefetch thread so a slow host never stalls the device step
(the practical straggler-mitigation lever for bulk-synchronous SPMD).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

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

    def extras(self, cfg) -> dict[str, np.ndarray]:
        """Stub modality embeddings (VLM patches / audio frames)."""
        out = {}
        rng = np.random.RandomState(self.seed)
        if getattr(cfg, "n_vision_tokens", 0):
            out["vision_embeds"] = rng.normal(
                0, 1, (self.global_batch, cfg.n_vision_tokens, cfg.d_model)
            ).astype(np.float32)
        if getattr(cfg, "n_audio_frames", 0):
            out["audio_frames"] = rng.normal(
                0, 1, (self.global_batch, cfg.n_audio_frames, cfg.d_model)
            ).astype(np.float32)
        return out


class Prefetcher:
    """Background thread materializing batches ``depth`` steps ahead."""

    def __init__(self, ds: TokenDataset, start_step: int = 0, depth: int = 2,
                 extras: dict | None = None):
        self.ds = ds
        self.extras = extras or {}
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.ds.batch_at(step)
            batch.update(self.extras)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
