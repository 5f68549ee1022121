"""Batched serving engine: prefill → KV/SSM caches → greedy decode loop.

The port of ``src/repro/serve/engine.py``.  A fixed pool of batch slots
decodes in lockstep; finished sequences are masked (kept numerically live)
and harvested at the end.  Eager PyTorch: the reference's two jitted steps
are plain calls here, and the decode cache is updated in place.  The
engine runs on the CUDA card unless the caller asks for another device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import torch_dtype, tree_map
from repro_torch.models.model import build_forward, init_cache


class StageTimers:
    """Per-stage wall-clock accumulators (a copy of the reference's).
    ``time(stage)`` is a context manager; :meth:`snapshot_ms` renders
    ``{stage}_ms`` keys for a stats dict or a benchmark row."""

    def __init__(self, *stages: str):
        self._acc = {s: 0.0 for s in stages}

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[stage] += time.perf_counter() - t0

    def snapshot_ms(self) -> dict[str, float]:
        return {f"{s}_ms": round(v * 1e3, 3) for s, v in self._acc.items()}


@dataclasses.dataclass
class GenResult:
    tokens: np.ndarray          # (b, n_new)
    prefill_sec: float
    decode_sec: float
    tokens_per_sec: float


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, device=None,
                 max_len: int = 128, eos_id: int = -1):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_len = max_len
        self.eos_id = eos_id
        self.timers = StageTimers("prefill", "decode")
        self._prefill = build_forward(cfg, "prefill")
        self._decode = build_forward(cfg, "decode")

    def _extras(self, batch_size: int) -> dict:
        """The modality stubs the reference's engine feeds: zero audio
        frames (b, n_audio_frames, d) in the config's dtype."""
        out = {}
        if self.cfg.n_audio_frames:
            out["audio_frames"] = torch.zeros(
                (batch_size, self.cfg.n_audio_frames, self.cfg.d_model),
                dtype=torch_dtype(self.cfg.dtype), device=self.device)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int) -> GenResult:
        """prompts: (b, prompt_len) int32 (already padded to a bucket)."""
        b, plen = prompts.shape
        if plen + n_new > self.max_len:
            raise ValueError(f"prompt {plen} + {n_new} new tokens exceeds the "
                             f"engine's max_len {self.max_len}")
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                 device=self.device)

        self._sync()
        t0 = time.perf_counter()
        batch = {"tokens": tokens, **self._extras(b)}
        logits, pre_cache = self._prefill(self.params, batch, self.cfg)
        self._sync()
        t1 = time.perf_counter()

        # re-home the prefill cache into full-length decode buffers
        full = init_cache(self.cfg, b, self.max_len, self.device,
                          self.cfg.n_audio_frames)
        cache = tree_map(self._embed_cache, full, pre_cache)
        del pre_cache

        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok.cpu().numpy()]
        done = np.zeros((b,), bool)
        for i in range(n_new - 1):
            logits, cache = self._decode(self.params, cache,
                                         {"tokens": tok[:, None]}, plen + i,
                                         self.cfg)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            t_np = tok.cpu().numpy()
            if self.eos_id >= 0:
                done |= t_np == self.eos_id
                t_np = np.where(done, self.eos_id, t_np)
            out.append(t_np)
            if done.all():
                break
        self._sync()
        t2 = time.perf_counter()
        self.timers._acc["prefill"] += t1 - t0
        self.timers._acc["decode"] += t2 - t1
        gen = np.stack(out, axis=1)
        return GenResult(tokens=gen, prefill_sec=t1 - t0, decode_sec=t2 - t1,
                         tokens_per_sec=gen.size / max(t2 - t1, 1e-9))

    @staticmethod
    def _embed_cache(full_leaf: torch.Tensor, pre_leaf: torch.Tensor
                     ) -> torch.Tensor:
        """Place a prefill cache leaf into the front of the full-length
        buffer (matching trailing dims; the sequence axis is wherever the
        shapes differ)."""
        if full_leaf.shape == pre_leaf.shape:
            return pre_leaf.to(full_leaf.dtype)
        axis = next(i for i, (a, b) in enumerate(zip(full_leaf.shape,
                                                     pre_leaf.shape)) if a != b)
        full_leaf.narrow(axis, 0, pre_leaf.shape[axis]).copy_(pre_leaf)
        return full_leaf

