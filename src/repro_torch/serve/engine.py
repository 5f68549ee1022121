"""Batched serving engine: prefill → KV/SSM caches → greedy decode loop.

The port of ``src/repro/serve/engine.py``.  A fixed pool of batch slots
decodes in lockstep; finished sequences are masked (kept numerically live)
and harvested at the end.  Eager PyTorch: the reference's two jitted steps
are plain calls here, and the decode cache is updated in place.  The
engine runs on the CUDA card unless the caller asks for another device.

``ServeEngine(cfg, params, mesh)`` serves SPMD on a ``DeviceMesh``: every
process of the mesh builds the engine with its blocks of the parameters
(``model.init_params(mesh=)``) and calls :meth:`ServeEngine.generate` with
the same prompts.  Each process serves its rows of the batch (the
``batch`` spec, declared to the model's SPMD context, which reads the
global batch from it), prefill's K/V are re-homed into the decode buffers
as ``registry.cache_specs`` lays them out (sequence-split, or whole where
the ``model`` axis does not divide a cache's length), the greedy token
is the argmax over the vocab blocks with ``jnp.argmax``'s tie rule (the
lowest index wins), and every process returns the whole batch's tokens.
Every family runs so.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import torch_dtype, tree_map
from repro_torch.models.model import (
    abstract_cache, build_forward, cache_logical_axes, init_cache,
)
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import (
    entry_axes, gather_full, local_shard, sharding_for_shape,
)


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
    def __init__(self, cfg: ArchConfig, params, mesh=None, *, device=None,
                 max_len: int = 128, eos_id: int = -1):
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from repro_torch.configs.registry import rules_for
            from repro_torch.launch.mesh import mesh_device, mesh_groups
            self.device = mesh_device(mesh)
            if device is not None and torch.device(device).type != \
                    self.device.type:
                raise ValueError(f"device {device} on a mesh of "
                                 f"{self.device.type} tensors")
            self.ctx = spmd.context(mesh, cfg)
            self.rules = rules_for(cfg)
            self._everyone = mesh_groups(mesh).group(
                tuple(str(a) for a in mesh.mesh_dim_names))[0]
        self.max_len = max_len
        self.eos_id = eos_id
        self.timers = StageTimers("prefill", "decode")
        self._prefill = build_forward(cfg, "prefill")
        self._decode = build_forward(cfg, "decode")

    def _extras(self, batch_size: int) -> dict:
        """The modality stubs the reference's engine feeds, zeros in the
        config's dtype: the VLM's vision embeddings (b, n_vision_tokens, d)
        and the encoder-decoder's audio frames (b, n_audio_frames, d)."""
        out = {}
        if self.cfg.n_vision_tokens:
            out["vision_embeds"] = torch.zeros(
                (batch_size, self.cfg.n_vision_tokens, self.cfg.d_model),
                dtype=torch_dtype(self.cfg.dtype), device=self.device)
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
        if self.mesh is None or self.ctx is None:
            return self._generate(prompts, n_new)
        spec = self._spec(np.shape(prompts))
        with self.ctx.rows(entry_axes(spec[0] if spec else None)):
            return self._generate(prompts, n_new)

    def _generate(self, prompts: np.ndarray, n_new: int) -> GenResult:
        b, plen = prompts.shape
        if plen + n_new > self.max_len:
            raise ValueError(f"prompt {plen} + {n_new} new tokens exceeds the "
                             f"engine's max_len {self.max_len}")
        prompts = np.asarray(prompts)
        rows = b
        if self.mesh is not None:      # this process's rows of the batch
            prompts = local_shard(prompts, self._spec((b, plen)), self.mesh)
            rows = prompts.shape[0]
        tokens = torch.as_tensor(np.ascontiguousarray(prompts),
                                 dtype=torch.int32, device=self.device)
        mesh_args = () if self.mesh is None else (self.mesh,)

        self._sync()
        t0 = time.perf_counter()
        batch = {"tokens": tokens, **self._extras(rows)}
        logits, pre_cache = self._prefill(self.params, batch, self.cfg,
                                          *mesh_args)
        self._sync()
        t1 = time.perf_counter()

        cache = self.decode_cache(pre_cache, b)
        del pre_cache

        tok = self._argmax(logits)
        out = [tok.cpu().numpy()]
        done = np.zeros((rows,), bool)
        for i in range(n_new - 1):
            logits, cache = self._decode(self.params, cache,
                                         {"tokens": tok[:, None]}, plen + i,
                                         self.cfg, *mesh_args)
            tok = self._argmax(logits)
            t_np = tok.cpu().numpy()
            if self.eos_id >= 0:
                done |= t_np == self.eos_id
                t_np = np.where(done, self.eos_id, t_np)
            out.append(t_np)
            if self._all_done(done):
                break
        self._sync()
        t2 = time.perf_counter()
        self.timers._acc["prefill"] += t1 - t0
        self.timers._acc["decode"] += t2 - t1
        gen = np.stack(out, axis=1)
        if self.mesh is not None:      # every process: the whole batch's
            gen = gather_full(torch.from_numpy(gen), self._spec(
                (b, gen.shape[1])), self.mesh).numpy()
        return GenResult(tokens=gen, prefill_sec=t1 - t0, decode_sec=t2 - t1,
                         tokens_per_sec=gen.size / max(t2 - t1, 1e-9))

    def decode_cache(self, pre_cache, batch_size: int):
        """Prefill's cache re-homed into full-length (``max_len``) decode
        buffers, on a mesh this process's blocks of them
        (``batch_size``: the global batch)."""
        full = init_cache(self.cfg, batch_size, self.max_len, self.device,
                          self.cfg.n_audio_frames,
                          *(() if self.mesh is None else (self.mesh,)))
        if self.mesh is None:
            return tree_map(self._embed_cache, full, pre_cache)
        shape = (self.cfg, batch_size, self.max_len, self.cfg.n_audio_frames)
        return tree_map(self._rehome, full, pre_cache,
                        cache_logical_axes(*shape), abstract_cache(*shape))

    def _spec(self, shape):
        """The spec of a (batch, ...) array: its rows over the data axes."""
        return sharding_for_shape(tuple(shape), ("batch",) + (None,) * (
            len(shape) - 1), self.mesh, self.rules)

    def _all_done(self, done: np.ndarray) -> bool:
        """Whether every row of the batch is done (on a mesh, of every
        process's rows: they stop together)."""
        if self.mesh is None or self.eos_id < 0:
            return bool(done.all())
        left = torch.tensor([int((~done).sum())], device=self.device)
        dist.all_reduce(left, dist.ReduceOp.SUM, group=self._everyone)
        return int(left) == 0

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token of each row: over the vocab blocks of a mesh,
        the largest value, the lowest index among equals (``jnp.argmax``'s
        rule: each block's first maximum, then the first block that holds
        the largest)."""
        if self.mesh is None or self.ctx is None or logits.shape[-1] == \
                self.cfg.padded_vocab:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        val, idx = torch.max(logits, dim=-1)
        lo = self.ctx.block()[0] * logits.shape[-1]
        vals = self.ctx.all_gather(val.float()[None], 0)      # (blocks, b)
        idxs = self.ctx.all_gather((idx + lo)[None], 0)
        first = (vals == vals.amax(dim=0, keepdim=True)).int().argmax(dim=0)
        return torch.gather(idxs, 0, first[None])[0].to(torch.int32)

    def _rehome(self, full: torch.Tensor, pre: torch.Tensor, axes,
                whole: torch.Tensor) -> torch.Tensor:
        """:meth:`_embed_cache` on a mesh: prefill's K/V (this process's kv
        heads, every position) into this process's decode block (every kv
        head; its positions, where the leaf's spec, from its global shape
        ``whole``, splits them over ``model``); an SSM leaf has one layout
        in both."""
        if "kv_seq" not in axes:
            return pre.to(full.dtype)
        heads, seq = axes.index("kv_heads"), axes.index("kv_seq")
        if pre.shape[heads] != full.shape[heads]:
            pre = self.ctx.all_gather(pre, heads)
        tl = full.shape[seq]
        spec = sharding_for_shape(tuple(whole.shape), axes, self.mesh,
                                  self.rules)
        split = "model" in entry_axes(spec[seq] if seq < len(spec) else None)
        lo = tl * self.ctx.r if self.ctx is not None and split else 0
        n = max(0, min(tl, pre.shape[seq] - lo))
        if n:
            full.narrow(seq, 0, n).copy_(pre.narrow(seq, lo, n))
        return full

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

