"""Model registry: one dispatch point from ArchConfig to init and serve
functions.

The port of ``src/repro/models/model.py``.  ``build_forward(cfg, kind)``
returns the training loss, the prefill or the decode step; ``init_params``
draws concrete weights on a device; ``params_from_numpy`` carries the
reference's weights across value for value.  ``init_abstract`` and
``abstract_cache`` are the reference's shape-only stand-ins: meta tensors,
which the cost walker runs on.  The encoder-decoder family
(``family == "encdec"``) dispatches to :mod:`repro_torch.models.encdec`,
every other family to :mod:`repro_torch.models.transformer`.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.layers import init_tree, tree_map


def param_tree(cfg: ArchConfig) -> dict:
    if cfg.family == "encdec":
        return E.init_encdec(cfg)
    return T.init_lm(cfg)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Concrete weights on ``device`` (default: the CUDA card; raises
    without one).  The reference's init rule with torch's generator: the
    structure, shapes and dtypes are the reference's, the values are not
    (see ``layers.init_tree``)."""
    return init_tree(param_tree(cfg), seed, resolve_device(device))


def init_abstract(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors (shapes and dtypes only): the
    reference's ``init_abstract``."""
    return init_params(cfg, 0, "meta")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: move the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))      # a writable copy
    return t.to(device)


def params_from_numpy(tree, device=None) -> dict:
    """The reference's parameter tree as numpy arrays (``jax.tree.map(
    np.asarray, repro.models.model.init_params(cfg, seed))``) as the port's
    tree of tensors on ``device``, value for value (bf16 included)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def build_forward(cfg: ArchConfig, kind: str) -> Callable:
    """kind: 'loss' | 'prefill' | 'decode'."""
    if cfg.family == "encdec":
        return {"loss": E.encdec_loss, "prefill": E.encdec_prefill,
                "decode": E.encdec_decode_step}[kind]
    return {"loss": T.lm_loss, "prefill": T.lm_prefill,
            "decode": T.lm_decode_step}[kind]


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None,
               n_frames: int = 0):
    """Zero decode caches at context ``seq_len``; an encoder-decoder's
    cross K/V hold ``n_frames`` encoder states (default: the config's
    ``n_audio_frames``)."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return E.init_encdec_cache(cfg, batch, seq_len,
                                   n_frames or cfg.n_audio_frames, dev)
    return T.init_lm_cache(cfg, batch, seq_len, dev)


def abstract_cache(cfg: ArchConfig, batch: int, seq_len: int,
                   n_frames: int = 0) -> dict:
    """The decode cache as meta tensors: the reference's
    ``abstract_cache``."""
    return init_cache(cfg, batch, seq_len, "meta", n_frames)
