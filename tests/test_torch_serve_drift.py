"""Prefill against prefill-then-decode in bf16, in the port's and the JAX
reference's own models: how far the two paths drift apart with depth.

Moved whole out of ``tests/test_torch_serve.py`` (the same test, cases and
ids), so that under ``--dist loadfile`` its minutes run on a worker of
their own.  The weights are the reference's, carried across with
``params_from_numpy``; both sides run on the CPU.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models.model import (
    build_forward as jax_build_forward, init_cache as jax_init_cache,
    init_params as jax_init_params,
)
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get
from repro_torch.models.layers import tree_map
from repro_torch.models.model import (
    build_forward, init_cache, params_from_numpy,
)
from repro_torch.serve.engine import ServeEngine
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _drift(prefill, decode, init, params, toks, split, to_np):
    """max|prefill logits - (prefill of ``split`` + decode steps) logits|
    over max|prefill logits|, at the last position."""
    b, s = toks.shape
    full, _ = prefill(params, toks)
    logits, pre = prefill(params, toks[:, :split])
    cache = init(b, s, pre)
    for i in range(split, s):
        logits, cache = decode(params, cache, toks[:, i:i + 1], i)
    full, logits = to_np(full), to_np(logits)
    return float(np.abs(logits - full).max() / np.abs(full).max())


#: (arch, depth, overrides) of the drift cases: Mamba2 at 4 layers and at
#: its full 64, d 128; DeepSeek-MoE's 28 layers with its published routing
#: (64 experts, top 6, 2 shared) at d 128, with capacity factor n_experts /
#: top_k, so that cap = tokens and nothing drops at any step
DRIFT = {"mamba2-2.7b": dict(d_model=128, vocab=512, ssm_chunk=64),
         "deepseek-moe-16b": dict(d_model=128, n_heads=4, n_kv_heads=4,
                                  head_dim=32, d_ff_expert=64, vocab=512,
                                  capacity_factor=64 / 6)}


@pytest.mark.parametrize("arch,n_layers", [
    pytest.param("mamba2-2.7b", 4, id="4"),
    pytest.param("mamba2-2.7b", 64, id="64"),
    pytest.param("deepseek-moe-16b", 28, id="deepseek-moe-16b-28")])
def test_bf16_drift_is_the_reference_models(arch, n_layers):
    """Prefill against prefill-then-decode in bf16 drifts with depth in the
    reference's own models: the two paths round to bf16 at other places,
    and random layers amplify the difference.  Here, on the same weights at
    d 128: Mamba2 at 4 layers agrees to rounding in f32 and drifts about 1%
    in bf16; at its full 64 layers the reference's bf16 logits keep little
    in common (0.442 of max|logits|).  DeepSeek-MoE at its 28 layers, with
    nothing dropped, drifts 0.135 in the reference (an MoE adds routing
    flips on near-ties between the two paths, which amplify as chaotically
    as depth does: 0.0 at 4 layers) and 0.015 in the port; f32 agrees to
    1.4e-6 on both sides.  chip_smoke.py holds the full models on the card
    to twice the reference's drift.  Mamba2 drifts within a factor 2 of
    the reference; the MoE at most twice the reference's drift."""
    drift = {}
    dtypes = ("float32", "bfloat16") if n_layers == 4 else ("bfloat16",)
    for dtype in dtypes:
        kw = dict(DRIFT[arch], n_layers=n_layers, dtype=dtype)
        jc = dataclasses.replace(jax_get(arch), **kw)
        tc = dataclasses.replace(get(arch), **kw)
        jp = jax_init_params(jc, 0)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        toks = np.random.RandomState(0).randint(0, 512, (2, 192)).astype(
            np.int32)
        jpre = jax.jit(lambda p, t: jax_build_forward(jc, "prefill")(
            p, {"tokens": t}, jc))
        jdec = jax.jit(lambda p, c, t, pos: jax_build_forward(jc, "decode")(
            p, c, {"tokens": t}, pos, jc))
        want = _drift(
            jpre, lambda p, c, t, pos: jdec(p, c, t, jnp.int32(pos)),
            lambda b, n, pre: jax.tree.map(JaxServeEngine._embed_cache,
                                           jax_init_cache(jc, b, n), pre),
            jp, jnp.asarray(toks), 128, lambda x: np.asarray(x, np.float32))
        tpre, tdec = build_forward(tc, "prefill"), build_forward(tc, "decode")
        with torch.inference_mode():
            got = _drift(
                lambda p, t: tpre(p, {"tokens": t}, tc),
                lambda p, c, t, pos: tdec(p, c, {"tokens": t}, pos, tc),
                lambda b, n, pre: tree_map(ServeEngine._embed_cache,
                                           init_cache(tc, b, n, "cpu"), pre),
                tp, torch.from_numpy(toks), 128, _np)
        print(f"{arch}, {n_layers} layers, {dtype}: drift port {got!r}, "
              f"reference {want!r}")
        drift[dtype] = got, want
    got, want = drift["bfloat16"]
    if n_layers == 4:
        assert max(drift["float32"]) <= 1e-4
        assert want >= 5e-3, "the reference's bf16 drift is real"
    elif arch == "mamba2-2.7b":
        assert want >= 0.2, "64 layers amplify it to O(1)"
    else:
        assert want >= 0.05, "the reference's MoE drift is real"
        assert got <= 2 * want
        return
    assert want / 2 <= got <= 2 * want
