"""The port's cost walker against the reference's jaxpr walker on paired
programs: the same work written in jnp and in torch costs the same."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core.tracer import compute_cost as jax_cost
from repro_torch.core import tracer
from repro_torch.core.metrics import dtype_name, torch_dtype


def _jax_spec(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


PAIRS = {
    "matmul_bf16": (
        lambda a, b: a @ b, lambda a, b: a @ b,
        [((64, 32), "bfloat16"), ((32, 16), "bfloat16")]),
    "elementwise_scalar": (
        lambda x: x * 0.5 + 2.0, lambda x: x * 0.5 + 2.0,
        [((8, 128), "float32")]),
    "int8_chain": (
        lambda t: (t + jnp.int8(3)) ^ jnp.int8(21), lambda t: (t + 3) ^ 21,
        [((32, 128), "int8")]),
    "tanh": (jnp.tanh, torch.tanh, [((4, 256), "float32")]),
    "gather": (
        lambda tab, idx: tab[idx],
        lambda tab, idx: tab[torch.where(idx < 0, idx + 1024, idx)],
        [((1024,), "float32"), ((256,), "int32")]),
    "reduction": (
        lambda v: jnp.sum(v) * 1e-3, lambda v: torch.sum(v, dim=-1) * 1e-3,
        [((4096,), "float32")]),
    "slice_concat": (
        lambda v: jnp.concatenate([v[512:], v[:512]]),
        lambda v: torch.cat([v[512:], v[:512]]),
        [((1024,), "float32")]),
    "fori_loop": (
        lambda v: lax.fori_loop(0, 7, lambda i, x: x * 0.9, v),
        lambda v: tracer.counted_loop(7, lambda x: x * 0.9, v),
        [((512,), "float32")]),
    "scan": (
        lambda s: lax.scan(lambda c, _: (c * 0.9999 + 1e-7, None), s, None,
                           length=64)[0],
        lambda s: tracer.scan_loop(64, lambda c: c * 0.9999 + 1e-7, s),
        [((), "float32")]),
    "nested_loops": (
        lambda v: lax.fori_loop(0, 5, lambda i, x: lax.fori_loop(
            0, 3, lambda j, y: jnp.tanh(y), x), v),
        lambda v: tracer.counted_loop(5, lambda x: tracer.counted_loop(
            3, torch.tanh, x), v),
        [((64,), "float32")]),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_walker_cost_matches_reference(name):
    jfn, tfn, specs = PAIRS[name]
    want = jax_cost(jfn, *[_jax_spec(s, jnp.dtype(d)) for s, d in specs])
    args = [torch.empty(s, dtype=torch_dtype(d)) for s, d in specs]
    got = tracer.compute_cost(tfn, *args)
    np.testing.assert_array_equal(got, want)


def test_walker_runs_on_meta_and_loops_walk_once():
    """Nothing executes: the walk takes meta copies, and a counted loop of
    a million turns walks its body once."""
    seen = []

    def body(x):
        seen.append(x.device.type)
        return x + 1.0

    v = torch.zeros(16)
    cost = tracer.compute_cost(lambda x: tracer.counted_loop(10 ** 6, body, x), v)
    assert seen == ["meta"]
    assert cost[5] == 10 ** 6          # scan steps
    assert cost[1] == 10 ** 6 * (16 + 1)   # body adds + the loop counter
    assert torch.equal(v, torch.zeros(16))


def test_loops_outside_the_walker_are_plain_loops():
    out = tracer.counted_loop(3, lambda x: x + 1, torch.zeros(2))
    assert torch.equal(out, torch.full((2,), 3.0))
    out = tracer.scan_loop(4, lambda x: x * 2, torch.ones(()))
    assert float(out) == 16.0


def test_trace_fn_returns_one_compute_event():
    tr = tracer.trace_fn(lambda x: x * 2.0, torch.zeros(8))
    assert len(tr.events) == 1 and tr.comm_events() == []
    np.testing.assert_array_equal(tr.total_compute(),
                                  [0, 8, 8 * 4 + 4 + 8 * 4, 0, 0, 0])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8,
                                torch.int32, torch.bool, torch.float16])
def test_dtype_names_are_numpy_names(dt):
    name = dtype_name(dt)
    assert "torch" not in name
    assert torch_dtype(name) == dt
