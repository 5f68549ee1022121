"""The port's proxy blocks against the JAX reference: calibration matrix B,
walker costs, initial state and block numerics."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import blocks as jax_blocks
from repro.core.tracer import compute_cost as jax_compute_cost
from repro_torch.core import blocks
from repro_torch.core.tracer import compute_cost
from repro_torch.kernels.proxy_blocks import ops
from test_torch_cuda import MXU_RTOL, _bf16, _mxu_inputs, assert_mxu_close
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def b_jax():
    return jax_blocks.calibration_matrix()


@pytest.mark.parametrize("j", range(blocks.N_BLOCKS),
                         ids=lambda j: blocks.BLOCK_NAMES[j])
def test_calibration_column_equals_reference(j, b_jax):
    """B column by column, exactly (the walker rules reproduce the
    reference's jaxpr accounting, scalar literals and slices included)."""
    b = blocks.calibration_matrix()
    assert b.shape == b_jax.shape == (6, 11)
    np.testing.assert_array_equal(b[:, j], b_jax[:, j])


@pytest.mark.parametrize("name", blocks.BLOCK_NAMES[:9])
def test_repeat_block_walker_cost(name):
    """walker(repeat_block(name, n, unroll)) == n·(unroll·B[:, j] + B[:, 10])."""
    b = blocks.calibration_matrix()
    j = blocks.BLOCK_NAMES.index(name)
    st = blocks.init_state(0, "cpu")
    for n, unroll in ((1, 1), (3, 2), (7, 8)):
        got = compute_cost(lambda s: blocks.repeat_block(name, n, s, unroll), st)
        np.testing.assert_array_equal(got, n * (unroll * b[:, j] + b[:, 10]))


@pytest.mark.parametrize("x", [[1, 0, 2, 0, 1, 0, 0, 1, 0, 3, 9],
                               [5, 4, 3, 2, 1, 1, 2, 3, 4, 0, 25],
                               [0, 0, 0, 0, 0, 0, 0, 0, 0, 7, 0]])
def test_combo_cost_equals_walker_and_reference(x):
    st = blocks.init_state(0, "cpu")
    st_jax = jax.eval_shape(jax_blocks.init_state)
    for u in (1, 8):
        walked = compute_cost(lambda s: blocks.run_combo(s, x, u), st)
        np.testing.assert_array_equal(walked, blocks.combo_cost(x, u))
        np.testing.assert_array_equal(
            walked, jax_compute_cost(lambda s: jax_blocks.run_combo(s, x, u),
                                     st_jax))


def test_walker_never_reaches_the_kernels(monkeypatch):
    """On meta tensors repeat_block takes the plain bodies, so B and every
    combo cost are the same whether or not the kernels engage."""
    def boom(*a, **k):
        raise AssertionError("kernel wrapper called under the walker")

    monkeypatch.setattr(ops, "mxu_iter", boom)
    monkeypatch.setattr(ops, "stream_iter", boom)
    cached = blocks.calibration_matrix()
    blocks.calibration_matrix.cache_clear()
    try:
        np.testing.assert_array_equal(blocks.calibration_matrix(), cached)
        walked = compute_cost(
            lambda s: blocks.run_combo(s, (5, 1, 5, 0, 1, 0, 0, 0, 12, 0, 24)),
            blocks.init_state(0, "cpu"))
        np.testing.assert_array_equal(
            walked, blocks.combo_cost((5, 1, 5, 0, 1, 0, 0, 0, 12, 0, 24)))
    finally:
        blocks.calibration_matrix.cache_clear()


@pytest.mark.parametrize("name", ["mxu_vmem", "hbm_stream"])
def test_kernel_blocks_are_one_wrapper_call(name, monkeypatch):
    """Outside the walker, blocks 1 and 3 replay as one kernel call of
    reps = n·unroll."""
    calls = []
    real = {"mxu_vmem": ops.mxu_iter, "hbm_stream": ops.stream_iter}[name]

    def spy(*args, **kwargs):
        calls.append(args[-1] if name == "hbm_stream" else args[2])
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, {"mxu_vmem": "mxu_iter",
                              "hbm_stream": "stream_iter"}[name], spy)
    st = blocks.init_state(0, "cpu")
    if name == "mxu_vmem":      # b orthogonal: a stays O(1) over the 6 turns
        st["b"] = _bf16(_mxu_inputs(0, scale=1.0)[1])
    out = blocks.repeat_block(name, 3, st, unroll=2)
    assert calls == [6]
    if name == "hbm_stream":
        # six applications of the reference's block as its replay compiles
        # them (one fused multiply-add a turn), bit for bit; the port's
        # eager body rounds twice and is only walked, on meta tensors
        loop = jax.jit(lambda v: jax.lax.fori_loop(
            0, 6, lambda i, s: jax_blocks.hbm_stream(s), {"v": v})["v"])
        np.testing.assert_array_equal(out["v"].numpy(),
                                      np.asarray(loop(st["v"].numpy())))
    else:
        want = st
        for _ in range(6):
            want = blocks.BLOCK_FNS[name](want)
        assert_mxu_close(out["a"].float().numpy(), want["a"].float().numpy(),
                         6)


@pytest.mark.parametrize("seed", [0, 3])
def test_init_state_bit_identical_to_reference(seed):
    st = blocks.init_state(seed, "cpu")
    ref = jax_blocks.init_state(seed)
    assert set(st) == set(ref)
    for k, v in st.items():
        want = np.asarray(ref[k])
        assert str(v.dtype).replace("torch.", "") == want.dtype.name, k
        assert tuple(v.shape) == want.shape, k
        np.testing.assert_array_equal(
            blocks.state_to_numpy({k: v})[k], want.astype(np.float32)
            if want.dtype.name == "bfloat16" else want, err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
def test_state_from_numpy_round_trips(seed):
    ref = jax_blocks.init_state(seed)
    st = blocks.state_from_numpy({k: np.asarray(v) for k, v in ref.items()},
                                "cpu")
    mine = blocks.init_state(seed, "cpu")
    for k in mine:
        assert st[k].dtype == mine[k].dtype
        assert torch.equal(st[k], mine[k]), k


def test_run_combo_matches_reference_numerics():
    """Same combo from the same state: integer leaves exactly; f32 leaves
    to rounding (the reference contracts the stream update into an FMA on
    CPU, and tanh and the matmuls come from other libraries); ``a`` (bf16,
    about 1e-3 after two turns of the init state's ``b``) within one bf16
    ulp of its largest value."""
    x = (2, 1, 3, 1, 1, 1, 1, 1, 1, 4, 15)
    got = blocks.state_to_numpy(
        blocks.run_combo(blocks.init_state(1, "cpu"), x))
    want = jax_blocks.run_combo(jax_blocks.init_state(1), x)
    for k, v in got.items():
        w = np.asarray(want[k], np.float32) if k in ("a", "b") else np.asarray(want[k])
        if v.dtype.kind in "iu":
            np.testing.assert_array_equal(v, w, err_msg=k)
        elif k == "a":
            top = float(np.abs(w).max())
            assert top > 0
            np.testing.assert_allclose(v, w, rtol=0, atol=MXU_RTOL * top)
        else:
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_batched_state_replays_each_rank():
    """A stacked batch of states replays like each state on its own."""
    x = (2, 1, 3, 1, 1, 1, 1, 1, 1, 4, 15)
    sts = [blocks.init_state(s, "cpu") for s in (0, 1)]
    stacked = {k: torch.stack([s[k] for s in sts]) for k in sts[0]}
    out = blocks.run_combo(stacked, x)
    for i, s in enumerate(sts):
        one = blocks.run_combo(s, x)
        for k in one:
            np.testing.assert_allclose(out[k][i].float().numpy(),
                                       one[k].float().numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_run_combo_rejects_bad_coupling():
    with pytest.raises(ValueError):
        blocks.run_combo(blocks.init_state(0, "cpu"),
                         [5, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2])
