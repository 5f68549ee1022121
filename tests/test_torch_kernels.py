"""Proxy-block kernels of the port: plain versions against the JAX
reference's oracles and the wrappers' dispatch rules.  The CUDA kernels
themselves are tested in ``tests/test_torch_cuda.py``, which imports no JAX
so that it runs on a card."""
from __future__ import annotations

import ctypes
import re
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jax_blocks
from repro.kernels.proxy_blocks import ref as jax_ref
from repro_torch.kernels import build
from repro_torch.kernels.proxy_blocks import ops, ref
from test_torch_cuda import _bf16, _mxu_inputs, assert_mxu_close
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

@pytest.mark.parametrize("reps", [1, 5, 7, 32])
def test_mxu_ref_matches_jax_ref(reps):
    a, b = _mxu_inputs(reps)
    want = jax_ref.mxu_ref(jnp.asarray(a, jnp.bfloat16),
                           jnp.asarray(b, jnp.bfloat16), reps)
    got = ref.mxu_ref(_bf16(a), _bf16(b), reps)
    assert got.dtype == torch.bfloat16
    assert_mxu_close(got.float().numpy(), want, reps)


@pytest.mark.parametrize("reps", [1, 5])
def test_mxu_ref_block_form_matches_repeated_mxu_vmem(reps):
    """scale=1.0 is block 1 (b carries the 1/128): ``reps`` applications of
    the reference's ``blocks.mxu_vmem``."""
    a, b = _mxu_inputs(10 + reps, scale=1.0)
    st = {"a": jnp.asarray(a, jnp.bfloat16), "b": jnp.asarray(b, jnp.bfloat16)}
    for _ in range(reps):
        st = jax_blocks.mxu_vmem(st)
    got = ref.mxu_ref(_bf16(a), _bf16(b), reps, scale=1.0)
    assert_mxu_close(got.float().numpy(), st["a"], reps)


@pytest.mark.parametrize("mutant", ["two_turns", "bf16_sums", "no_scale",
                                    "drop_kstep"])
def test_mxu_tolerance_rejects_wrong_arithmetic(mutant):
    """The limit above fails each plausible kernel fault at reps=5;
    ``drop_kstep`` is the CPU twin of the fault that
    ``test_cuda_mxu_mutants_fail_the_limit`` plants in the CUDA kernel (the
    last 16 of the 128 terms of every product left out)."""
    a, b = _mxu_inputs(5)
    a, b = _bf16(a), _bf16(b)
    want = ref.mxu_ref(a, b, 5).float().numpy()
    if mutant == "two_turns":
        got = ref.mxu_ref(a, b, 2)
    elif mutant == "no_scale":
        got = ref.mxu_ref(a, b, 5, scale=1.0)
    elif mutant == "drop_kstep":
        b_cut = b.clone()
        b_cut[-16:] = 0
        got = ref.mxu_ref(a, b_cut, 5)
    else:           # each partial sum rounded to bf16
        got = a
        for _ in range(5):
            acc = torch.zeros(ref.MM, ref.MM, dtype=torch.bfloat16)
            for k in range(ref.MM):
                acc = acc + (got[:, k:k + 1].float()
                             * b[k:k + 1, :].float()).to(torch.bfloat16)
            got = (acc.float() * ref.MXU_SCALE).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        assert_mxu_close(got.float().numpy(), want, 5)


def _stream_numpy(v: np.ndarray, reps: int) -> np.ndarray:
    """The block's arithmetic rounded twice a turn, in numpy f32: multiply,
    round, add, round (what slice 1 of the port did, and the reference
    does not)."""
    c, d = np.float32(0.999999), np.float32(1e-6)
    for _ in range(reps):
        v = v * c + d
    return v


def _stream_fma_numpy(v: np.ndarray, reps: int) -> np.ndarray:
    """One rounding a turn: the exact f64 multiply-add of the f32 values,
    rounded to f32 (a fused multiply-add)."""
    c, d = np.float64(np.float32(0.999999)), np.float64(np.float32(1e-6))
    for _ in range(reps):
        v = (v.astype(np.float64) * c + d).astype(np.float32)
    return v


STREAM_SHAPES = [(2048, 3), (4096, 17), (32768, 5), (32768, 2000)]


@pytest.mark.parametrize("n,reps", STREAM_SHAPES)
def test_stream_ref_matches_jax_ref(n, reps):
    """Bit for bit: XLA contracts ``v * 0.999999 + 1e-6`` into one fused
    multiply-add, and the port's plain version rounds once a turn too."""
    v = np.random.RandomState(n + reps).uniform(0, 1, (n,)).astype(np.float32)
    want = np.asarray(jax_ref.stream_ref(jnp.asarray(v), reps))
    got = ref.stream_ref(torch.from_numpy(v), reps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,reps", STREAM_SHAPES)
def test_stream_ref_matches_walked_block_under_fori_loop(n, reps):
    """The reference's block body ``blocks.hbm_stream`` under ``fori_loop``
    (the form its replay compiles) gives the same bits."""
    import jax
    v = np.random.RandomState(n + reps).uniform(0, 1, (n,)).astype(np.float32)
    loop = jax.jit(lambda v: jax.lax.fori_loop(
        0, reps, lambda i, st: jax_blocks.hbm_stream(st), {"v": v})["v"])
    want = np.asarray(loop(jnp.asarray(v)))
    got = ref.stream_ref(torch.from_numpy(v), reps).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,reps", [(2048, 3), (4096, 17), (32768, 5)])
def test_stream_ref_rounds_multiply_and_add_separately(n, reps):
    """It does not any more: the port rounds once a turn, as the reference
    does, and the twice-rounded form differs from it at every shape here."""
    v = np.random.RandomState(n + reps).uniform(0, 1, (n,)).astype(np.float32)
    got = ref.stream_ref(torch.from_numpy(v), reps).numpy()
    np.testing.assert_array_equal(got, _stream_fma_numpy(v, reps))
    assert not np.array_equal(got, _stream_numpy(v, reps))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ops.reset_counts()
    a, b = _mxu_inputs(0)
    got = ops.mxu_iter(_bf16(a), _bf16(b), 3)
    assert torch.equal(got, ref.mxu_ref(_bf16(a), _bf16(b), 3))
    v = torch.rand(4096)
    assert torch.equal(ops.stream_iter(v, 4), ref.stream_ref(v, 4))
    assert ops.LAUNCHES == {"mxu_iter": 0, "stream_iter": 0}


@pytest.mark.parametrize("reps", [1, 5, 32])
@pytest.mark.parametrize("per_item_b", [False, True])
def test_mxu_ref_rows_depend_only_on_their_own_rows(reps, per_item_b):
    """Row i of ``a`` after any number of turns depends only on row i
    before them: each 64-row half of ``a`` run alone gives the same half of
    the whole run, bit for bit.  The CUDA kernel rests on this: it runs the
    two halves of an item on two SMs that never exchange a value."""
    a, b = _mxu_inputs(reps, scale=1.0, batch=(2,))
    a, b = _bf16(a), _bf16(b)
    if not per_item_b:
        b = b[0]
    whole = ref.mxu_ref(a, b, reps, scale=1.0)
    for rows in (slice(0, 64), slice(64, 128)):
        half = ref.mxu_ref(a[:, rows], b, reps, scale=1.0)
        assert torch.equal(half, whole[:, rows])


def test_batched_mxu_ref_is_per_item():
    a, b = _mxu_inputs(3, scale=1.0, batch=(2,))
    got = ops.mxu_iter(_bf16(a), _bf16(b), 2, scale=1.0)
    for i in range(2):
        want = ref.mxu_ref(_bf16(a[i]), _bf16(b[i]), 2, scale=1.0)
        assert torch.equal(got[i], want)


def test_non_cpu_non_cuda_tensors_raise():
    """No fallback: only CPU tensors take the plain version."""
    a = torch.empty(128, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        ops.mxu_iter(a, a, 1)
    with pytest.raises(ValueError):
        ops.stream_iter(torch.empty(1024, device="meta"), 1)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A CUDA launch builds first; without the toolkit that is an error."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", _NoCudaPath)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


class _NoCudaPath(type(build.KERNELS_DIR)):
    """A Path for which /usr/local/cuda/bin/nvcc does not exist."""

    def exists(self, *args, **kwargs):
        if str(self).endswith("bin/nvcc"):
            return False
        return super().exists(*args, **kwargs)


def test_library_path_keys_on_source(tmp_path):
    src = tmp_path / "proxy_blocks" / "kernel.cu"
    src.parent.mkdir()
    src.write_text("// one\n")
    first = build.library_path(src)
    src.write_text("// two\n")
    assert build.library_path(src) != first
    assert first.parent == build.BUILD_DIR


#: C parameter types of the launchers, as ctypes types
_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float}


@pytest.mark.parametrize("name", ["proxy_blocks", "flash_attention", "ssd"])
def test_prototypes_match_the_launchers_in_the_source(name):
    """Each wrapper's ctypes prototypes name every ``*_launch`` function of
    its source with the C parameter types it declares: a prototype one
    argument short would shift every pointer after it on the card."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    text = mod.SOURCE.read_text()
    found = {}
    for fn, params in re.findall(r"^int (\w+_launch)\(([^)]*)\)", text, re.M):
        kinds = [" ".join(p.split()[:-1]) for p in params.split(",")]
        found[fn] = ([_C_TYPES[k] for k in kinds], ctypes.c_int)
    assert found == mod.PROTOTYPES


def test_load_types_the_library_once_and_then_only_looks_it_up(
        tmp_path, monkeypatch):
    """The first load builds, opens and types the library; later loads of
    the same source return it without building or taking the lock."""
    built = []

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.cuda_error_name = types.SimpleNamespace()
            self.go_launch = types.SimpleNamespace()

    src = tmp_path / "k" / "kernel.cu"

    def fake_build_all(sources):
        built.append(sources)
        return {src: tmp_path / "lib.so"}

    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(build, "_LIBS", {})
    proto = {"go_launch": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int)}
    lib = build.load(src, proto)
    assert built == [[src]] and lib.path == str(tmp_path / "lib.so")
    assert lib.go_launch.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert lib.go_launch.restype is ctypes.c_int
    monkeypatch.setattr(build, "_LOCK", None)   # a second load must not lock
    assert build.load(src, proto) is lib and len(built) == 1


def test_library_path_keys_on_shared_headers(tmp_path, monkeypatch):
    """An edited shared header rebuilds the sources: the library's name
    hashes every header of ``INCLUDE_DIRS`` too."""
    monkeypatch.setattr(build, "INCLUDE_DIRS", (tmp_path,))
    (tmp_path / "shared.cuh").write_text("// one\n")
    src = tmp_path / "proxy_blocks" / "kernel.cu"
    src.parent.mkdir()
    src.write_text('#include "shared.cuh"\n')
    first = build.library_path(src)
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert build.library_path(src) != first
