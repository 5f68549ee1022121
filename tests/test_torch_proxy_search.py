"""The port's block-combination fit against the JAX reference's."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import blocks as jax_blocks
from repro.core import proxy_search as jax_fit
from repro_torch.core import proxy_search as fit


def _targets() -> dict[str, np.ndarray]:
    b = jax_blocks.calibration_matrix()
    rng = np.random.RandomState(0)
    return {
        "exact_mix": b @ np.array([40, 12, 25, 8, 5, 9, 3, 2, 7, 11, 130]),
        "random_mix": b @ rng.randint(0, 200, 11).astype(float),
        "large": np.array([3.2e12, 4.1e10, 8.0e11, 2.5e8, 1.1e8, 4.0e5]),
        "pure_movement": np.array([0, 0, 2e9, 0, 0, 0], dtype=float),
        "synthetic_trace": np.array([2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.]),
    }


def _pgd_targets() -> np.ndarray:
    """The 8 targets of tests/test_blocks_qp.py::test_pgd_matches_nnls."""
    rng = np.random.RandomState(1)
    b = jax_blocks.calibration_matrix()
    return np.stack([b @ rng.randint(1, 500, 11).astype(float)
                     for _ in range(8)])


@pytest.mark.parametrize("name", sorted(_targets()))
def test_nnls_fit_bit_identical(name):
    t = _targets()[name]
    got = fit.fit_combination(t)
    want = jax_fit.fit_combination(t)
    np.testing.assert_array_equal(got.x, want.x)
    assert got.unroll == want.unroll
    np.testing.assert_array_equal(got.predicted, want.predicted)
    np.testing.assert_array_equal(got.per_metric_rel_err, want.per_metric_rel_err)
    assert got.residual == want.residual


def test_pgd_solutions_agree_with_reference():
    """Real-valued PGD solutions: both solvers run 600 float32 steps, whose
    matmuls sum in different orders, so they agree to float32 rounding
    carried through the iteration: within 1e-4 relative to max(|y|, 1)."""
    targets = _pgd_targets()
    b = jax_blocks.calibration_matrix()
    bss = np.broadcast_to(fit.substituted_matrix(b), (8,) + b.shape)
    got = fit._pgd_grid(targets, bss, 600, device="cpu")
    want = jax_fit._pgd_grid(targets, bss, 600)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def test_fit_batch_pgd_counts_equal_reference():
    targets = _pgd_targets()
    got = fit.fit_batch_pgd(targets, iters=600, device="cpu")
    want = jax_fit.fit_batch_pgd(targets, iters=600)
    np.testing.assert_array_equal(got, want)


def test_fit_batch_integer_counts_equal_reference():
    targets = _pgd_targets()
    got = fit.fit_batch(targets, device="cpu")
    want = jax_fit.fit_batch(targets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        assert g.unroll == w.unroll
        np.testing.assert_allclose(g.predicted, w.predicted, rtol=0, atol=0)


def test_solver_crossover_is_the_reference_s():
    assert fit.PGD_TERMINAL_THRESHOLD == jax_fit.PGD_TERMINAL_THRESHOLD
    for n in (0, 1, 32, 33, 1000):
        assert fit.choose_solver(n) == jax_fit.choose_solver(n)
