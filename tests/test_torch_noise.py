"""Seeded noise replay in the port (``core/noise.py``, ``noise=`` on
``run_all``/``time_all``/``fidelity``) against the JAX reference.

The port's sampler is its own (a counter-based draw in integer torch ops,
not ``jax.random`` threefry), so the streams cannot equal the reference's
bit for bit.  Held instead, after ``tests/test_replay_noise.py`` and
``tests/test_noise_prop.py`` (their mesh test waits for the port's mesh
replay):

* ``noise=None`` is today's deterministic δ̄, bit for bit, in both codegen
  flavors, and equal to the reference's;
* every terminal occurrence, comm and compute, consumes exactly one draw,
  in program order, so a fixed ``(seed, n_replicas)`` reproduces the
  distribution bit for bit, on repeat and across the table and unrolled
  flavors;
* a replica's stream depends only on ``(seed, group representative,
  replica)``, not on how many replicas run beside it;
* the factors are mean-one with variance ``factor_variance(σ, shift)``;
* on the reference's own TraceStore, seed 3 and 32 replicas, the port's
  noisy mean lies inside the reference's ``ci()`` and the reference's
  inside the port's;
* the reference's guards: ``noise=`` with ``per_rank_seeds`` or without the
  batched path raises.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import events as port_events
from repro_torch.core import noise
from repro_torch.core.events import CommEvent, ComputeEvent, is_comm
from repro_torch.core.replay import FidelityDistribution, NoiseConfig
from repro_torch.core.synthesize import synthesize
from repro_torch.core.trace_ir import TraceStore
from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

_TRACE_SRC = """\
def _traces(n_ranks=4, reps=6, seed=7, ev=None):
    import numpy as np
    rng = np.random.default_rng(seed)
    base = np.array([2.1e6, 3.3e4, 1.1e6, 8.2e2, 0., 0.])
    comm = ev.CommEvent("psum", (16,), "float32", ("x",))
    perm = ev.CommEvent("ppermute", (4, 4), "bfloat16", ("x",), ("shift", 1))
    out = []
    for r in range(n_ranks):
        tr = []
        for _ in range(reps):
            f = 1.0 + 0.03 * rng.standard_normal()
            tr += [ev.ComputeEvent(tuple(base * f)), comm,
                   ev.ComputeEvent(tuple(base * (2 * f))), perm]
        if r == 0:
            tr = tr + [comm]            # second signature group
        out.append(tr)
    return out
"""
exec(_TRACE_SRC)  # defines _traces here and in the reference's script

CFG = NoiseConfig(seed=3, n_replicas=4)
#: the band check's config: 32 replicas of seed 3
BAND = NoiseConfig(seed=3, n_replicas=32)


def _synth(tmp_path, codegen="table", store=None):
    kw = dict(store=store) if store is not None else dict(
        rank_traces=_traces(ev=port_events), axis_sizes={"x": 4})  # noqa: F821
    return synthesize(**kw, name=f"noise_{codegen}", codegen=codegen,
                      device="cpu", out_dir=tmp_path / codegen)


REFERENCE = _TRACE_SRC + """
import json
import numpy as np
from repro.core import events as ev
from repro.core.replay import NoiseConfig
from repro.core.synthesize import synthesize
from repro.core.trace_ir import TraceStore
store = TraceStore.from_rank_traces(_traces(ev=ev), {"x": 4})
store.save(OUT / "store.npz")
out = {}
for flavor in ("table", "unrolled"):
    res = synthesize(store=store, name="ref_" + flavor, codegen=flavor,
                     out_dir=str(OUT / flavor))
    out[flavor] = res.fidelity(sample_ranks=None).mean
d = res.fidelity(sample_ranks=None, noise=NoiseConfig(seed=3, n_replicas=32))
out["band"] = {"mean": d.mean, "ci": list(d.ci()), "std": d.std}
(OUT / "ref.json").write_text(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("noise_ref")
    data = run_reference(REFERENCE, out, timeout=600)["ref"]
    data["store"] = TraceStore.load(out / "store.npz")
    return data


# ---------------------------------------------------------------------------
# noise=None is the deterministic program
# ---------------------------------------------------------------------------


def test_noise_none_is_todays_delta_both_flavors(tmp_path, ref):
    """noise=None is the plain FidelityReport: same type, same δ, the same
    across flavors, and the reference's δ̄ on its own store."""
    deltas = {}
    for flavor in ("table", "unrolled"):
        res = _synth(tmp_path, flavor, store=ref["store"])
        assert res.proxy.module.NOISE_MODELS
        plain = res.fidelity(sample_ranks=None)
        off = res.fidelity(sample_ranks=None, noise=None)
        assert type(off) is type(plain)
        assert not isinstance(off, FidelityDistribution)
        np.testing.assert_array_equal(off.delta, plain.delta)
        assert (off.seed, off.n_replicas) == (0, 1)
        assert abs(off.mean - ref[flavor]) <= 1e-12
        deltas[flavor] = off.delta
    np.testing.assert_array_equal(deltas["table"], deltas["unrolled"])


def test_noise_none_draws_nothing(tmp_path, monkeypatch):
    """The deterministic replay never reaches the sampler: no occurrence
    is recorded, no draw is made, and the states carry no noise leaf."""
    res = _synth(tmp_path)
    plain = res.proxy.run_all()

    def boom(*a, **k):
        raise AssertionError("a draw in deterministic replay")

    monkeypatch.setattr(noise.NoiseTape, "record", boom)
    monkeypatch.setattr(noise, "sample_factor", boom)
    again = res.proxy.run_all(noise=None)
    res.proxy.time_all()
    for r, st in again.items():
        assert set(st) == set(plain[r])
        assert not any(k.startswith("_noise") for k in st)
        for k, v in st.items():
            assert torch.equal(v, plain[r][k])


# ---------------------------------------------------------------------------
# seeded determinism when enabled
# ---------------------------------------------------------------------------


def test_distribution_reproducible_and_seed_sensitive(tmp_path):
    res = _synth(tmp_path)
    a = res.fidelity(sample_ranks=None, noise=CFG)
    b = res.fidelity(sample_ranks=None, noise=CFG)
    assert isinstance(a, FidelityDistribution)
    assert (a.seed, a.n_replicas) == (CFG.seed, CFG.n_replicas)
    np.testing.assert_array_equal(a.replica_delta, b.replica_delta)
    np.testing.assert_array_equal(a.comm_bytes, b.comm_bytes)
    c = res.fidelity(sample_ranks=None,
                     noise=NoiseConfig(seed=CFG.seed + 1,
                                       n_replicas=CFG.n_replicas))
    assert not np.array_equal(a.replica_delta, c.replica_delta)
    assert np.ptp(a.replica_means) > 0


def test_noisy_flavor_parity(tmp_path):
    """Table and unrolled modules record the same occurrences with the same
    params in the same order: bit-identical distributions."""
    a = _synth(tmp_path, "table").fidelity(sample_ranks=None, noise=CFG)
    b = _synth(tmp_path, "unrolled").fidelity(sample_ranks=None, noise=CFG)
    np.testing.assert_array_equal(a.replica_delta, b.replica_delta)
    np.testing.assert_array_equal(a.comm_bytes, b.comm_bytes)


def test_replica_streams_depend_only_on_logical_ids(tmp_path):
    """Replica j of seed s draws the same stream beside 2 or 8 others."""
    res = _synth(tmp_path)
    few = res.fidelity(sample_ranks=None, noise=NoiseConfig(3, 2))
    many = res.fidelity(sample_ranks=None, noise=NoiseConfig(3, 8))
    np.testing.assert_array_equal(few.replica_delta, many.replica_delta[:2])
    np.testing.assert_array_equal(few.comm_bytes, many.comm_bytes[:2])
    assert torch.equal(noise.replica_key(3, 5, 1),
                       noise.replica_key(3, 5, 1, "cpu"))
    keys = {tuple(noise.replica_key(s, r, j)[:2].tolist())
            for s in range(4) for r in range(4) for j in range(4)}
    assert len(keys) == 64


def test_each_occurrence_consumes_one_draw(tmp_path):
    """A group's replay records one occurrence a terminal of its expanded
    stream, comm and compute, in program order; the key's counter then
    advances by that count."""
    res = _synth(tmp_path)
    prog = res.proxy
    states = prog.run_all(noise=CFG)
    seen = []
    orig = noise.NoiseTape.record

    def spy(self, nz):
        seen.append(nz)
        return orig(self, nz)

    noise.NoiseTape.record = spy
    try:
        for sig, grp in prog.signature_groups():
            seen.clear()
            prog.run_all(ranks=[grp[0]], noise=CFG)
            ids = prog.expand_rank_ids(grp[0])
            want = [prog.module.NOISE_MODELS[i] for i in ids]
            assert [(nz.sigma, nz.shift) for nz in seen] == \
                [tuple(map(float, w)) for w in want]
            assert [nz.cost is None for nz in seen] == \
                [is_comm(prog.merged.table[i]) for i in ids]
            key = states[grp[0]][noise.NOISE_KEY]
            assert key.shape == (CFG.n_replicas, 3)
            assert key[:, 2].tolist() == [len(ids)] * CFG.n_replicas
    finally:
        noise.NoiseTape.record = orig


def test_distribution_stats_shapes(tmp_path):
    res = _synth(tmp_path)
    d = res.fidelity(sample_ranks=None, noise=CFG)
    n_rep, n_metrics, n_ranks = d.replica_delta.shape
    assert (n_rep, n_ranks) == (CFG.n_replicas, 4)
    assert d.delta_mean.shape == d.delta_std.shape == (n_metrics, n_ranks)
    assert d.replica_means.shape == (n_rep,)
    lo, hi = d.ci()
    assert lo <= d.mean <= hi
    assert d.metric_bands().shape == (n_metrics, 2)
    assert d.comm_bytes.shape == (n_rep, n_ranks)
    assert (d.comm_bytes > 0).all()
    assert d.comm_lossless


def test_run_all_noise_axis_and_guards(tmp_path):
    res = _synth(tmp_path)
    states = res.proxy.run_all(noise=CFG)
    for st in states.values():
        acc = st[noise.NOISE_COMPUTE]
        assert acc.shape == (CFG.n_replicas, 6)
        assert st["a"].shape[0] == CFG.n_replicas
        assert np.ptp(acc.sum(dim=1).numpy()) > 0
    assert res.proxy.time_all(noise=CFG) > 0
    with pytest.raises(ValueError, match="per_rank_seeds"):
        res.proxy.run_all(noise=CFG, per_rank_seeds=True)
    with pytest.raises(ValueError, match="batched"):
        res.proxy.run_all(noise=CFG, batched=False)
    with pytest.raises(ValueError, match="per_rank_seeds"):
        res.proxy.time_all(noise=CFG, per_rank_seeds=True)


def test_noise_config_validates():
    with pytest.raises(ValueError):
        NoiseConfig(n_replicas=0)


def test_noisy_mean_inside_the_references_band(tmp_path, ref):
    """On the reference's own TraceStore at seed 3 and 32 replicas, each
    side's noisy mean lies inside the other's 1.96-sigma band."""
    res = _synth(tmp_path, store=ref["store"])
    d = res.fidelity(sample_ranks=None, noise=BAND)
    lo, hi = ref["band"]["ci"]
    print(f"noisy delta_bar: port {d.mean!r} in {d.ci()}, reference "
          f"{ref['band']['mean']!r} in {(lo, hi)}")
    assert lo <= d.mean <= hi
    assert d.ci()[0] <= ref["band"]["mean"] <= d.ci()[1]
    assert d.std > 0 and ref["band"]["std"] > 0


# ---------------------------------------------------------------------------
# provenance CSV round-trip
# ---------------------------------------------------------------------------


def test_fidelity_csv_provenance_roundtrip(tmp_path):
    res = _synth(tmp_path)
    rep = res.fidelity(sample_ranks=None)
    meta, delta = noise.parse_fidelity_csv(rep.to_csv())
    assert meta["seed"] == 0 and meta["n_replicas"] == 1
    assert meta["ranks"] == (0, 1, 2, 3)
    np.testing.assert_allclose(delta, rep.delta, atol=5e-5)
    dist = res.fidelity(sample_ranks=None, noise=CFG)
    meta, delta = noise.parse_fidelity_csv(dist.to_csv())
    assert meta["seed"] == CFG.seed
    assert meta["n_replicas"] == CFG.n_replicas
    assert meta["ranks"] == dist.ranks
    np.testing.assert_allclose(delta, dist.delta_mean, atol=5e-5)


# ---------------------------------------------------------------------------
# the factor distribution (test_noise_prop.py's seeded half)
# ---------------------------------------------------------------------------


def _samples(sigma, shift, n=4000, seed=0):
    key = noise.replica_key(seed, 0, 0)
    return noise.sample_factor(key, torch.arange(n), sigma, shift).numpy()


def _check_factor_distribution(sigma, shift):
    s = _samples(sigma, shift)
    assert np.isfinite(s).all()
    assert (s > shift - 1e-7).all() and (s > 0).all()
    assert abs(float(s.mean()) - 1.0) < 5 * s.std() / np.sqrt(len(s)) + 1e-3
    want = noise.factor_variance(sigma, shift)
    assert float(s.var()) == pytest.approx(want, rel=0.25, abs=1e-6)


@pytest.mark.parametrize("shift", (0.0, 0.5, 0.8))
@pytest.mark.parametrize("sigma", (0.01, 0.1, 0.5, 1.0))
def test_factor_distribution_grid(sigma, shift):
    _check_factor_distribution(sigma, shift)


def test_variance_scales_with_sigma():
    sigmas = (0.01, 0.05, 0.2, 0.8)
    for shift in (0.0, 0.8):
        analytic = [noise.factor_variance(s, shift) for s in sigmas]
        assert all(a < b for a, b in zip(analytic, analytic[1:]))
        empirical = [float(_samples(s, shift).var()) for s in sigmas]
        assert all(a < b for a, b in zip(empirical, empirical[1:]))
    assert noise.factor_variance(0.5, 0.8) < noise.factor_variance(0.5, 0.0)


def test_zero_sigma_degenerates_to_unit():
    assert noise.factor_variance(0.0, 0.0) == 0.0
    np.testing.assert_allclose(_samples(0.0, 0.7, n=64), 1.0, atol=1e-12)


def test_draws_are_standard_normal_and_streams_independent():
    """The Box-Muller z of one stream: mean 0, variance 1, no lag-1
    correlation; two replicas' streams uncorrelated; the 32-bit mixing
    never overflows (values stay in [0, 2^32))."""
    n = 20000
    k0, k1 = noise.replica_key(0, 0, 0), noise.replica_key(0, 0, 1)
    z0 = np.log(noise.sample_factor(k0, torch.arange(n), 1.0, 0.0).numpy()) \
        + 0.5
    z1 = np.log(noise.sample_factor(k1, torch.arange(n), 1.0, 0.0).numpy()) \
        + 0.5
    for z in (z0, z1):
        assert abs(z.mean()) < 5 / np.sqrt(n)
        assert abs(z.var() - 1.0) < 0.05
        assert abs(np.corrcoef(z[:-1], z[1:])[0, 1]) < 5 / np.sqrt(n)
    assert abs(np.corrcoef(z0, z1)[0, 1]) < 5 / np.sqrt(n)
    x = noise._mix32(torch.tensor([0, 1, 2 ** 32 - 1, 0x7FFFFFFF]))
    assert ((x >= 0) & (x < 2 ** 32)).all()
    big = torch.tensor([2 ** 32 - 1])
    assert int(noise._mul32(big, 0x846CA68B)) == \
        (2 ** 32 - 1) * 0x846CA68B % 2 ** 32


def test_stacked_keys_draw_each_replicas_own_stream():
    """A stacked key (n, 3) draws, row by row, what each key alone draws."""
    keys = torch.stack([noise.replica_key(3, 0, j) for j in range(3)])
    stacked = noise.sample_factor(keys, torch.arange(10), 0.3, 0.2)
    for j in range(3):
        alone = noise.sample_factor(keys[j], torch.arange(10), 0.3, 0.2)
        assert torch.equal(stacked[j], alone)


# ---------------------------------------------------------------------------
# calibration -> emission (both flavors)
# ---------------------------------------------------------------------------


def _jittered_traces(n_ranks=4, reps=6, seed=7):
    rng = np.random.default_rng(seed)
    base = np.array([2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.])
    comm = CommEvent("psum", (16,), "float32", ("x",))
    perm = CommEvent("ppermute", (4, 4), "bfloat16", ("x",), ("shift", 1))
    traces = []
    for _r in range(n_ranks):
        tr = []
        for _ in range(reps):
            f = 1.0 + 0.03 * rng.standard_normal()
            tr += [ComputeEvent(tuple(base * f)), comm,
                   ComputeEvent(tuple(base * (2 * f))), perm]
        traces.append(tr)
    return traces


@pytest.mark.parametrize("codegen", ["table", "unrolled"])
def test_params_roundtrip_through_emission(codegen, tmp_path):
    res = synthesize(rank_traces=_jittered_traces(), axis_sizes={"x": 4},
                     device="cpu", codegen=codegen, out_dir=tmp_path)
    model = noise.calibrate(res.store, rel_tol=0.05)
    want = model.terminal_params(res.merged.table.events)
    got = res.proxy.module.NOISE_MODELS
    assert tuple(got) == tuple(want)
    for (sig, shift), ev in zip(got, res.merged.table.events):
        assert sig >= noise.SIGMA_FLOOR
        assert shift == (noise.COMM_SHIFT if is_comm(ev) else 0.0)
    assert any(sig > noise.SIGMA_FLOOR for (sig, shift), ev
               in zip(got, res.merged.table.events) if not is_comm(ev))


def test_noise_model_json_roundtrip_exact():
    model = noise.NoiseModel(
        compute_sigmas={0: 0.1234567891234567, 3: noise.SIGMA_FLOOR},
        comm_params={"psum": (0.7071067811865476, 0.8)},
        sigma_floor=0.01)
    assert noise.NoiseModel.from_json(model.to_json()) == model
