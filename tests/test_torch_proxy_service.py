"""The port's serve tier (ProxyService, BallTree, cross-chip prediction)
against the JAX reference.

The reference's service needs its ``synthesize_corpus``, so it runs in one
subprocess for the whole file (test_torch_harness.py), over a copy of the
store the port wrote and on the same query traces.  The port's own tests
below are the reference's tests/test_proxy_service.py on the CPU.

Parity levels, as each test states: query answers (names, distances,
matched fractions) bit-equal to the reference's; ``predict_profile`` under
the reference's TPU envelopes (``v5e``, ``v4``, built here as ChipSpecs)
within 1e-12 relative; on the port's own ``h100`` it agrees with the
walker's rank metrics within 1e-12 relative (float64 sums in another
order); ``BallTree`` returns exactly what ``brute_force_nearest`` returns.
"""
from __future__ import annotations

import json
import shutil
import threading

import numpy as np
import pytest
import torch

from repro.serve import ann as ref_ann
from repro_torch.configs.registry import SCENARIO_IDS, build_scenario
from repro_torch.core import proxy_search, sequitur
from repro_torch.core.corpus_store import CorpusStore
from repro_torch.core.events import CommEvent, ComputeEvent
from repro_torch.core.portability import (CHIPS, REFERENCE_CHIP, ChipSpec,
                                          predict_all, predict_profile)
from repro_torch.core.replay import load_saved_module
from repro_torch.core.trace_ir import TraceStore
from repro_torch.launch.hlo_cost import HloCost
from repro_torch.serve.ann import BallTree, brute_force_nearest
from repro_torch.serve.proxy_service import ProxyService, StaleServiceError
from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

#: predict_profile, port against reference on the same store and chip
PROFILE_RTOL = 1e-12
#: the h100 prediction against the walker's totals: float64 sums of the
#: same terms in another order, where the proxy counts no loop; where it
#: does, the walker also charges the loop's bookkeeping (element ops and
#: bytes), which the predictor leaves out by design, as the reference's does
WALKER_RTOL = 1e-12
#: that bookkeeping's share of a rank's flops or bytes (flash-ring at 8
#: ranks: 2.08e-5 of its bytes, in both packages)
WALKER_LOOP_GAP = 1e-4
#: the reference's TPU envelopes (src/repro/core/portability.py:54-58);
#: the port's own table carries none
REF_CHIPS = {"v5e": ChipSpec("v5e", peak_flops=197e12, hbm_bw=819e9,
                             ici_bw=50e9),
             "v4": ChipSpec("v4", peak_flops=275e12, hbm_bw=1228e9,
                            ici_bw=50e9)}

_V1 = (2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.)
_V2 = (4.4e6, 1.2e4, 2.2e6, 0., 7.0, 1.0)
_V3 = (9.9e8, 5.5e5, 3.3e7, 1.1e3, 0., 2.0)


def _store(vectors, kind="psum", n_ranks=4):
    comm = CommEvent(kind, (8,), "float32", ("x",))
    tr = []
    for v in vectors:
        tr += [ComputeEvent(tuple(v)), comm]
    return TraceStore.from_rank_traces([list(tr) for _ in range(n_ranks)],
                                       {"x": n_ranks})


def _small() -> dict[str, TraceStore]:
    return {"heavy": _store([_V3, _V3, _V1]),
            "light": _store([_V2, _V2], kind="all_gather"),
            "mixed": _store([_V1, _V2, _V3])}


@pytest.fixture(scope="module")
def svc(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    cs = CorpusStore(root / "corpus")
    for n, st in _small().items():
        cs.add_scenario(n, st)
    return ProxyService(cs, out_dir=root / "modules", device="cpu")


# ---------------------------------------------------------------------------
# against the reference's service, on the same store and queries
# ---------------------------------------------------------------------------

REFERENCE_CODE = """
import json, shutil
import numpy as np
from repro.core.corpus_store import CorpusStore
from repro.core.portability import ChipSpec, predict_profile
from repro.core.trace_ir import TraceStore
from repro.launch.hlo_cost import HloCost
from repro.serve.proxy_service import ProxyService

root = OUT.parent
shutil.copytree(root / "corpus", OUT / "corpus")
svc = ProxyService(CorpusStore(OUT / "corpus"), out_dir=OUT / "modules")
n_q = json.loads((root / "n_queries.json").read_text())
queries = [TraceStore.load(root / "queries" / f"{i}.npz") for i in range(n_q)]
answers = [{"name": a.name, "distance": a.distance, "distances": a.distances,
            "matched_frac": a.matched_frac} for a in svc.query_batch(queries)]
chips = {n: ChipSpec(n, *v) for n, v in
         json.loads((root / "chips.json").read_text()).items()}
profiles = {}
h100 = chips["h100"]
walker = {}
for name, res in svc.corpus.results.items():
    p = predict_profile(res.proxy.module, h100, ref_chip=h100)
    rows = []
    for r in range(res.proxy.module.N_RANKS):
        hc = HloCost.from_metric_vector(res.proxy.rank_metrics(r))
        rows.append([float(p.t_compute[r]), hc.flops / h100.peak_flops,
                     float(p.t_memory[r]), hc.bytes / h100.hbm_bw])
    walker[name] = rows
    for c, spec in chips.items():
        if c == "h100":
            continue
        p = predict_profile(res.proxy.module, spec, ref_chip=chips["v5e"])
        profiles[f"{name}@{c}"] = {
            k: np.asarray(getattr(p, k)).tolist() for k in
            ("t_compute", "t_memory", "t_collective", "t_total", "t_std")}
        profiles[f"{name}@{c}"]["bottleneck"] = list(p.bottleneck)
        profiles[f"{name}@{c}"]["speedup_vs_ref"] = p.speedup_vs_ref
(OUT / "service.json").write_text(json.dumps({
    "answers": answers, "profiles": profiles, "names": svc._names,
    "walker": walker,
    "embeddings": {n: svc.embedding(n).tolist() for n in svc._names}}))
"""


def _queries(zoo: dict) -> list[TraceStore]:
    novel = tuple(v * 1.7 + 13.0 for v in _V3)
    out = list(zoo.values())
    out += [_store([novel, novel, _V3]), _store([_V1, _V1]),
            _store([_V2, _V1] * 3), _store([_V3], kind="all_to_all"),
            build_scenario("moe-ep", n_ranks=4, steps=1)]
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("both")
    zoo = _small()
    zoo.update({n: build_scenario(n, n_ranks=2, steps=1)
                for n in SCENARIO_IDS})
    # counted loops: seven ring hops a step (the walker charges their
    # bookkeeping, the predictor does not)
    zoo["flash-ring-8"] = build_scenario("flash-ring", n_ranks=8)
    cs = CorpusStore(root / "corpus")
    cs.add_scenarios(sorted(zoo.items()))
    queries = _queries(zoo)
    (root / "queries").mkdir()
    for i, q in enumerate(queries):
        q.save(root / "queries" / f"{i}.npz")
    (root / "n_queries.json").write_text(json.dumps(len(queries)))
    chips = dict(REF_CHIPS, h100=CHIPS["h100"])
    (root / "chips.json").write_text(json.dumps(
        {n: [c.peak_flops, c.hbm_bw, c.ici_bw] for n, c in chips.items()}))
    ref = run_reference(REFERENCE_CODE, root / "ref", timeout=600)["service"]
    shutil.copytree(root / "corpus", root / "port_corpus")
    port = ProxyService(CorpusStore(root / "port_corpus"),
                        out_dir=root / "modules", device="cpu")
    queries = [TraceStore.load(root / "queries" / f"{i}.npz")
               for i in range(len(queries))]
    return {"port": port, "ref": ref, "queries": queries}


def test_embeddings_equal_the_references(both):
    """Bit-equal: the embedding is NumPy over the same store and the same
    integer fit counts."""
    port, ref = both["port"], both["ref"]
    assert port._names == ref["names"]
    for n in port._names:
        assert port.embedding(n).tolist() == ref["embeddings"][n]


def test_answers_equal_the_references(both):
    """Names, distances (bit-equal) and matched fractions."""
    got = both["port"].query_batch(both["queries"])
    assert len(got) == len(both["ref"]["answers"])
    for g, w in zip(got, both["ref"]["answers"]):
        assert g.name == w["name"]
        assert g.distance == w["distance"]
        assert g.distances == w["distances"]
        assert g.matched_frac == w["matched_frac"]


@pytest.mark.parametrize("chip", sorted(REF_CHIPS))
def test_predict_profile_under_the_references_chips(both, chip):
    """Within 1e-12 relative, every per-rank term, the band and the
    bottleneck; speedup against the reference's reference chip (v5e)."""
    spec = REF_CHIPS[chip]
    for name, res in both["port"].corpus.results.items():
        got = predict_profile(res.proxy.module, spec, ref_chip=REF_CHIPS["v5e"])
        want = both["ref"]["profiles"][f"{name}@{chip}"]
        for k in ("t_compute", "t_memory", "t_collective", "t_total",
                  "t_std"):
            np.testing.assert_allclose(getattr(got, k), want[k],
                                       rtol=PROFILE_RTOL, atol=0, err_msg=k)
        assert list(got.bottleneck) == want["bottleneck"]
        assert got.speedup_vs_ref == pytest.approx(want["speedup_vs_ref"],
                                                   rel=PROFILE_RTOL)


def test_h100_prediction_agrees_with_the_walker(both):
    """On the port's reference chip the compute and memory terms equal the
    walker's rank totals mapped through HloCost.from_metric_vector, where
    no loop is counted (1e-12 relative); where one is, they fall short of
    the walker by its bookkeeping, exactly as the reference's predictor
    does on the same store: both packages' terms and walker totals agree
    to 1e-12 relative, so the gap is the reference's."""
    chip = CHIPS[REFERENCE_CHIP]
    assert REFERENCE_CHIP == "h100"
    for name, res in both["port"].corpus.results.items():
        pred = predict_profile(res.proxy.module, "h100")
        assert pred.speedup_vs_ref == pytest.approx(1.0, rel=WALKER_RTOL)
        ref_rows = both["ref"]["walker"][name]
        gaps = []
        for i in range(res.proxy.module.N_RANKS):
            hc = HloCost.from_metric_vector(res.proxy.rank_metrics(i))
            row = [pred.t_compute[i], hc.flops / chip.peak_flops,
                   pred.t_memory[i], hc.bytes / chip.hbm_bw]
            np.testing.assert_allclose(row, ref_rows[i], rtol=WALKER_RTOL,
                                       atol=0, err_msg=f"{name} rank {i}")
            gaps += [abs(row[0] - row[1]) / row[1],
                     abs(row[2] - row[3]) / row[3]]
        assert max(gaps) <= WALKER_LOOP_GAP, name
        if name == "flash-ring-8":
            assert max(gaps) > WALKER_RTOL        # its loops are counted
        else:
            assert max(gaps) <= WALKER_RTOL, name


def test_the_walker_charges_flash_rings_loop_bookkeeping(both):
    """Pins the gap the test above allows, in the units both sides count:
    rank 0 of flash-ring at 8 ranks."""
    from repro_torch.core.portability import _rank_counts, _terminal_costs
    res = both["port"].corpus.results["flash-ring-8"]
    flops, mem, _ = _terminal_costs(res.proxy.module)
    ct = _rank_counts(res.proxy.module)[0]
    hc = HloCost.from_metric_vector(res.proxy.rank_metrics(0))
    assert (float(flops @ ct), hc.flops) == (4_481_200.0, 4_481_214.0)
    assert (hc.bytes - float(mem @ ct)) / hc.bytes == pytest.approx(
        2.0835e-5, rel=1e-4)


def test_the_h100_envelope_is_the_metrics_constants():
    """The h100 envelope is the one the port's roofline constants use, and
    a faster card predicts a faster step."""
    from repro_torch.core import metrics
    h100 = CHIPS["h100"]
    assert (h100.peak_flops, h100.hbm_bw, h100.ici_bw) == (
        metrics.PEAK_FLOPS_BF16, metrics.HBM_BW, metrics.ICI_BW)
    assert set(CHIPS) == {"h100", "a100", "h200"}


def test_predict_all_orders_the_cards(both):
    res = both["port"].corpus.results["heavy"]
    preds = predict_all(res.proxy.module)
    assert set(preds) == set(CHIPS)
    assert preds["a100"].step_time > preds["h100"].step_time
    assert preds["h200"].step_time <= preds["h100"].step_time
    for p in preds.values():
        lo, hi = p.band()
        assert np.all(lo <= p.t_total) and np.all(p.t_total <= hi)


# ---------------------------------------------------------------------------
# the reference's serve invariants, on the port (CPU)
# ---------------------------------------------------------------------------


def test_query_nearest_is_self(svc):
    for name, vecs, kind in (("heavy", [_V3, _V3, _V1], "psum"),
                             ("light", [_V2, _V2], "all_gather")):
        ans = svc.query(_store(vecs, kind=kind))
        assert ans.name == name
        assert ans.distance == pytest.approx(0.0, abs=1e-12)
        assert ans.matched_frac == 1.0


def test_query_novel_trace_falls_back(svc):
    novel = tuple(v * 1.7 + 13.0 for v in _V3)
    ans = svc.query(_store([novel, novel, _V3]))
    assert ans.name in svc.corpus.results
    assert 0.0 < ans.matched_frac < 1.0
    assert set(ans.distances) == {"heavy", "light", "mixed"}


def test_query_returns_loadable_module_and_profile(svc):
    ans = svc.query(_store([_V3, _V3, _V1]), chip="h200")
    mod = load_saved_module(ans.module_path, name="reloaded_proxy")
    assert mod.TERMINALS == ans.module.TERMINALS
    assert ans.profile.chip == "h200"
    assert ans.profile.step_time > 0.0
    assert np.all(ans.profile.t_total >= 0.0)


def test_query_is_query_batch_of_one(svc):
    traces = [_store([_V3, _V3, _V1]), _store([_V1, _V2, _V3]),
              _store([tuple(v * 1.7 + 13.0 for v in _V3), _V3])]
    for t in traces:
        a, b = svc.query(t), svc.query_batch([t])[0]
        assert (a.name, a.distance, a.distances, a.matched_frac) == (
            b.name, b.distance, b.distances, b.matched_frac)
        assert a.module is b.module and a.profile is b.profile


def test_hot_path_answers_from_cache(svc, monkeypatch):
    """After warm-up, the cold path is poisoned (Sequitur, the fits,
    codegen, corpus synthesis itself) and queries still answer."""
    def _boom(*a, **kw):
        raise AssertionError("cold path entered on a warm query")

    import repro_torch.core.codegen as codegen
    import repro_torch.core.synthesize as synth_mod
    monkeypatch.setattr(sequitur, "compress", _boom)
    monkeypatch.setattr(sequitur.Sequitur, "push", _boom, raising=True)
    monkeypatch.setattr(proxy_search, "fit_batch", _boom)
    monkeypatch.setattr(proxy_search, "fit_combination", _boom)
    monkeypatch.setattr(codegen, "generate_source", _boom)
    monkeypatch.setattr(synth_mod, "generate_source", _boom)
    monkeypatch.setattr(synth_mod, "synthesize_corpus", _boom)
    q0 = svc.stats["n_queries"]
    for _ in range(5):
        assert svc.query(_store([_V1, _V2, _V3])).name == "mixed"
    assert svc.stats["n_warm_synthesis"] == 1
    assert svc.stats["n_queries"] == q0 + 5
    assert svc.stats["n_module_cache_hits"] == svc.stats["n_queries"]


def test_profile_cache_memoizes_per_chip(svc):
    h0 = svc.stats["n_profile_cache_hits"]
    m0 = svc.stats["n_profile_cache_misses"]
    p1 = svc.predict_profile("heavy", "a100")
    p2 = svc.predict_profile("heavy", "a100")
    assert p1 is p2
    assert svc.stats["n_profile_cache_misses"] == m0 + 1
    assert svc.stats["n_profile_cache_hits"] == h0 + 1
    for chip in CHIPS:
        assert svc.predict_profile("light", chip).chip == chip


def test_service_rejects_empty_store_bad_chip_and_no_card(tmp_path,
                                                          monkeypatch):
    cs = CorpusStore(tmp_path / "empty")
    with pytest.raises(ValueError, match="empty corpus"):
        ProxyService(cs, device="cpu")
    cs.add_scenario("a", _store([_V1]))
    with pytest.raises(ValueError, match="unknown chip"):
        ProxyService(cs, chip="v5e", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProxyService(cs)


def test_query_empty_trace_raises(svc):
    empty = TraceStore.from_rank_traces([[] for _ in range(4)], {"x": 4})
    q0 = svc.stats["n_queries"]
    with pytest.raises(ValueError, match="empty trace"):
        svc.query(empty)
    with pytest.raises(ValueError, match=r"batch index 1"):
        svc.query_batch([_store([_V1]), empty])
    assert svc.stats["n_queries"] == q0


def test_query_batch_matches_sequential(svc):
    novel = tuple(v * 1.7 + 13.0 for v in _V3)
    traces = [_store([_V3, _V3, _V1]), _store([_V2, _V2], kind="all_gather"),
              _store([novel, novel, _V3]), _store([_V1, _V2, _V3])]
    singles = [svc.query(t) for t in traces]
    for s, b in zip(singles, svc.query_batch(traces)):
        assert (b.name, b.distance, b.distances, b.matched_frac) == (
            s.name, s.distance, s.distances, s.matched_frac)
        assert b.module is s.module and b.profile is s.profile


def test_grammar_term_separates_schedules(tmp_path):
    inter, grouped = _store([_V1, _V2] * 6), _store([_V1] * 6 + [_V2] * 6)
    cs = CorpusStore(tmp_path / "corpus")
    cs.add_scenario("interleaved", inter)
    cs.add_scenario("grouped", grouped)
    svc = ProxyService(cs, out_dir=tmp_path / "modules", device="cpu")
    h0 = svc.stats["n_grammar_hist_hits"]
    a, b = svc.query_batch([_store([_V1, _V2] * 6),
                            _store([_V1] * 6 + [_V2] * 6)])
    assert a.name == "interleaved" and b.name == "grouped"
    assert a.distances["grouped"] > 1e-3
    assert svc.stats["n_grammar_hist_hits"] > h0
    m0 = svc.stats["n_grammar_hist_misses"]
    svc.query(_store([_V2, _V1] * 3))
    assert svc.stats["n_grammar_hist_misses"] > m0


def _mutable_svc(tmp_path, **kw):
    cs = CorpusStore(tmp_path / "corpus")
    for n, st in _small().items():
        cs.add_scenario(n, st)
    return cs, ProxyService(cs, out_dir=tmp_path / "modules", device="cpu",
                            **kw)


def test_refresh_matches_rebuilt_service(tmp_path):
    cs, svc = _mutable_svc(tmp_path)
    svc.query(_store([_V1, _V2, _V3]))
    cs.add_scenario("extra", _store([_V3, _V1], kind="all_to_all"))
    cs.remove_scenario("light")
    ans = svc.query(_store([_V3, _V1], kind="all_to_all"))
    assert ans.name == "extra"
    assert svc.stats["n_refresh"] == 1
    assert svc.stats["n_warm_synthesis"] == 1
    rebuilt = ProxyService(cs, out_dir=tmp_path / "modules", device="cpu")
    assert svc._names == rebuilt._names
    for n in rebuilt._names:
        assert np.array_equal(svc.embedding(n), rebuilt.embedding(n))
    a = svc.query(_store([_V1, _V2, _V3]))
    b = rebuilt.query(_store([_V1, _V2, _V3]))
    assert (a.name, a.distance, a.distances) == (b.name, b.distance,
                                                 b.distances)
    assert a.module is b.module
    svc.close(), rebuilt.close()


def test_refresh_reembeds_only_changed_scenarios(tmp_path):
    cs, svc = _mutable_svc(tmp_path)
    p_heavy = svc.predict_profile("heavy")
    cs.add_scenario("mixed2", _store([_V1, _V2, _V3]))
    svc.refresh()
    assert svc.stats["n_reembedded"] == 1
    assert svc.stats["n_profile_invalidated"] == 0
    assert svc.predict_profile("heavy") is p_heavy
    cs.remove_scenario("mixed2")
    svc.refresh()
    assert svc.stats["n_reembedded"] == 1
    svc.close()


def test_unsubscribed_service_fails_loudly_on_drift(tmp_path):
    cs, _ = _mutable_svc(tmp_path)
    svc = ProxyService(cs, out_dir=tmp_path / "modules", subscribe=False,
                       device="cpu")
    svc.query(_store([_V1, _V2, _V3]))
    cs.remove_scenario("mixed")
    with pytest.raises(StaleServiceError, match="fingerprint drifted"):
        svc.query(_store([_V1, _V2, _V3]))
    svc.refresh()
    assert svc.query(_store([_V3, _V3, _V1])).name == "heavy"


def test_concurrent_batches_interleaved_with_mutation(tmp_path, monkeypatch):
    cs, svc = _mutable_svc(tmp_path)
    svc.query(_store([_V1, _V2, _V3]))

    def _boom(*a, **kw):
        raise AssertionError("cold path entered during concurrent serving")

    monkeypatch.setattr(sequitur, "compress", _boom)
    monkeypatch.setattr(sequitur.Sequitur, "push", _boom, raising=True)
    monkeypatch.setattr(proxy_search, "fit_batch", _boom)
    monkeypatch.setattr(proxy_search, "fit_combination", _boom)
    errors: list[BaseException] = []
    traces = [_store([_V3, _V3, _V1]), _store([_V1, _V2, _V3])]

    def worker():
        try:
            for _ in range(4):
                for ans in svc.query_batch(traces):
                    assert ans.name in ("heavy", "mixed", "mixed2")
        except BaseException as e:                  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    q0 = svc.stats["n_queries"]
    for t in threads:
        t.start()
    for _ in range(2):
        cs.add_scenario("mixed2", _store([_V1, _V2, _V3]))
        svc.query(_store([_V1, _V2, _V3]))
        cs.remove_scenario("mixed2")
    for t in threads:
        t.join()
    assert not errors
    assert svc.stats["n_queries"] == q0 + 3 * 4 * 2 + 2
    assert svc.stats["n_warm_synthesis"] == 1
    assert svc.stats["n_refresh"] >= 1
    svc.close()


def test_ann_mode_matches_brute_force(tmp_path):
    cs = CorpusStore(tmp_path / "corpus")
    base = np.asarray([_V1, _V2, _V3])
    for i in range(9):
        vecs = [tuple(v) for v in base * (1.0 + 0.31 * i) + 7.0 * i]
        cs.add_scenario(f"s{i}", _store(vecs + [_V1 if i % 2 else _V2]))
    brute = ProxyService(cs, out_dir=tmp_path / "m1", ann_threshold=10 ** 6,
                         device="cpu")
    ann = ProxyService(cs, out_dir=tmp_path / "m2", ann_threshold=1,
                       device="cpu")
    assert brute._ann is None and ann._ann is not None
    queries = [_store([tuple(v) for v in base * (1.0 + 0.31 * i) + 7.0 * i])
               for i in range(9)] + [_store([_V1, _V1]), _store([_V3])]
    for rb, ra in zip(brute.query_batch(queries), ann.query_batch(queries)):
        assert ra.name == rb.name
        assert ra.distance == rb.distance
        assert set(ra.distances) == {ra.name}
        assert len(rb.distances) == 9
    brute.close(), ann.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ball_tree_is_brute_force_and_the_references(seed):
    """Exact: the same index and the same distance bits as the brute-force
    scan, and as the reference's tree."""
    rng = np.random.RandomState(seed)
    pts = rng.normal(size=(200, 29))
    pts[50:60] = pts[10]                            # ties
    tree, ref_tree = BallTree(pts), ref_ann.BallTree(pts)
    for q in np.concatenate([rng.normal(size=(30, 29)), pts[:5]]):
        want = brute_force_nearest(pts, q)
        assert tree.query(q) == want
        assert ref_tree.query(q) == want
        assert ref_ann.brute_force_nearest(pts, q) == want


def test_stage_timers_accumulate(svc):
    svc.query(_store([_V1, _V2, _V3]))
    for stage in ("match_ms", "featurize_ms", "distance_ms", "profile_ms"):
        assert svc.stats[stage] >= 0.0
    assert svc.stats["match_ms"] + svc.stats["featurize_ms"] > 0.0
