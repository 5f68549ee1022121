"""The reader of the program's spans and counters (``bench/spans.py``): the
idle attribution on a hand-made trace with ``repro.`` ranges, worked by
hand; the readers on recorded contents; and two traced smoke runs in one
process, which each read their own spans alone."""
from types import SimpleNamespace

import pytest
import torch

from bench import core, smoke, spans
from bench.trace import Trace

CUDA = torch.device("cuda")


def _trace():
    # one generate: the prompt's upload, prefill (routing inside), the
    # re-home, the argmax; then a launch outside every span
    ops = [(1, "bench.window", 10, 0.0, 100.0),
           (2, "repro.serve.generate", 10, 0.0, 90.0),
           (3, "repro.serve.prefill", 10, 5.0, 40.0),
           (4, "aten::mm", 10, 10.0, 11.0),
           (5, "repro.moe.route", 10, 20.0, 30.0),
           (6, "aten::sort", 10, 22.0, 23.0),
           (7, "repro.serve.rehome", 10, 45.0, 60.0),
           (8, "aten::fill_", 10, 46.0, 47.0),
           (9, "aten::copy_", 10, 50.0, 51.0),
           (10, "aten::argmax", 10, 70.0, 71.0)]
    dev = [("k_upload", 2.0, 4.0, (10, 1.0), 0),     # gap 0-2: engine
           ("k_mm", 12.0, 20.0, (10, 10.5), 4),      # gap 4-12: prefill
           ("k_sort", 25.0, 35.0, (10, 22.5), 6),    # 20-25: prefill
           ("k_fill", 55.0, 58.0, (10, 46.5), 8),    # 35-55: re-home
           ("k_copy", 58.0, 62.0, (10, 50.5), 9),    # no gap
           ("k_argmax", 72.0, 75.0, (10, 70.5), 10),  # 62-72: engine
           ("k_late", 80.0, 85.0, (10, 95.0), 0),    # 75-80: outside
           ("k_unplaced", 86.0, 87.0, None, 0)]      # 85-86: unplaced
    return Trace(ops, dev, (0.0, 100.0))             # 87-100: the end


def test_idle_attribution_on_a_hand_made_trace():
    t = _trace()
    r = SimpleNamespace(device=CUDA, trace_data=t)
    idle = 100.0 * (1.0 - t.busy_s() / t.window_s())
    assert idle == pytest.approx(2 + 8 + 5 + 20 + 10 + 5 + 1 + 13)
    engine = spans.idle_share(r, "serve.generate", "serve.prefill")
    forward = spans.idle_share(r, "serve.prefill")
    assert engine == pytest.approx(2 + 20 + 10)
    assert forward == pytest.approx(8 + 5)
    assert spans.idle_share(r, "moe.route") == pytest.approx(5)
    assert engine + forward <= idle
    got = dict(spans.idle_gaps(t))
    assert got == pytest.approx({
        "serve.generate > serve.rehome | aten::fill_": 20e-6,
        "serve.generate | aten::argmax": 10e-6,
        "serve.generate > serve.prefill | aten::mm": 8e-6,
        "serve.generate > serve.prefill > moe.route | aten::sort": 5e-6,
        "outside | launch": 6e-6,
        "serve.generate | launch": 2e-6})
    # no such range, no card, no trace: nothing to read
    assert spans.idle_share(r, "train.forward") is None
    assert spans.idle_share(SimpleNamespace(device=torch.device("cpu"),
                                            trace_data=t),
                            "serve.prefill") is None
    assert spans.idle_share(SimpleNamespace(device=CUDA, trace_data=None),
                            "serve.prefill") is None


def _run(device, dropped=0):
    recorded = {"spans": {"serve.generate": {"calls": 4, "device_ms": 400.0},
                          "ssm.mixer": {"calls": 8, "device_ms": 30.0},
                          "ssm.ssd_diag": {"calls": 8, "device_ms": 6.0},
                          "train.forward": {"calls": 2, "device_ms": 7.0}},
                "counts": {"moe.slots_kept": 3, "moe.slots": 12},
                "dropped": dropped}
    return SimpleNamespace(device=torch.device(device),
                           info={"spans": recorded},
                           traffic={"trace_steps": 2})


def test_readers_on_recorded_contents():
    r = _run("cuda")
    assert spans.per_step(r, spans.device_ms(r, "train.forward")) == 3.5
    assert spans.per_generate(r, spans.device_ms(r, "ssm.mixer")) == 7.5
    assert spans.share(r, "moe.slots_kept", "moe.slots") == 25.0
    assert spans.device_ms(r, "moe.route") is None
    assert spans.share(r, "moe.slots", "moe.other") is None
    mixer = core.metric("ssm_mixer_ms.prefill")
    assert mixer.read(r) == pytest.approx((30.0 - 6.0) / 4)
    for off in (_run("cpu"), _run("cuda", dropped=1)):
        assert spans.device_ms(off, "ssm.mixer") is None
        assert spans.share(off, "moe.slots_kept", "moe.slots") is None
        assert mixer.read(off) is None


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_two_traced_runs_read_their_own_spans(few_threads):
    from repro_torch import spans as recorder
    recorder.take()
    seen = []
    for cell in ["deepseek-moe-16b.prefill", "deepseek-moe-16b.prefill",
                 "deepseek-moe-16b.train"]:
        r, out = smoke.run(cell, trace=True)
        assert out["correct"]
        got = r.info["spans"]
        seen.append(got)
        assert got["dropped"] == 0
        calls = {k: v["calls"] for k, v in got["spans"].items()}
        layers = r.cfg.n_layers
        if r.traffic["kind"] == "prefill":
            n = sum(r.traffic["round"].values())    # one traced round
            assert calls == {"serve.generate": n, "serve.prefill": n,
                             "serve.rehome": n, "moe.route": n * layers}
        else:
            n = r.traffic["trace_steps"]
            assert calls == {"train.forward": n, "train.backward": n,
                             "moe.route": n * layers * (1 + r.cfg.remat)}
        assert 0 < got["counts"]["moe.slots_kept"] < \
            got["counts"]["moe.slots"]
    # one seed, one traffic: the same counts, run after run
    assert seen[0] == seen[1]
    assert recorder.take() == {"spans": {}, "counts": {}, "dropped": 0}
