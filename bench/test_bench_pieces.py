"""The benchmark's own pieces on the CPU: its copy of the token stream, the
traffic that repeats from a seed, the seeded weights, the FLOP and byte
counts on shapes worked by hand, and the reading of a trace."""
import numpy as np
import pytest
import torch

from bench import core, kernel_counts, weights, yardstick
from bench.data import TokenDataset
from bench.drivers import prefill
from bench.trace import Trace

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (SEED, 11)])
def test_token_stream_is_the_ports_bit_for_bit(seed, step):
    from repro_torch.train.data import TokenDataset as Port
    a = TokenDataset(50280, 64, 4, seed).batch_at(step)
    b = Port(50280, 64, 4, seed).batch_at(step)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_prefill_traffic_repeats_from_a_seed_and_keeps_its_sizes():
    tr = core.traffic_file("prefill")
    one = [prefill.round_order(tr, SEED, k) for k in range(3)]
    assert one == [prefill.round_order(tr, SEED, k) for k in range(3)]
    other = prefill.round_order(tr, SEED + 1, 0)
    assert sorted(other) == sorted(one[0]) == prefill.round_lengths(tr)
    assert sum(L * (tr["token_budget"] // L) for L in one[0]) == \
        tr["token_budget"] * len(one[0])
    a = prefill.prompts(tr, 50280, SEED, 2048, 5)
    assert a.shape == (4, 2048)
    assert np.array_equal(a, prefill.prompts(tr, 50280, SEED, 2048, 5))
    assert not np.array_equal(a, prefill.prompts(tr, 50280, SEED, 2048, 6))
    batches = [{"length": L} for L in one[0] + one[1]]
    checks = {"check_batches": {"1024": 2, "4096": 1}}
    s = prefill.check_sample(tr, checks, SEED, batches)
    assert s == prefill.check_sample(tr, checks, SEED, batches)
    assert sorted(batches[i]["length"] for i in s) == [1024, 1024, 4096]


def test_seeded_weights_repeat_and_redraw_a_leaf_alone():
    S = weights.Spec
    specs = {"a": S((3, 4, 5), "normal", 0.5), "b": S((4,), "zeros"),
             "c": (S((200, 300), "normal", 0.02, dtype="float32"),
                   S((5,), "ones", dtype="float32")),
             "d": S((2000,), "log_uniform", 1.0, 16.0, dtype="float32"),
             "e": S((2000,), "dt_bias", 1e-3, 1e-1, dtype="float32")}
    t1, t2 = weights.make(specs, SEED, "cpu"), weights.make(specs, SEED, "cpu")
    items = list(weights.tree_items(specs))
    assert [p for p, _ in items] == ["a", "b", "c.0", "c.1", "d", "e"]
    for i, (path, s) in enumerate(items):
        got = dict(weights.tree_items(t1))[path]
        assert torch.equal(got, dict(weights.tree_items(t2))[path])
        assert torch.equal(got, weights.make_leaf(s, SEED, i, "cpu"))
    assert t1["a"].dtype == torch.bfloat16 and not t1["b"].any()
    assert torch.equal(t1["c"][1], torch.ones(5))
    assert abs(float(t1["c"][0].std()) - 0.02) < 0.001
    a = torch.exp(t1["d"])
    assert 1 <= float(a.min()) and float(a.max()) <= 16
    dt = torch.nn.functional.softplus(t1["e"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1001
    assert not torch.equal(weights.make(specs, SEED + 1, "cpu")["a"], t1["a"])


def test_ssd_diag_count_by_hand():
    # b 1, c 2, q 4, h 2, p 8, g 1, n 4; bf16 x/B/C, f32 dt/cum and output
    call = {"args": [{"shape": [1, 2, 4, 2, 8], "dtype": "bfloat16"},
                     {"shape": [1, 2, 4, 2], "dtype": "float32"},
                     {"shape": [1, 2, 4, 2], "dtype": "float32"},
                     {"shape": [1, 2, 4, 1, 4], "dtype": "bfloat16"},
                     {"shape": [1, 2, 4, 1, 4], "dtype": "bfloat16"}, 2],
            "kwargs": {"out_dtype": "float32"}}
    # pairs 10 a chunk: scores 2*2*10*4 = 160, product 2*2*10*2*8 = 640
    flops = 800
    ins = 128 * 2 + 16 * 4 * 2 + 32 * 2 * 2
    out = 128 * 4
    assert kernel_counts.ssd_diag(call) == pytest.approx(max(
        flops / 989e12, (ins + out) / 3.35e12))
    assert kernel_counts.ssd_diag(call, backward=True) == pytest.approx(max(
        2 * flops / 989e12, (2 * ins + out) / 3.35e12))


def test_flash_count_by_hand():
    q = {"shape": [2, 3, 4, 8], "dtype": "bfloat16"}
    k = {"shape": [2, 3, 2, 8], "dtype": "bfloat16"}
    call = {"args": [q, k, dict(k)], "kwargs": {"causal": True}}
    # 6 pairs: 4*2*4*8*6 = 1536 FLOP; bytes q 384, k 192, v 192, out 384
    assert kernel_counts.flash(call) == pytest.approx(max(
        1536 / 989e12, 1152 / 3.35e12))
    bwd = max(10 * 2 * 4 * 8 * 6 / 989e12,
              (2 * (384 + 192 + 192) + 2 * 384 + 2 * 4 * 3 * 4) / 3.35e12)
    assert kernel_counts.flash(call, backward=True) == pytest.approx(bwd)
    full = {"args": [q, k, dict(k)], "kwargs": {"causal": False}}
    assert kernel_counts.flash(full) == pytest.approx(max(
        4 * 2 * 4 * 8 * 9 / 989e12, 1152 / 3.35e12))


def test_model_flops_by_hand():
    ssm = {"family": "ssm", "d_model": 4, "n_layers": 2, "padded_vocab": 8,
           "ssm_expand": 2, "ssm_head_dim": 4, "ssm_state": 2,
           "ssm_groups": 1, "ssm_chunk": 2, "conv_width": 4}
    # d_in 8, h 2, gn 2: in_proj 4*22, out_proj 8*4, conv 4*12 = 168 a layer
    assert yardstick.weights_per_token(ssm) == 32 + 2 * 168
    # SSD a token: pairs 3/2, diag 2*1.5*(2 + 8) = 30, states 32, off 32
    assert yardstick.forward_flops(ssm, 1, 4) == pytest.approx(
        2 * 368 * 4 + 2 * 4 * 94)
    moe = {"family": "moe", "d_model": 4, "n_layers": 1, "padded_vocab": 8,
           "head_dim": 2, "n_heads": 2, "n_kv_heads": 2, "n_experts": 4,
           "top_k": 2, "n_shared_experts": 1, "d_ff_expert": 3}
    # head 32; attn 4*2*(4+4) = 64; router 16; experts 3*4*3*(2+1) = 108
    assert yardstick.weights_per_token(moe) == 32 + 64 + 16 + 108
    assert yardstick.train_step_flops(moe, 2, 3) == pytest.approx(
        3 * (2 * 220 * 6 + 2 * 4 * 2 * 2 * 6))


def _trace():
    ops = [(1, "bench.window", 10, 0.0, 100.0),
           (2, "bench.step", 10, 0.0, 100.0),
           (3, "bench.ssd_diag", 10, 10.0, 20.0),
           (4, "aten::mm", 10, 12.0, 13.0),
           (5, "aten::add", 10, 30.0, 31.0),
           (6, "bench.ssd_diag.bwd", 11, 40.0, 60.0),
           (7, "aten::mul", 11, 41.0, 42.0)]
    # a kernel launched through ctypes inside bench.ssd_diag: placed by
    # its runtime call (10, 15.0), linked to no op
    dev = [("k_mm", 15.0, 25.0, (10, 12.5), 4),
           ("k_ssd", 26.0, 27.0, (10, 15.0), 0),
           ("k_add", 30.0, 35.0, (10, 30.5), 5),
           ("k_mul", 50.0, 70.0, (11, 41.5), 7),
           ("k_late", 65.0, 80.0, (10, 30.8), 5)]
    return Trace(ops, dev, (0.0, 100.0))


def test_trace_reading_on_a_hand_made_trace():
    t = _trace()
    assert t.window_s() == pytest.approx(1e-4)
    assert t.busy_s() == pytest.approx((10 + 1 + 5 + 30) * 1e-6)
    assert t.top_device_ops(2) == [["k_mul", pytest.approx(2e-5)],
                                   ["k_late", pytest.approx(1.5e-5)]]
    gaps = dict(t.idle_gaps())
    assert gaps["bench.ssd_diag > aten::mm"] == pytest.approx(15e-6)
    assert gaps["bench.ssd_diag > launch"] == pytest.approx(1e-6)
    assert gaps["bench.step > aten::add"] == pytest.approx(3e-6)
    assert gaps["bench.ssd_diag.bwd > aten::mul"] == pytest.approx(15e-6)
    assert gaps["end of window"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(1e-4 - t.busy_s())


def test_roofline_is_bounds_over_the_calls_event_time():
    from types import SimpleNamespace
    call = {"args": [{"shape": [1, 2, 4, 2, 8], "dtype": "bfloat16"},
                     {"shape": [1, 2, 4, 2], "dtype": "float32"},
                     {"shape": [1, 2, 4, 2], "dtype": "float32"},
                     {"shape": [1, 2, 4, 1, 4], "dtype": "bfloat16"},
                     {"shape": [1, 2, 4, 1, 4], "dtype": "bfloat16"}, 2],
            "kwargs": {"out_dtype": "float32"}}

    class FakeHooks:
        calls = {"ssd_diag": [call, call]}

        @staticmethod
        def event_ms(attr, backward=False):
            return [0.002, 0.002, 0.004] if backward else [0.001, 0.003]

    r = SimpleNamespace(hooks=FakeHooks())
    fwd = kernel_counts.ssd_diag(call)
    assert kernel_counts.roofline(r, "ssd_diag", kernel_counts.ssd_diag) == \
        pytest.approx(100 * 2 * fwd / 4e-6)
    bwd = kernel_counts.ssd_diag(call, backward=True)
    assert kernel_counts.roofline(r, "ssd_diag", kernel_counts.ssd_diag,
                                  backward=True) == \
        pytest.approx(100 * 3 * bwd / 8e-6)
    assert kernel_counts.roofline(SimpleNamespace(hooks=None), "ssd_diag",
                                  kernel_counts.ssd_diag) is None


def test_union_length():
    assert yardstick.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_median_by_length_and_the_worst_by_hand():
    from bench import verdict
    err = torch.tensor([0.1, 0.3, 0.2, 0.9, 0.5, 0.7])
    lengths = torch.tensor([64, 64, 64, 128, 128, 256])
    got = verdict.median_by_group(err, lengths)
    assert got == pytest.approx({64: 0.2, 128: 0.7, 256: 0.7})
    assert verdict.worst(got.values()) == pytest.approx(0.7)
    nan = verdict.median_by_group(torch.tensor([0.1, float("nan")]),
                                  torch.tensor([64, 128]))
    assert verdict.worst(nan.values()) != verdict.worst(nan.values())
