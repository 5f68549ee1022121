"""The reference's walk over the port's whole layer list and the model-FLOP
count layer by layer, on the CPU: the walk's layers are the port's in its
order, every slice key names one slice, the one-kind trees keep their keys,
and a family of two layer kinds, defined in this file alone, runs through
the harness's prefill and train paths and agrees with the port."""
import dataclasses
import math
import re
from types import SimpleNamespace

import pytest
import torch

from bench import core, smoke, verdict, weights, yardstick
from bench.drivers import prefill, train
from bench.reference import common, deepseek_moe, mamba2


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _multi_kind():
    """(arch, n_layers or None) of every decoder-only registry config whose
    smoke cut has several unit positions or rest layers, and two depths
    that leave rest layers."""
    from repro_torch.configs import ARCH_IDS, get
    from repro_torch.configs import smoke as cut
    from repro_torch.models.transformer import unit_len
    out = []
    for a in ARCH_IDS:
        c = cut(get(a))
        if c.family != "encdec" and (unit_len(c) > 1
                                     or c.n_layers % unit_len(c)):
            out.append((a, None))
    return out + [("jamba-v0.1-52b", 19), ("gemma3-4b", 13)]


def _port_tree(arch, n_layers):
    from repro_torch.configs import get
    from repro_torch.configs import smoke as cut
    from repro_torch.models.model import init_params
    cfg = cut(get(arch))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, init_params(cfg, 0, "cpu")


def _slice_of(tree, key):
    """The leaf slice a key names (a one-kind tree's keys lie inside the
    unit)."""
    path, index = re.fullmatch(r"(.+?)(?:\[(\d+)\])?", key).groups()
    if path not in common.TOP and not path.startswith(("unit.", "rest.")):
        path = "unit.0." + path
    leaf = common._leaf(tree, path)
    return leaf if index is None else leaf[int(index)]


def _slices_named_once(tree):
    keys = common.slice_norms(tree)
    n = len(common.TOP)
    for sub in tree["unit"]:
        n += sum(t.shape[0] for _, t in weights.tree_items(sub))
    n += sum(len(list(weights.tree_items(sub))) for sub in tree["rest"])
    assert len(keys) == n
    for k, v in keys.items():
        assert float(_slice_of(tree, k).float().norm()) == v, k
    return keys


@pytest.mark.parametrize("arch,n_layers", _multi_kind())
def test_walk_is_the_ports_layer_order(arch, n_layers):
    from repro_torch.models.transformer import _index, _layers
    cfg, tree = _port_tree(arch, n_layers)
    ours = common.layers(tree)
    theirs = list(_layers(cfg, tree))
    assert len(ours) == len(theirs) == cfg.n_layers
    for (pos, index, sub), (_, i, j, psub) in zip(ours, theirs):
        assert (pos, index) == (f"unit.{j}" if i is not None
                                else f"rest.{j}", i)
        got = common.layer_of(sub, index)
        want = dict(weights.tree_items(_index(psub, i)))
        assert list(got) == list(want)
        for p, t in got.items():
            u = want[p]
            assert (t.data_ptr(), t.shape, t.stride()) == \
                (u.data_ptr(), u.shape, u.stride()), (pos, index, p)
    keys = _slices_named_once(tree)
    assert all(k in common.TOP or k.startswith(("unit.", "rest."))
               for k in keys)


@pytest.mark.parametrize("cfg", [c["name"] for c in
                                 core.benchmark()["configs"]])
def test_one_kind_trees_keep_their_keys(cfg):
    from repro_torch.configs import smoke as cut
    sizes = core.config_file(cfg)
    sz = core.sizes_of(cut(core.arch_config(sizes)), sizes)
    specs = core.family(sz).param_specs(sz)
    tree = weights.make(specs, smoke.SEED, "cpu")
    n = sz["n_layers"]
    today = set(common.TOP) | {f"{p}[{i}]" for p, _ in
                               weights.tree_items(tree["unit"][0])
                               for i in range(n)}
    assert set(_slices_named_once(tree)) == today
    start = train._start_of(specs, smoke.SEED, "cpu")
    assert set(common.change_norms(tree, start)) == today


# ---------------------------------------------------------------------------
# a family of two layer kinds, defined here alone
# ---------------------------------------------------------------------------

def _restack(specs, n):
    """Layer specs stacked ``n`` deep (None: one unstacked layer)."""
    lead = () if n is None else (n,)
    return weights.tree_map(
        lambda s: dataclasses.replace(s, shape=lead + s.shape[1:]), specs)


def _hybrid_specs(sz):
    """The port's tree of an SSM-or-attention pattern with MoE layers,
    each leaf drawn as the two families draw it."""
    ssm = mamba2.param_specs(sz)
    moe = deepseek_moe.param_specs(sz)
    pat, every = sz["layer_pattern"], sz["moe_every"]
    u = min(math.lcm(len(pat), every), sz["n_layers"])
    n_units = sz["n_layers"] // u

    def one(li, n):
        src = ssm if pat[li % len(pat)] == "m" else moe
        mix = "mixer" if "mixer" in src["unit"][0] else "attn"
        layer = {"ln1": src["unit"][0]["ln1"], mix: src["unit"][0][mix]}
        if li % every == sz["moe_offset"]:
            layer.update(ln2=moe["unit"][0]["ln2"], moe=moe["unit"][0]["moe"])
        return _restack(layer, n)

    return {"embed": moe["embed"], "final_norm": moe["final_norm"],
            "unit": tuple(one(j, n_units) for j in range(u)),
            "rest": tuple(one(n_units * u + j, None)
                          for j in range(sz["n_layers"] % u))}


def _hybrid_layer(sz, w, x, num):
    """One layer; its kind from the keys of ``w``."""
    h = common.rms_norm(x, w["ln1"])
    if "mixer" in w:
        x = x + mamba2.mixer(sz, w["mixer"], h, num)
    else:
        x = x + deepseek_moe.attention(sz, w["attn"], h, num)
    if "moe" not in w:
        return x, 0.0
    y, aux = deepseek_moe.moe(sz, w["moe"], common.rms_norm(x, w["ln2"]),
                              num)
    return x + y, aux


HYBRID = SimpleNamespace(param_specs=_hybrid_specs, layer=_hybrid_layer)


def _tightest(*cells):
    """The cells' checks with each limit the least any of them sets."""
    checks = [core.checks_file(c) for c in cells]
    limits = {}
    for c in checks:
        for k, v in c["limits"].items():
            limits[k] = min(v, limits.get(k, v))
    return dict(checks[-1], limits=limits)


@pytest.fixture
def hybrid(monkeypatch):
    """The benchmark with two cells of the two-kind toy (DeepSeek-MoE 16B's
    sizes with a Mamba2 mixer in every other layer), found by name as any
    cell is."""
    bm, config_file, checks_file, family = (
        core.benchmark(), core.config_file, core.checks_file, core.family)
    base = config_file("deepseek-moe-16b")
    sizes = dict(base, reference="hybrid_toy", layer_pattern=["m", "g"],
                 ssm_state=128, ssm_head_dim=64, ssm_groups=1, ssm_expand=2,
                 ssm_chunk=256, conv_width=4)
    sizes["reduced"] = {k: "a two-kind toy" for k in
                        ("layer_pattern", "ssm_state", "ssm_head_dim",
                         "ssm_chunk")}
    for kind in ("train", "prefill"):
        cell = f"hybrid-toy.{kind}"
        bm["workloads"].append({"name": cell, "config": "hybrid-toy",
                                "traffic": kind, "chips": 1})
        for m in bm["end_to_end"] + bm["per_layer"]:
            if m["name"] in (f"{kind}_tokens_per_s", f"{kind}_mfu"):
                m["workloads"].append(cell)
    checks = {"hybrid-toy.train": _tightest("mamba2-2.7b.train",
                                            "deepseek-moe-16b.train"),
              "hybrid-toy.prefill": _tightest("mamba2-2.7b.prefill",
                                              "deepseek-moe-16b.prefill")}
    monkeypatch.setattr(core, "benchmark", lambda: bm)
    monkeypatch.setattr(core, "config_file", lambda name: dict(sizes)
                        if name == "hybrid-toy" else config_file(name))
    monkeypatch.setattr(core, "checks_file", lambda name: checks.get(
        name) or checks_file(name))
    monkeypatch.setattr(core, "family", lambda sz: HYBRID
                        if sz["reference"] == "hybrid_toy" else family(sz))
    return dict(n_layers=5)         # two units of (m, g) and one rest m


def test_hybrid_tree_is_the_ports(hybrid):
    from repro_torch.models.model import init_params
    r, _ = smoke.run("hybrid-toy.prefill", **hybrid)
    assert r.family is HYBRID and r.cfg.layer_kinds() == list("mgmgm")
    specs = weights.tree_items(HYBRID.param_specs(r.sizes))
    port = weights.tree_items(init_params(r.cfg, 0, "meta"))
    for (p, s), (q, t) in zip(specs, port, strict=True):
        assert p == q and s.shape == tuple(t.shape), p
        assert s.dtype == str(t.dtype).replace("torch.", ""), p
    assert {p.split(".")[0] + "." + p.split(".")[1] for p, _ in
            weights.tree_items(HYBRID.param_specs(r.sizes))
            if p.startswith(("unit", "rest"))} == {"unit.0", "unit.1",
                                                   "rest.0"}


def test_hybrid_prefill_runs_and_its_logits_are_the_ports(hybrid):
    from repro_torch.models.model import build_forward
    r, out = smoke.run("hybrid-toy.prefill", trace=True, **hybrid)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"token_gap", "logit_err",
                                  "logit_err_len_median"}
    assert out["metrics"]["prefill_mfu"]["value"] > 0
    toks = prefill.prompts(r.traffic, r.sizes["vocab"], 5, 128, 0)
    tree = weights.make(HYBRID.param_specs(r.sizes), r.seed, "cpu")
    with torch.no_grad():
        want, _ = build_forward(r.cfg, "prefill")(
            tree, {"tokens": torch.as_tensor(toks)}, r.cfg)
    got = prefill.reference_logits(r, [toks])[0]
    assert float(verdict.logit_errors(want, got).max()) < 1e-5


def test_hybrid_train_steps_pass_the_train_cells_limits(hybrid):
    r, out = smoke.run("hybrid-toy.train", trace=True, **hybrid)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss", "grad_norm", "grad_slice",
                                  "change_slice"}
    for k, c in out["checks"].items():
        assert c["value"] < 1e-4, (k, c)
    assert out["metrics"]["train_mfu"]["value"] > 0
    ds = train.build(r)[3]
    ref = train.reference_readings(r, ds, 3)
    assert len(ref["loss"]) == 3 and set(ref["grad1"]) == set(ref["change"])
    positions = {k.split(".")[0] + "." + k.split(".")[1]
                 for k in ref["grad1"] if k not in common.TOP}
    assert positions == {"unit.0", "unit.1", "rest.0"}
    assert "unit.0.mixer.in_proj[1]" in ref["grad1"]
    assert "rest.0.moe.router" in ref["change"]


# ---------------------------------------------------------------------------
# model FLOPs of two layer kinds
# ---------------------------------------------------------------------------

TOY = {"family": "hybrid", "layer_pattern": ["m", "g"], "n_layers": 3,
       "d_model": 4, "padded_vocab": 8, "ssm_expand": 2, "ssm_head_dim": 4,
       "ssm_state": 2, "ssm_groups": 1, "ssm_chunk": 2, "conv_width": 4,
       "head_dim": 2, "n_heads": 2, "n_kv_heads": 2, "n_experts": 4,
       "top_k": 2, "n_shared_experts": 1, "d_ff_expert": 3, "moe_every": 1,
       "moe_offset": 0}


def test_model_flops_of_two_layer_kinds_by_hand():
    # layers m, g, m.  SSM 168 (in_proj 4*22, out_proj 8*4, conv 4*12),
    # attention 4*2*(4+4) = 64, MoE router 16 + experts 3*4*3*(2+1) = 108
    ssm, attn, moe = 168, 64, 16 + 108
    per_token = 32 + 2 * (ssm + moe) + (attn + moe)
    assert yardstick.weights_per_token(TOY) == per_token
    # batch 1 of 4: the SSD 94 a token (diag 30, states 32, off 32) in each
    # SSM layer; attention's 4 * 2 heads * 2 * 10 pairs in the other
    fwd = 2 * per_token * 4 + 2 * 4 * 94 + 4 * 2 * 2 * 10
    assert yardstick.forward_flops(TOY, 1, 4) == fwd
    assert yardstick.train_step_flops(TOY, 1, 4) == 3 * fwd
    # MoE every other layer from the second: layer 1 alone
    sparse = dict(TOY, moe_every=2, moe_offset=1)
    assert yardstick.weights_per_token(sparse) == 32 + 2 * ssm + attn + moe


def test_a_family_brings_its_own_layer_count(monkeypatch):
    fam = SimpleNamespace(
        layer_weights=lambda sz, i: 10 * (i + 1),
        layer_flops=lambda sz, i, b, s: float(i * b * s))
    family = core.family
    monkeypatch.setattr(core, "family", lambda sz: fam
                        if sz["reference"] == "counted" else family(sz))
    sz = dict(TOY, reference="counted")
    assert yardstick.weights_per_token(sz) == 32 + 10 + 20 + 30
    assert yardstick.forward_flops(sz, 2, 5) == \
        2 * 92 * 10 + (0 + 1 + 2) * 10
    # the two families in the benchmark give none: the rules above count
    for name in ("mamba2", "deepseek_moe"):
        assert yardstick._counts({"reference": name}) == (
            yardstick.layer_weights, yardstick.layer_flops)
