"""BENCHMARK.json against the benchmark's contract, and every piece of every
cell found by name."""
import json
import re

import pytest

from bench import core

BM = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_top_level_keys_and_size():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BM)) <= 64 * 1024
    assert 1 <= BM["run_seconds"] <= 51 and isinstance(BM["run_seconds"], int)
    assert 1 <= len(BM["command"]) <= 32
    for word in BM["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    for p in BM["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in BM[section]]
    assert len(names) == len(set(names))
    for e in BM[section]:
        extra = {"workloads"} if section == "end_to_end" else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        if "better" in e:
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert LINE.match(e[k]), e[k]


def test_metrics_cover_every_cell():
    cells = {w["name"] for w in BM["workloads"]}
    assert {m["name"] for m in BM["end_to_end"]} >= {"setup_s"}
    for m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        e2e = {m["name"] for m in core.end_to_end_of(BM, w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = core.per_layer_of(BM, w)
        assert per and all(m["moves"] in e2e for m in per)
    layers = {}
    for m in BM["per_layer"]:
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter")
        assert m["moves"] in {e["name"] for e in BM["end_to_end"]}
        assert m["workloads"] and set(m["workloads"]) <= cells
        layers.setdefault(m["layer"], m["layer"])


def test_cells_and_configs():
    configs = {c["name"]: c for c in BM["configs"]}
    files = [c["file"] for c in BM["configs"]]
    assert len(files) == len(set(files))
    used = set()
    for w in BM["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        used.add(w["config"])
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in BM["workloads"]) <= max(
        1, len(BM["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BM["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cfg", [c["name"] for c in BM["configs"]])
def test_configuration_file_is_what_runs(cfg):
    entry = next(c for c in BM["configs"] if c["name"] == cfg)
    assert entry["file"] == f"bench/configs/{cfg}.json"
    sizes = core.config_file(cfg)
    assert sorted(sizes["reduced"]) == sorted(entry["reduced"])
    for k in entry["reduced"]:
        assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    arch = core.arch_config(sizes)
    for k, v in sizes.items():
        if hasattr(arch, k) and k != "name":
            got = getattr(arch, k)
            assert (list(got) if isinstance(got, tuple) else got) == v, k
    assert len(sizes["source"]) <= 200 and sizes["departures"]


@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_every_piece_found_by_name(cell):
    w = core.cell(BM, cell)
    traffic = core.traffic_file(w["traffic"])
    driver = core.driver(traffic["kind"])
    assert callable(driver.run)
    sizes = core.config_file(w["config"])
    fam = core.family(sizes)
    assert callable(fam.param_specs) and callable(fam.layer)
    checks = core.checks_file(cell)
    assert checks["limits"] and all(v > 0 for v in checks["limits"].values())
    by_name = {m["name"]: m for m in BM["per_layer"]}
    for m in core.per_layer_of(BM, cell):
        mod = core.metric(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["unit"], m["layer"], m["moves"])
        assert callable(mod.read) and by_name[m["name"]] is m


@pytest.mark.parametrize("cfg", [c["name"] for c in BM["configs"]])
def test_input_tree_is_the_ports_parameter_tree(cfg):
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import init_params
    from bench import weights
    sizes = core.config_file(cfg)
    specs = core.family(sizes).param_specs(sizes)
    meta = init_params(core.arch_config(sizes), 0, "meta")
    ours = list(weights.tree_items(specs))
    theirs = tree_leaves(meta)
    assert len(ours) == len(theirs)
    for (path, s), t in zip(ours, theirs):
        assert tuple(s.shape) == tuple(t.shape), path
        assert s.dtype == str(t.dtype).replace("torch.", ""), path
