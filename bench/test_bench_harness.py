"""Whole runs on the CPU at smoke size (the harness's look for a card
skipped): sound runs come out correct, the plain references agree with the
port, and the command refuses to run without a card or outside a
checkout."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import core, smoke, verdict
from bench.drivers import prefill
from bench.reference import common

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in core.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r, out = smoke.run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(
        r.checks["limits"])
    assert out["attempted"] > 0 and out["failed"] == 0
    # f32 against f32: far inside every limit
    for k, c in out["checks"].items():
        assert c["value"] < 1e-4, (k, c)
    assert out["device"]["window_s"] > 0
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_the_cells_end_to_end_metrics(cell):
    r, out = smoke.run(cell)
    want = {m["name"] for m in core.end_to_end_of(r.bm, cell)}
    assert set(out["metrics"]) == want and "setup_s" in want
    assert out["metrics"]["setup_s"]["value"] == r.setup_s > 0
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_control_and_faults_are_judged_as_a_run_is():
    from bench.control import judged
    r, out = smoke.run("mamba2-2.7b.prefill")
    sound = {k: c["value"] for k, c in out["checks"].items()}
    assert judged(r, sound) == {"correct": True, "checks": out["checks"]}
    over = dict(sound, logit_err=2 * r.checks["limits"]["logit_err"])
    assert judged(r, over)["correct"] is False
    assert out["correct"] is True and r.correct()


@pytest.mark.parametrize("cell", ["deepseek-moe-16b.train",
                                  "deepseek-moe-16b.prefill"])
def test_reference_routes_as_the_port_where_experts_overflow(cell):
    from repro_torch.models.moe import capacity
    r, out = smoke.run(cell, capacity_factor=1.0)
    assert all(c["value"] < 1e-4 for c in out["checks"].values()), out
    # Zipf tokens overflow some expert at this capacity: the drop ran
    tokens = 2 * 64 if r.traffic["kind"] == "train" else 256
    assert capacity(tokens, r.cfg.top_k, r.cfg.n_experts, 1.0) < tokens


@pytest.mark.parametrize("cell", ["mamba2-2.7b.prefill",
                                  "deepseek-moe-16b.prefill"])
def test_reference_prefill_logits_are_the_ports(cell):
    from repro_torch.models.model import build_forward
    from bench import weights
    r, _ = smoke.run(cell)
    toks = prefill.prompts(r.traffic, r.sizes["vocab"], 5, 128, 0)
    tree = weights.make(r.family.param_specs(r.sizes), r.seed, "cpu")
    with torch.no_grad():
        want, _ = build_forward(r.cfg, "prefill")(
            tree, {"tokens": torch.as_tensor(toks)}, r.cfg)
    got = prefill.reference_logits(r, [toks])[0]
    assert float(verdict.logit_errors(want, got).max()) < 1e-5


def test_control_reads_far_above_the_program():
    from bench.drivers import train
    r, out = smoke.run("mamba2-2.7b.train")
    ds = train.build(r)[3]
    ref = train.reference_readings(r, ds, 3)
    fp8 = train.reference_readings(r, ds, 3, common.Numerics(True))
    ctrl = verdict.train_numbers(fp8, ref)
    assert ctrl["grad_slice"] > 100 * out["checks"]["grad_slice"]["value"]


def test_two_pass_step_is_the_one_pass_step():
    from bench import weights
    from bench.drivers import train
    r, _ = smoke.run("deepseek-moe-16b.train")
    ds = train.build(r)[3]
    specs = r.family.param_specs(r.sizes)
    batches = [tuple(torch.as_tensor(ds.batch_at(i)[k]) for k in
                     ("tokens", "labels")) for i in range(2)]
    got = [common.train_steps(r.family, r.sizes, weights.make(specs, 9, "cpu"),
                              batches, r.traffic["optimizer"],
                              train._start_of(specs, 9, "cpu"),
                              two_pass=two) for two in (False, True)]
    assert got[0]["loss"] == pytest.approx(got[1]["loss"], rel=1e-6)
    for k in ("grad1", "change"):
        assert got[0][k] == pytest.approx(got[1][k], rel=1e-5, abs=1e-9)


def _cli(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _cli(ROOT, "--workload", CELLS[0], "--seed", str(smoke.SEED),
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_outside_a_checkout_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path, "--workload", CELLS[0], "--seed", "1", "--seconds",
             "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
