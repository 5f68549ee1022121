"""The port's four example scripts, each run at ``--smoke --device cpu``.

The four run at once in subprocesses (a module fixture, about 10 s in all,
each with a 300 s limit), beside one run without ``--device``, which must
fail without a card; each test reads its script's exit code and printed
lines.  The quickstart's mean relative error is held to the reference's
``examples/quickstart.py`` on the same stencil (run in a subprocess on 8
forced host devices, 300 s limit), at the smoke length and the published
one.  On the card, ``chip_smoke.py`` runs the four at their published
sizes.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_pipeline_proxy",
            "torch_serve_and_proxy", "torch_train_e2e")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    extra = {"torch_quickstart": ["--out-dir", str(tmp / "proxies")],
             "torch_train_e2e": ["--ckpt-dir", str(tmp / "ckpt")]}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]), OMP_NUM_THREADS="2")
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--smoke",
         "--device", "cpu"] + extra.get(name, []),
        cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in EXAMPLES}
    # no --device: the card, which this machine does not have
    procs["default_device"] = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "torch_pipeline_proxy.py"),
         "--smoke"], cwd=str(tmp), env=dict(env, CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        out[name] = (p.returncode, stdout, stderr)
    return out, tmp


def _ok(runs, name) -> str:
    rc, stdout, stderr = runs[0][name]
    assert rc == 0, stderr[-3000:]
    return stdout


#: the quickstart's stencil lengths: ``--smoke`` and the published one
QUICKSTART_LENGTHS = (3, 12)


@pytest.fixture(scope="module")
def reference_quickstart(tmp_path_factory):
    """``{length: (delta_bar, comm_lossless)}`` of the reference's
    ``examples/quickstart.py``: its own source, executed with the scan
    length set, then its ``main``'s synthesis and fidelity."""
    out = run_reference("""
        import json
        src = Path("examples/quickstart.py").read_text()
        assert src.count("length=12") == 1
        for length in %r:
            ns = {"__name__": "reference_quickstart"}
            exec(compile(src.replace("length=12", f"length={length}"),
                         "examples/quickstart.py", "exec"), ns)
            f = ns["shard_map"](ns["stencil_step"], mesh=ns["mesh"],
                                in_specs=(ns["P"](None, "x"), ns["P"]()),
                                out_specs=(ns["P"](None, "x"), ns["P"]()))
            jnp = ns["jnp"]
            res = ns["synthesize"](f, jnp.ones((256, 128 * ns["N"])),
                                   jnp.ones((128, 128)) * 0.01,
                                   name="stencil_proxy",
                                   out_dir=str(OUT / f"proxies{length}"))
            fid = res.fidelity()
            (OUT / f"len{length}.json").write_text(json.dumps(
                [fid.mean, bool(fid.comm_lossless)]))
        """ % (QUICKSTART_LENGTHS,), tmp_path_factory.mktemp("ref_qs"),
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    return {n: tuple(out[f"len{n}"]) for n in QUICKSTART_LENGTHS}


def _port_quickstart_delta(length: int, out_dir) -> tuple[float, bool]:
    """The port's quickstart synthesis and fidelity at ``length``, in
    process, on the CPU."""
    import importlib.util

    from repro_torch.core.synthesize import synthesize
    from repro_torch.core.trace_ir import TraceStore
    from repro_torch.core.tracer import trace_fn

    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    trace = trace_fn(mod.stencil(length), torch.ones((256, 128)),
                     torch.ones((128, 128)) * 0.01,
                     axis_sizes={"x": mod.N})
    res = synthesize(store=TraceStore.from_template(trace, {"x": mod.N}),
                     name="stencil_proxy", out_dir=out_dir, device="cpu")
    fid = res.fidelity()
    return fid.mean, fid.comm_lossless


def test_quickstart(runs, reference_quickstart):
    """The smoke run's printed mean relative error is the reference's at
    the same length, to the 4 digits it prints."""
    out = _ok(runs, "torch_quickstart")
    assert "comm lossless: True" in out
    assert "8 ranks replayed in 1 signature group(s)" in out
    assert re.search(r"single-rank replay: \d+\.\d+ ms", out)
    err = re.search(r"mean relative error: (\S+)", out).group(1)
    assert err == f"{reference_quickstart[3][0]:.4f}"
    assert (runs[1] / "proxies" / "stencil_proxy_mod.py").exists()


@pytest.mark.parametrize("length", QUICKSTART_LENGTHS)
def test_quickstart_delta_equals_the_reference(length, reference_quickstart,
                                               tmp_path):
    """The port's quickstart δ̄ equals the reference's to 1e-12, both
    lossless, at the smoke and the published length."""
    mean, lossless = _port_quickstart_delta(length, tmp_path)
    want, want_lossless = reference_quickstart[length]
    assert lossless and want_lossless
    assert abs(mean - want) <= 1e-12, (mean, want)


def test_pipeline_proxy(runs):
    out = _ok(runs, "torch_pipeline_proxy")
    assert "clusters: 2 | cluster ranks: [[0, 7], [1, 2, 3, 4, 5, 6]]" in out
    assert "lossless: True" in out


def test_serve_and_proxy(runs):
    out = _ok(runs, "torch_serve_and_proxy")
    assert "batched serve: 2 requests x 4 new tokens" in out
    assert re.search(r"fidelity mean delta: \d", out)


def test_train_e2e(runs):
    out = _ok(runs, "torch_train_e2e")
    assert "model: qwen3-smoke" in out
    assert "checkpoints: [10, 20, 30]" in out
    first, last = map(float, re.search(
        r"first 10 avg (\S+), last 10 avg ([\d.]+)", out).groups())
    assert last < first


def test_examples_default_to_the_card(runs):
    rc, stdout, stderr = runs[0]["default_device"]
    assert rc != 0 and "no CUDA device" in stderr, stderr[-2000:]
    assert "lossless" not in stdout
