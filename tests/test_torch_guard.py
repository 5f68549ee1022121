"""Guards of the port's boundaries: no JAX and nothing of the JAX package
inside ``repro_torch`` or ``chip_smoke.py``, and entry points that run on
the card unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import proxy_search
from repro_torch.core.replay import ProxyProgram
from repro_torch.core.synthesize import synthesize
from repro_torch.core.trace_ir import TraceStore
from repro_torch.workloads import synthetic_rank_traces

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    out = []
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(PKG.parent).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_every_module_imports_without_jax_or_the_reference():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and (m == 'repro' or m.startswith(('repro.', 'jax'))))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_the_tracer_front_end_runs_without_jax():
    """synthesize(fn), the workloads and the scenario zoo trace, fit and
    replay with JAX unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.configs.registry import build_scenario\n"
        "from repro_torch.core.synthesize import synthesize\n"
        "from repro_torch.workloads import PROGRAMS\n"
        "fn, args, axes = PROGRAMS['dp_train'](n=2, layers=2)\n"
        "res = synthesize(fn, *args, axis_sizes=axes, device='cpu')\n"
        "res.proxy.run_all()\n"
        "assert res.fidelity(sample_ranks=None).comm_lossless\n"
        "st = build_scenario('ssm-decode', n_ranks=2, steps=1)\n"
        "assert st.n_ranks == 2\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' or\n"
        "             m.startswith(('repro.', 'jax')) and sys.modules[m])\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (path, name)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: non-zero exit and no result line.  Alone in a directory:
    the same."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if script.parent == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        proc = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _store(n=4):
    return TraceStore.from_rank_traces(synthetic_rank_traces(n, reps=4),
                                       {"x": n})


def test_synthesize_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesize(store=_store())


def test_proxy_program_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    res = synthesize(store=_store(), device="cpu", out_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProxyProgram(res.source, res.proxy.module, res.merged, res.proxy.combos)


def test_fit_defaults_to_cuda_and_raises_without_it(no_cuda):
    t = np.array([[2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proxy_search.fit_batch(t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proxy_search.fit_batch_pgd(t)


def test_state_builders_default_to_cuda_and_raise_without_it(no_cuda,
                                                             tmp_path):
    from repro_torch.core import blocks
    from repro_torch.core.replay import init_replay_state
    res = synthesize(store=_store(), device="cpu", out_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blocks.init_state(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blocks.state_from_numpy({"s": np.float32(0.0)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_replay_state(res.proxy.module, 0)
    assert init_replay_state(res.proxy.module, 0, "cpu")["a"].device.type \
        == "cpu"


def test_synthesize_from_a_function_is_not_ported_yet():
    """``synthesize(fn, ...)`` traces ``fn`` on meta tensors; what is not
    ported yet is a collective on real tensors (the mesh backend): it
    raises, never passing its input through as if it had run."""
    from repro_torch.sharding import collectives as C

    def fn(x):
        return C.psum(torch.tanh(x @ x), "x")

    res = synthesize(fn, torch.zeros(8, 8), axis_sizes={"x": 4},
                     device="cpu")
    assert res.store.n_ranks == 4 and res.store.n_comm_events == 4
    with pytest.raises(NotImplementedError, match="mesh"):
        fn(torch.zeros(8, 8))


def test_noise_replay_is_not_ported_yet(tmp_path):
    from repro_torch.core import noise
    res = synthesize(store=_store(), device="cpu", out_dir=tmp_path)
    st = res.proxy.init_state(0)
    assert noise.perturb(st, noise.LoweredNoise(0.1, 0.0, None, 4.0)) is st
    st[noise.NOISE_KEY] = torch.zeros(2)
    with pytest.raises(NotImplementedError):
        noise.perturb(st, noise.LoweredNoise(0.1, 0.0, None, 4.0))


def test_serve_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.configs import get, smoke
    from repro_torch.models.model import (
        init_cache, init_params, params_from_numpy,
    )
    from repro_torch.serve.engine import ServeEngine
    cfg = smoke(get("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    params = init_params(cfg, 0, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_train_entry_points_default_to_cuda_and_raise_without_it(no_cuda,
                                                                  tmp_path):
    from repro_torch.configs import get, smoke
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import Trainer, make_train_step
    cfg = smoke(get("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, ckpt_dir=tmp_path / "t")
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore({"a": torch.zeros(2)})
    assert mgr.restore({"a": torch.zeros(2)}, device="cpu")[1]["a"].device \
        .type == "cpu"
    assert Trainer(cfg, ckpt_dir=tmp_path / "t", device="cpu").device.type \
        == "cpu"
