"""Helper that runs the JAX reference in a subprocess, and its self-test.

On JAX 0.9, ``import repro.compat`` fails: ``batching.primitive_batchers``
became a ``PrimitiveBatchersProxy`` that does not support ``in``, so
``repro.core.replay``, ``repro.core.synthesize`` and
``repro.sharding.collectives`` cannot be imported in the test process.
:func:`run_reference` runs reference code in a fresh interpreter that first
gives the proxy a ``__contains__`` (only where the proxy exists), and
passes results back through files: every ``<name>.npz`` the code writes
into ``OUT`` comes back as a dict of arrays, every ``<name>.json`` as the
parsed object.  The reference's own tests keep running without the shim.

Modules that import cleanly (``blocks``, ``proxy_search``, ``tracer``, the
kernels' ``ref.py``) are called in-process by the port's tests instead.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for a module's tests, torch's own count back
    after them.  Every port test module asks for it (its ``pytestmark``):
    under ``-n 6`` six workers share the CPU's cores, and torch's pool of a
    thread a core made each small op of the smoke models wait on the other
    workers' threads (the einsum and softmax of a smoke decode step: 7.8 ms
    with 8 threads on a loaded CPU, 0.24 ms with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")

SHIM = """\
import jax._src.interpreters.batching as _batching
if hasattr(_batching, "PrimitiveBatchersProxy"):
    _batching.PrimitiveBatchersProxy.__contains__ = lambda self, key: True


def save_arrays(path, arrays):
    \"\"\"np.savez that keeps bfloat16 leaves (as uint16 bits + a tag).\"\"\"
    import numpy as _np
    out = {}
    for k, v in arrays.items():
        v = _np.asarray(v)
        if v.dtype.name == "bfloat16":
            out[k + BF16_TAG] = v.view(_np.uint16)
        else:
            out[k] = v
    _np.savez(path, **out)
"""
BF16_TAG = "@bfloat16"


def run_reference(code: str, out_dir: Path, timeout: float = 300,
                  env: dict | None = None) -> dict:
    """Run ``code`` against the JAX package in a subprocess.

    ``code`` sees ``OUT`` (a :class:`~pathlib.Path`) and writes its
    results there as ``.npz`` or ``.json`` files; returns ``{stem: data}``.
    ``save_arrays(path, dict)`` writes an ``.npz`` that keeps bfloat16
    arrays (they come back as numpy ``bfloat16``).  ``env`` adds variables
    to the subprocess's environment, set before anything imports JAX (e.g.
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` for a mesh).
    Raises with the subprocess's output if it fails."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    script = out_dir / "reference_script.py"
    script.write_text(SHIM + f"BF16_TAG = {BF16_TAG!r}\n"
                      "from pathlib import Path\n"
                      f"OUT = Path({str(out_dir)!r})\n"
                      + textwrap.dedent(code))
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(script)], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference script failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out = {}
    for p in sorted(out_dir.iterdir()):
        if p.suffix == ".npz":
            with np.load(p) as z:
                out[p.stem] = {_untag(k): _decode(k, z[k]) for k in z.files}
        elif p.suffix == ".json":
            out[p.stem] = json.loads(p.read_text())
    return out


def _untag(key: str) -> str:
    return key[:-len(BF16_TAG)] if key.endswith(BF16_TAG) else key


def _decode(key: str, x: np.ndarray) -> np.ndarray:
    if key.endswith(BF16_TAG):
        import ml_dtypes
        return x.view(ml_dtypes.bfloat16)
    return x


def test_run_reference_imports_replay_and_returns_arrays(tmp_path):
    """The shim makes ``repro.core.replay`` importable; arrays and JSON
    come back intact."""
    res = run_reference("""
        import json
        import numpy as np
        import repro.core.replay as replay
        import jax.numpy as jnp
        save_arrays(OUT / "arrays.npz", {
            "x": np.arange(5, dtype=np.int32),
            "y": np.full((2, 3), 0.25, np.float32),
            "z": jnp.full((4,), 0.5, jnp.bfloat16)})
        (OUT / "meta.json").write_text(json.dumps(
            {"threshold": replay.REP_UNROLL_THRESHOLD}))
    """, tmp_path)
    assert res["meta"] == {"threshold": 4}
    np.testing.assert_array_equal(res["arrays"]["x"], np.arange(5))
    assert res["arrays"]["y"].dtype == np.float32
    assert res["arrays"]["y"].shape == (2, 3)
    assert res["arrays"]["z"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(res["arrays"]["z"].astype(np.float32), 0.5)


def test_run_reference_reports_failures(tmp_path):
    try:
        run_reference("raise SystemExit('boom')", tmp_path)
    except RuntimeError as e:
        assert "boom" in str(e)
    else:
        raise AssertionError("a failing reference script must raise")
