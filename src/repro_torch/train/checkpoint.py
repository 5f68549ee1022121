"""Checkpointing of trees of tensors: one ``.npy`` file a leaf plus a
manifest, async save, atomic commit, ``keep``-based garbage collection and
restore into a template tree.

The port of ``src/repro/train/checkpoint.py``, with the same layout and
manifest fields::

    <dir>/step_000120.tmp/            # written first
        manifest.json                 # step, leaf paths, shapes, dtypes, extra
        <leaf-key>.npy                # one file per leaf
    <dir>/step_000120/                # atomic rename on completion

Leaf keys are the reference's (``params/unit/[0]/attn/wq``: dict keys,
``[i]`` for a tuple index, joined by ``/``), from the port's own walk of
the tree.  A bf16 leaf is written in the reference's file format: its
16-bit patterns under the header that ``np.save`` gives an ml_dtypes
bfloat16 array (descr ``'<V2'``; numpy itself has no bfloat16, and the
port does not import ml_dtypes), and the manifest records
``"bfloat16"``.  Restore reads that form, and the ``uint16`` files that
earlier versions of the port wrote, to the same bits.  Restore places
every leaf on one device with the template leaf's dtype: the data-parallel
trainer's replicas each restore the whole state, so a checkpoint moves
between meshes of any data size and the single-device trainer.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def _map_with_paths(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` over the leaves of nested dicts, tuples and lists,
    in the tree's structure; ``key`` is the reference's leaf path."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: k)
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, join(str(k)))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map_with_paths(fn, v, join(f"[{i}]"))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(prefix, tree)


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array, dtype name); bf16 as its bits, viewed as
    2-byte voids."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).numpy()
        return bits.view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_leaf(path: Path, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bf16 leaf gets the header that ``np.save`` writes
    for an ml_dtypes bfloat16 array: descr ``'<V2'`` (numpy would write
    ``'|V2'`` for the void view)."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    header = {"descr": "<V2", "fortran_order": False, "shape": arr.shape}
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(arr.tobytes())


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded leaf as a tensor; a bf16 leaf from the reference's 2-byte
    void form or the ``uint16`` form, to the same bits."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread: threading.Thread | None = None
        self._async_err: list[BaseException] = []

    # -- save -------------------------------------------------------------------

    @staticmethod
    def _host(state) -> list[tuple[str, np.ndarray, str]]:
        out = []
        _map_with_paths(lambda key, leaf: out.append((key, *_to_host(leaf))),
                        state)
        return out

    def save(self, step: int, state: dict, extra: dict | None = None) -> Path:
        """Blocking save.  ``state`` is any tree of tensors."""
        return self._write(step, self._host(state), extra or {})

    def save_async(self, step: int, state: dict, extra: dict | None = None):
        """Non-blocking save: the device-to-host copy happens now (so
        training can update the tensors in place), file IO on a worker
        thread."""
        self.wait()
        host = self._host(state)

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # surfaced by wait()
                self._async_err.append(e)

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_err:
            raise self._async_err.pop()

    def _write(self, step: int, host, extra: dict) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for key, arr, dtype in host:
            fname = key.replace("/", "__").replace("[", "_").replace("]", "_")
            _save_leaf(tmp / f"{fname}.npy", arr, dtype)
            manifest["leaves"][key] = {
                "file": f"{fname}.npy",
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def _gc(self):
        ckpts = sorted(self.all_steps())
        for step in ckpts[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{step:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None,
                device=None) -> tuple[int, Any, dict]:
        """Restore into the structure of ``template``: each leaf takes the
        template leaf's dtype and goes to ``device`` (default: the CUDA
        card; raises without one).  Returns (step, state, extra)."""
        dev = resolve_device(device)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())

        def load(key, leaf):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint {d} missing leaf {key}")
            t = _from_host(np.load(d / meta["file"]), meta["dtype"])
            return t.to(device=dev, dtype=leaf.dtype)

        state = _map_with_paths(load, template)
        return step, state, manifest.get("extra", {})
