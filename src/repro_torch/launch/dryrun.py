"""Multi-pod dry run: walk every (arch × shape) on the production meshes,
record memory, cost and roofline artifacts (port of
:mod:`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both

Outputs one JSON per cell under ``--out`` (default
``artifacts/dryrun_torch``), with the reference's keys, so
:mod:`repro_torch.launch.report` renders both packages' records.

The reference lowers and compiles each step for 256 (512) forced host
devices.  The port has no compiler to ask: one process plays rank 0 of the
production mesh's world through torch's fake backend
(:func:`~repro_torch.launch.mesh.fake_world`), takes its block of every
argument of ``registry.input_specs`` as a meta tensor
(``partition.local_copy``), and runs the step once under the op-log walker
(:func:`~repro_torch.launch.hlo_cost.record_step`).  Nothing is allocated
or computed, no kernel launches (every kernel wrapper takes its plain
version on meta tensors) and the SPMD model code's collectives return at
once with their shapes.  The record's fields, against the reference's:

* ``compile_sec``: the seconds of the cell (mesh, arguments and the walk);
* ``memory_analysis``: ``argument_bytes`` the arguments' blocks (decode's
  position counted as the reference's 4-byte scalar where a layer reads
  it), ``output_bytes`` the step's outputs (with the 8-byte pointer table
  XLA counts for a result of several buffers), ``alias_bytes`` those of
  them the step updated in place (parameters and optimizer state in
  train, the cache in decode),
  ``temp_bytes`` the peak of the bytes live beyond the arguments (every
  storage the step allocated and had not yet freed), ``code_bytes`` 0
  (eager: no compiled code);
* ``xla_cost_analysis``: the op log's totals (no XLA here), tensor FLOPs
  and bytes;
* ``roofline``, ``roofline_fraction``, ``step_time_bound_s``: as the
  reference's, from the op log (:mod:`repro_torch.launch.roofline`, on one
  H100 SXM's data-sheet constants).

Importing this module starts no process group; :func:`run_cell` starts the
fake world and destroys it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import ArchConfig, RunShape, SHAPES, \
    applicable_shapes
from repro_torch.configs.registry import ARCH_IDS, get, input_specs
from repro_torch.launch import hlo_cost, roofline
from repro_torch.launch.mesh import _mk, fake_world, make_production_mesh
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import build_forward, mark_cache
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import (
    entry_axes, local_copy, mesh_coord,
)
from repro_torch.train.loop import DataParallel, _value_and_grad
from repro_torch.train.optimizer import AdamWConfig, adamw_update

#: the production meshes by name: (shape, axis names)
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def build_step(cfg: ArchConfig, kind: str, mesh, batch_axes=(),
               pos: int = 0):
    """The per-shape step walked in the dry run: train (the loss's
    gradients by autograd, with the config's remat, then AdamW in place),
    prefill, or decode at position ``pos``.  On a mesh the batch is this
    process's rows, split over ``batch_axes``.  No step reads a value
    back to the host."""
    dp = DataParallel(cfg, mesh) if mesh is not None else None
    ctx = spmd.context(mesh, cfg) if mesh is not None else None
    rows = (lambda: ctx.rows(batch_axes)) if ctx is not None else \
        contextlib.nullcontext
    model_mesh = mesh if ctx is not None else None
    if kind == "train":
        loss_fn = build_forward(cfg, "loss")
        opt_cfg = AdamWConfig()

        def train_step(params, opt_state, batch):
            with rows():
                loss, grads = _value_and_grad(
                    lambda p, b: loss_fn(p, b, cfg, model_mesh), params,
                    batch)
            if dp is not None:
                loss, grads = dp.mean(loss, grads, tuple(batch_axes))
            params, opt_state, _ = adamw_update(
                grads, params, opt_state, opt_cfg,
                norm_reduce=dp.norm_sq if dp is not None and dp.sharded
                else None)
            return params, opt_state, loss

        return train_step
    if kind == "prefill":
        fn = build_forward(cfg, "prefill")

        @torch.no_grad()
        def prefill_step(params, batch):
            with rows():
                return fn(params, batch, cfg, model_mesh)

        return prefill_step
    fn = build_forward(cfg, "decode")

    @torch.no_grad()
    def serve_step(params, cache, batch, pos_arg):
        # the reference's position is a traced scalar; the port's decode
        # takes a Python int (``pos``), the argument is its 4 bytes
        with rows():
            return fn(params, cache, batch, pos, cfg, model_mesh)

    return serve_step


def _local_args(args, mesh):
    """Rank 0's block of every MetaSpec of ``args`` as a meta tensor."""
    coord = mesh_coord(mesh)
    return tree_map(lambda m: local_copy(m.meta, m.spec, mesh, coord), args)


def _reads_position(cfg: ArchConfig) -> bool:
    """Whether a decode step reads its position: attention does (RoPE and
    the mask), an SSM layer never.  The reference's jit drops an argument
    nothing reads, so Mamba2's decode counts no position bytes."""
    return cfg.family == "encdec" or bool(
        set(cfg.layer_kinds()) & {"g", "l", "s", "x"})


def _batch_axes(batch_specs: dict, sizes: dict) -> tuple[str, ...]:
    spec = batch_specs["tokens"].spec
    return tuple(a for a in entry_axes(spec[0] if spec else None)
                 if sizes.get(a, 1) > 1)


#: bytes of one entry of a tuple-shaped result's table of buffer pointers,
#: which XLA's memory analysis counts in ``output_size_in_bytes``
TUPLE_ENTRY_BYTES = 8


def _storages(tree) -> set[int]:
    return {id(t.untyped_storage()) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def _memory(arg_storages: set, out, log) -> dict:
    """The cell's memory record.  ``output_bytes`` counts the outputs as
    XLA counts a tuple-shaped result: each output's bytes plus one pointer
    entry an output; ``alias_bytes`` the outputs whose storage is an
    argument's (``arg_storages``, taken before the step ran)."""
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    if len(outs) > 1:
        out_bytes += TUPLE_ENTRY_BYTES * len(outs)
    alias = sum(t.numel() * t.element_size() for t in outs
                if id(t.untyped_storage()) in arg_storages)
    return {"argument_bytes": int(log.argument_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(log.peak_temp_bytes),
            "alias_bytes": int(alias),
            "code_bytes": 0}


def run_cell(arch, shape, multi_pod: bool = False,
             out_dir: Path | None = None, *, mesh_shape: dict | None = None
             ) -> dict:
    """Walk one cell and write its record (when ``out_dir`` is given).

    ``arch``: an id of the registry or an ArchConfig; ``shape``: a name of
    ``SHAPES`` or a RunShape.  The mesh is the production one, or
    ``mesh_shape`` (``{"data": 1, "model": 1}``: one device), on a fake
    world of its size."""
    cfg = arch if isinstance(arch, ArchConfig) else get(arch)
    arch_name = arch if isinstance(arch, str) else cfg.name
    shape = shape if isinstance(shape, RunShape) else SHAPES[shape]
    if mesh_shape is None:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        dims, names = MESHES[mesh_name]
    else:
        names, dims = tuple(mesh_shape), tuple(mesh_shape.values())
        mesh_name = "x".join(f"{n}{d}" for n, d in mesh_shape.items())
    t0 = time.time()
    with fake_world(math.prod(dims)):
        mesh = make_production_mesh(multi_pod=multi_pod) \
            if mesh_shape is None else _mk(dims, names)
        _, specs = input_specs(cfg, shape, mesh)
        sizes = dict(zip(names, dims))
        batch = specs[-2] if shape.kind == "decode" else specs[-1]
        axes = _batch_axes(batch, sizes)
        step = build_step(cfg, shape.kind, mesh, axes, pos=shape.seq_len - 1)
        args = _local_args(specs, mesh)
        if shape.kind == "decode":
            mark_cache(args[1], cfg, shape.global_batch, shape.seq_len)
        if shape.kind == "decode" and not _reads_position(cfg):
            args = args[:-1] + (None,)
        held = _storages(args)
        out, log = hlo_cost.record_step(step, *args)
        mem = _memory(held, out, log)
        del out, args
    cost = hlo_cost.analyze(log)
    rep = roofline.report(cost, mem, cfg, shape, sizes, mesh_name)
    rec = {
        "arch": arch_name, "shape": shape.name, "mesh": mesh_name,
        "ok": True,
        "compile_sec": round(time.time() - t0, 1),
        "memory_analysis": mem,
        "xla_cost_analysis": {
            "flops": float(cost.flops),
            "bytes_accessed": float(cost.bytes),
        },
        "roofline": rep.as_dict(),
        "roofline_fraction": roofline.roofline_fraction(rep),
        "step_time_bound_s": roofline.step_time_bound(rep),
    }
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        fname = f"{arch_name}__{shape.name}__{mesh_name}.json"
        (out_dir / fname).write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all applicable)")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()

    out = Path(args.out)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    failures = []
    t_all = time.time()
    for arch in archs:
        cfg = get(arch)
        shapes = [args.shape] if args.shape else applicable_shapes(cfg)
        for shape_name in shapes:
            for mp in pods:
                tag = f"{arch} × {shape_name} × {'multi' if mp else 'single'}"
                try:
                    rec = run_cell(arch, shape_name, mp, out)
                    r = rec["roofline"]
                    print(f"[OK ] {tag}: compile={rec['compile_sec']}s "
                          f"bottleneck={r['bottleneck']} "
                          f"frac={rec['roofline_fraction']:.3f} "
                          f"mem={rec['memory_analysis']['temp_bytes']/2**30:.2f}GiB",
                          flush=True)
                except Exception as e:
                    failures.append(tag)
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
                    out.mkdir(parents=True, exist_ok=True)
                    with (out / "failures.log").open("a") as fh:
                        fh.write(f"{tag}\n{traceback.format_exc()}\n")
    print(f"\nwall {time.time() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall dry-run cells walked OK")


if __name__ == "__main__":
    main()
