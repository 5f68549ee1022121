"""The port's traced target programs and synthetic rank traces.

The benchmarks import the JAX package and the port must not, so the port
keeps its own versions:

* :func:`stencil_program`, :func:`allreduce_train_program` and
  :func:`pipeline_traces`, the paper's programs of ``benchmarks/common.py``
  (:data:`PROGRAMS` as there).  The first two are per-rank torch programs
  that return ``(fn, args, axis_sizes)`` for ``synthesize(fn, *args,
  axis_sizes=axis_sizes)``: the reference's ``shard_map`` bodies, with
  ``args`` the per-rank (local) shapes, collectives from
  :mod:`repro_torch.sharding.collectives` and the scans as
  :func:`~repro_torch.core.tracer.scan_loop`.
* :func:`synthetic_rank_traces`, ``benchmarks/synthesize_time.py:
  _synthetic_traces``: a halo-exchange style SPMD loop of ``reps`` steps,
  each two compute events (eight close variants that cluster into one
  terminal), a float32 psum and a bf16 ring ppermute; every 16th rank ends
  with one extra psum, which splits the ranks into two signature groups.
  At 64 ranks it is 51,204 events.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.events import CommEvent, ComputeEvent, Event
from repro_torch.core.tracer import TraceSession, compute_cost, scan_loop
from repro_torch.sharding import collectives as C


def stencil_program(n: int = 8, length: int = 12):
    """2D-stencil analog (paper Fig. 2 / NPB MG-flavoured): halo ppermutes,
    compute and a global psum inside a scan.  ``u`` is (256, 128) a rank
    (the reference's (256, 128·n) split over ``x``)."""
    right_of = [(i, (i + 1) % n) for i in range(n)]
    left_of = [(i, (i - 1) % n) for i in range(n)]

    def step(u, w):
        def body(c):
            u, w = c
            left = C.ppermute(u[:, :1], "x", right_of)
            right = C.ppermute(u[:, -1:], "x", left_of)
            u = u + 0.1 * (left + right - 2.0 * u)
            for _ in range(3):
                u = torch.tanh(u @ w)
            r = C.psum(torch.sum(u), "x")
            return (u, w), r
        (u, _), rs = scan_loop(length, body, (u, w), stack_ys=True)
        return u, rs

    args = (torch.ones((256, 128)), torch.ones((128, 128)) * 0.01)
    return step, args, {"x": n}


def allreduce_train_program(n: int = 8, layers: int = 6):
    """Data-parallel training analog (NPB CG-flavoured): per-layer compute
    and a gradient psum, scanned over the stacked layer weights.  ``x`` is
    (16, 512) a rank."""
    def step(x, ws):
        def body(c, w):
            h = torch.tanh(c @ w)
            g = C.psum(h.sum(dim=0), "x")          # grad all-reduce analog
            return h + 1e-6 * g[None, :]
        out = scan_loop(layers, body, x, xs=ws)
        return C.psum(out.sum(), "x")

    args = (torch.ones((16, 512)), torch.ones((layers, 512, 512)) * 0.01)
    return step, args, {"x": n}


def pipeline_traces(n_ranks: int = 8, microbatches: int = 12
                    ) -> list[list[Event]]:
    """Pipeline-parallel schedule (heterogeneous per-rank mains, the case
    that exercises Algorithm 1's clustering), recorded through a
    :class:`TraceSession`."""
    fwd = compute_cost(lambda a, b: torch.tanh(a @ b),
                       torch.ones((64, 256)), torch.ones((256, 256)))
    with TraceSession(n_ranks=n_ranks) as sess:
        for _ in range(microbatches):
            for r in range(n_ranks):
                sess.emit([r], ComputeEvent(tuple(fwd)))
                if r < n_ranks - 1:   # send activation to next stage
                    sess.emit([r, r + 1],
                              CommEvent("ppermute", (64, 256), "float32",
                                        ("stage",), ("shift", 1)))
        for r in range(n_ranks):
            sess.emit([r], CommEvent("psum", (256, 256), "float32",
                                     ("stage",)))
    return sess.rank_streams


PROGRAMS = {
    "stencil2d": stencil_program,
    "dp_train": allreduce_train_program,
}


def synthetic_rank_traces(n_ranks: int = 64, reps: int = 200,
                          ) -> list[list[Event]]:
    comm = CommEvent("psum", (16,), "float32", ("x",))
    perm = CommEvent("ppermute", (4, 4), "bfloat16", ("x",), ("shift", 1))
    base = np.array([2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.])
    comps = [ComputeEvent(tuple(base * (1 + 0.004 * i))) for i in range(8)]
    traces = []
    for r in range(n_ranks):
        tr = []
        for i in range(reps):
            tr += [comps[i % 8], comm, comps[(i + 3) % 8], perm]
        if r % 16 == 0:
            tr = tr + [comm]
        traces.append(tr)
    return traces
