"""The traced run's instruments: hooks around the program's calls, the
profiler over the traced part of the window, and what is read from them.

A hook wraps a function the program looks up at call time (``module.attr``)
for the traced units only.  Each call records its arguments' shapes and
dtypes, opens a profiler range ``bench.<attr>`` and takes a pair of CUDA
events on the current stream; where the call's output has a backward node,
the node's execution opens a range ``bench.<attr>.bwd`` and takes its own
pair of events (on the autograd engine's thread).  A call's device time is
the time between its events: everything the call put on the stream,
however it is launched or named, so a later PR that rewrites or splits a
kernel is read against the same call.  (The profiler does not see every
launch: a kernel launched from a library with its own static CUDA runtime
reaches the trace with no runtime call to place it.)

:class:`Trace` holds the profiler's events in a plain form: CPU ranges and
ops (id, name, thread, start, end) and device activities (kernels, copies
and sets: name, start, end, where the host launched them).
"""
from __future__ import annotations

import importlib

import torch

from bench.yardstick import union_length

PREFIX = "bench."


def _describe(x):
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "dtype": str(x.dtype).replace(
            "torch.", "")}
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, (int, float, bool, str)) or x is None:
        return x
    return type(x).__name__


class Hooks:
    """Wrap ``module.attr`` for each target; ``calls[attr]`` gets each call's
    arguments, ``events[attr]`` its CUDA event pairs."""

    def __init__(self, targets):
        self.targets = sorted(set(targets))
        self.calls: dict[str, list] = {a: [] for _, a in self.targets}
        self.events: dict[str, list] = {a: [] for _, a in self.targets}
        self.bwd_events: dict[str, list] = {a: [] for _, a in self.targets}
        self._saved = []

    def _wrap(self, attr, fn):
        calls, events = self.calls[attr], self.events[attr]
        bwd = self.bwd_events[attr]
        name = PREFIX + attr

        def wrapper(*args, **kwargs):
            calls.append({"args": [_describe(a) for a in args],
                          "kwargs": {k: _describe(v)
                                     for k, v in kwargs.items()}})
            timed = torch.cuda.is_initialized()
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            if timed:
                ev[1].record()
                events.append(ev)
            first = out[0] if isinstance(out, tuple) else out
            node = getattr(first, "grad_fn", None)
            if node is not None:
                _time_node(node, name + ".bwd", bwd if timed else None)
            return out

        return wrapper

    def __enter__(self):
        for mod_name, attr in self.targets:
            mod = importlib.import_module(mod_name)
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, self._wrap(attr, getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def event_ms(self, attr: str, backward: bool = False) -> list[float]:
        """Each call's (or its backward node's) device time between its
        CUDA events, in ms (after a sync)."""
        pairs = (self.bwd_events if backward else self.events).get(attr, [])
        return [a.elapsed_time(b) for a, b in pairs if b is not None]


def _time_node(node, name: str, events) -> None:
    """A range and, where ``events`` is a list, a pair of CUDA events on
    the engine thread's stream around the node's execution."""
    box = {}

    def pre(grad_outputs):
        box["range"] = torch.profiler.record_function(name)
        box["range"].__enter__()
        if events is not None:
            box["start"] = torch.cuda.Event(enable_timing=True)
            box["start"].record()

    def post(grad_inputs, grad_outputs):
        if "start" in box:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((box.pop("start"), end))
        rng = box.pop("range", None)
        if rng is not None:
            rng.__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)


class Trace:
    """The profiler's events in a plain form (microseconds)."""

    def __init__(self, ops, device, window):
        #: CPU ops and ranges: (id, name, thread, start, end)
        self.ops = ops
        #: device activities: (name, start, end, (thread, time) of the
        #: launch or None, linked op id)
        self.device = device
        #: the traced window's (start, end)
        self.window = window
        self._by_id = {o[0]: o for o in ops}

    @classmethod
    def from_profiler(cls, prof, window_name: str = PREFIX + "window"):
        """Each device activity is placed where the host launched it: the
        thread and time of the CUDA runtime call with its correlation id
        (a kernel launched through ctypes has no PyTorch op of its own),
        else of the PyTorch op it is linked to."""
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()
        ops, runtime, annotations = [], {}, set()
        for e in events:
            if e.device_type() != DeviceType.CPU:
                continue
            where = (e.start_thread_id(), e.start_ns() / 1e3)
            if e.name().startswith("cu"):
                runtime[e.correlation_id()] = where
                continue
            if e.is_user_annotation():
                annotations.add(e.name())
            ops.append((e.correlation_id(), e.name(), where[0], where[1],
                        e.end_ns() / 1e3))
        by_id = {o[0]: o for o in ops}
        dev = []
        for e in events:
            if e.device_type() != DeviceType.CUDA or e.name() in annotations:
                continue
            op = e.linked_correlation_id()
            where = runtime.get(e.correlation_id())
            if where is None and op in by_id:
                where = by_id[op][2:4]
            dev.append((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                        where, op))
        wins = [(o[3], o[4]) for o in ops if o[1] == window_name]
        window = (min(w[0] for w in wins), max(w[1] for w in wins)) \
            if wins else None
        return cls(ops, dev, window)

    # -- the window ------------------------------------------------------

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _in_window(self):
        lo, hi = self.window
        for name, s, e, where, op in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                yield name, s, e, where, op

    def busy_s(self) -> float:
        return union_length((s, e) for _, s, e, _, _ in
                            self._in_window()) / 1e6

    # -- the breakdown -----------------------------------------------------

    def top_device_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, s, e, _, _ in self._in_window():
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        return [[k[:120], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def _innermost(self, places) -> dict:
        """Each (thread, time)'s innermost ``bench.`` range (ranges nest on a
        thread, so one sweep with a stack finds them)."""
        items: dict = {}
        for o in self.ops:
            if o[1].startswith(PREFIX) and o[1] != PREFIX + "window":
                items.setdefault(o[2], []).append((o[3], 0, o[4], o[1]))
        for tid, t in places:
            items.setdefault(tid, []).append((t, 1, (tid, t), None))
        out = {}
        for seq in items.values():
            stack = []
            for t, kind, x, name in sorted(seq, key=lambda r: (r[0], r[1])):
                while stack and stack[-1][0] < t:
                    stack.pop()
                if kind == 0:
                    stack.append((x, name))
                else:
                    out[x] = stack[-1][1] if stack else "host"
        return out

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time in the window, summed by what the host was
        doing before the activity that ended each gap: the innermost
        ``bench.`` range around its launch, and the op it is linked to."""
        acts = sorted((s, e, where, op) for _, s, e, where, op in
                      self._in_window())
        lo, hi = self.window
        gaps, cur = [], lo
        for s, e, where, op in acts:
            if s > cur:
                gaps.append((s - cur, where, op))
            cur = max(cur, e)
        inner = self._innermost({w for _, w, _ in gaps if w is not None})
        tot: dict = {}
        for length, where, op in gaps:
            name = self._by_id[op][1] if op in self._by_id else "launch"
            label = f"{inner.get(where, 'host')} > {name}"[:120]
            tot[label] = tot.get(label, 0.0) + length / 1e6
        if hi > cur:
            tot["end of window"] = (hi - cur) / 1e6
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def profiler():
    """A profiler of the host and the card (kernels, copies and sets)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
