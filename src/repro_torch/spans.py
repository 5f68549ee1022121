"""Spans and counters of the port, on the profiler's clock.

The port's one place for named spans and counters.  Nothing is recorded
unless a ``torch.profiler`` is recording: an operator turns them on by
taking a profiler trace, and there is no other switch.

* :func:`span` (``with span("serve.prefill"): ...``).  With no profiler
  recording it returns a shared no-op and enters no ``record_function``,
  which costs some 15 µs of host time a call even then.  Under a profiler
  it enters ``torch.profiler.record_function("repro." + name)``, so the
  span sits on the profiler's timeline beside the work it launched, nested
  by thread (the enclosing range is the span that caused it), and, once
  CUDA is initialised, records a pair of CUDA events on the current
  stream: its device time is everything the span put on the stream.
* :func:`count` adds a host int or a 0-d device tensor to a total and reads
  no device value on the host; :func:`enabled` says whether a profiler is
  recording, for a caller whose value costs a launch to compute.
* :func:`take` returns what was recorded since the last ``take()`` and
  clears it: each span's calls and summed device ms (``None`` where no
  CUDA events were taken), each counter's total, and the records dropped
  at the cap (:data:`CAP` event pairs and device values are kept).  It
  waits for each span's end event and reads the device counters, so it
  belongs after the traced work and its sync, not inside it.

The recorder is thread-safe: the autograd engine runs backward (and
remat's recompute in it) on threads of its own.
"""
from __future__ import annotations

import threading

import torch

PREFIX = "repro."
CAP = 1 << 16


def enabled() -> bool:
    """Whether a ``torch.profiler`` is recording (spans and counts are on)."""
    return torch.autograd._profiler_enabled()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "range", "start")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self

    def __exit__(self, *exc):
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self.range.__exit__(*exc)
        self.rec._ended(self.name, self.start, end)
        return False


class Recorder:
    """Spans' calls and CUDA event pairs, and counters' totals, kept in
    memory until :meth:`take`."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._clear()

    def _clear(self) -> None:
        self._calls: dict[str, int] = {}
        self._events: dict[str, list] = {}
        self._host: dict[str, int] = {}
        self._device: dict[str, list] = {}
        self._kept = self._dropped = 0

    def _room(self) -> bool:
        """Whether one more record fits (called under the lock)."""
        if self._kept >= self.cap:
            self._dropped += 1
            return False
        self._kept += 1
        return True

    def span(self, name: str):
        if not torch.autograd._profiler_enabled():
            return _OFF
        return _Span(self, name)

    def _ended(self, name: str, start, end) -> None:
        with self._lock:
            self._calls[name] = self._calls.get(name, 0) + 1
            if start is not None and self._room():
                self._events.setdefault(name, []).append((start, end))

    def count(self, name: str, value) -> None:
        if not torch.autograd._profiler_enabled():
            return
        with self._lock:
            if not isinstance(value, torch.Tensor):
                self._host[name] = self._host.get(name, 0) + int(value)
            elif self._room():
                self._device.setdefault(name, []).append(value.detach())

    def take(self) -> dict:
        with self._lock:
            calls, events = self._calls, self._events
            host, device, dropped = self._host, self._device, self._dropped
            self._clear()
        spans = {}
        for name, n in calls.items():
            pairs = events.get(name)
            for _, end in pairs or ():
                end.synchronize()
            spans[name] = {"calls": n, "device_ms": sum(
                a.elapsed_time(b) for a, b in pairs) if pairs else None}
        counts = dict(host)
        for name, values in device.items():
            by_device: dict = {}
            for v in values:
                by_device.setdefault(v.device, []).append(v.reshape(()))
            counts[name] = counts.get(name, 0) + sum(
                int(torch.stack(vs).sum()) for vs in by_device.values())
        return {"spans": spans, "counts": counts, "dropped": dropped}


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
take = RECORDER.take
