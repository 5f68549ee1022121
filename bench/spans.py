"""The program's own spans and counters (``repro_torch/spans.py``), read
once per traced run, and the traced window's idle time put down to them.

The program records a span or a counter only while a profiler records, so
in a run they come from the traced units alone.  :func:`taken` takes the
recorder's contents once per ``Run`` and caches them in ``r.info``; each
reader calls it first, so the next run in the process starts from an empty
recorder.  A program without the recorder gives empty contents, and every
reader then returns ``None``, as it does without a CUDA card: a CPU run is
never read as a device number.

The idle attribution reads ``r.trace_data`` alone: each idle gap of the
traced window is found as ``Trace.idle_gaps`` finds it (the activity that
ends the gap, placed where the host launched it), and the ``repro.``
ranges on the launching thread around that launch name the spans it lies
in.
"""
from __future__ import annotations

PREFIX = "repro."


def taken(r) -> dict:
    """The recorder's spans (calls, summed device ms), counters and dropped
    records over the run's traced units, taken once."""
    if "spans" not in r.info:
        try:
            from repro_torch import spans
        except ImportError:             # a program without the recorder
            r.info["spans"] = {"spans": {}, "counts": {}, "dropped": 0}
        else:
            r.info["spans"] = spans.take()
    return r.info["spans"]


def _on_card(r) -> dict | None:
    """The run's spans and counters where it ran on the card and the
    recorder kept every record, else ``None``."""
    got = taken(r)
    return got if r.device.type == "cuda" and not got["dropped"] else None


def calls(r, name: str) -> int:
    return taken(r)["spans"].get(name, {}).get("calls", 0)


def device_ms(r, name: str) -> float | None:
    """Span ``name``'s device ms summed over the traced units."""
    got = _on_card(r)
    return got["spans"].get(name, {}).get("device_ms") if got else None


def per_generate(r, ms: float | None) -> float | None:
    """``ms`` over the traced ``generate`` calls."""
    n = calls(r, "serve.generate")
    return ms / n if ms is not None and n else None


def per_step(r, ms: float | None) -> float | None:
    """``ms`` over the traced training steps."""
    return ms / r.traffic["trace_steps"] if ms is not None else None


def share(r, part: str, whole: str) -> float | None:
    """Counter ``part`` over counter ``whole``, in %."""
    got = _on_card(r)
    if got is None or not got["counts"].get(whole):
        return None
    return 100.0 * got["counts"].get(part, 0) / got["counts"][whole]


def gaps(t) -> list:
    """Each idle gap of the traced window that an activity ends: (its
    length in µs, where the host launched that activity: (thread, time) or
    ``None``, the id of the op it is linked to)."""
    acts = sorted(((s, e, where, op) for _, s, e, where, op in
                   t._in_window()), key=lambda a: a[:2])
    out, cur = [], t.window[0]
    for s, e, where, op in acts:
        if s > cur:
            out.append((s - cur, where, op))
        cur = max(cur, e)
    return out


def enclosing(t, places) -> dict:
    """Each (thread, time) of ``places`` -> the names of the ``repro.``
    ranges around it on that thread, outermost first (without the prefix;
    ranges nest on a thread, so one sweep with a stack finds them)."""
    items: dict = {}
    for _, name, tid, s, e in t.ops:
        if name.startswith(PREFIX):
            items.setdefault(tid, []).append((s, 0, e, name[len(PREFIX):]))
    for tid, at in places:
        items.setdefault(tid, []).append((at, 1, None, None))
    out = {}
    for tid, seq in items.items():
        stack = []
        for at, kind, end, name in sorted(seq, key=lambda x: x[:2]):
            while stack and stack[-1][0] < at:
                stack.pop()
            if kind == 0:
                stack.append((end, name))
            else:
                out[(tid, at)] = tuple(n for _, n in stack)
    return out


def idle_share(r, inside: str, outside: str | None = None) -> float | None:
    """The share (%) of the traced window idle in gaps whose ending
    activity was launched inside span ``inside`` and not inside
    ``outside``; ``None`` where the trace has no ``inside`` range."""
    t = r.trace_data
    if r.device.type != "cuda" or t is None or t.window is None or \
            t.window[1] <= t.window[0] or \
            not any(o[1] == PREFIX + inside for o in t.ops):
        return None
    found = gaps(t)
    at = enclosing(t, {w for _, w, _ in found if w is not None})
    idle = sum(n for n, w, _ in found if w is not None and inside in at[w]
               and outside not in at[w])
    return 100.0 * idle / (t.window[1] - t.window[0])


def idle_gaps(t, n: int = 10) -> list:
    """The window's idle seconds summed by the ``repro.`` spans around each
    gap's launch (outermost first; ``outside`` where none is) and the op
    the ending activity is linked to, the largest ``n``."""
    found = gaps(t)
    at = enclosing(t, {w for _, w, _ in found if w is not None})
    tot: dict = {}
    for length, where, op in found:
        names = " > ".join(at.get(where, ())) or "outside"
        op_name = t._by_id[op][1] if op in t._by_id else "launch"
        label = f"{names} | {op_name}"
        tot[label] = tot.get(label, 0.0) + length / 1e6
    return [[k, v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
