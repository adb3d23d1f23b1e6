"""The benchmark's spans and its reading of the device trace.

Spans: during a traced run every kernel entry that benchmark/roofline/
names is wrapped, from outside the program, in a `record_function` span
`bench::<entry>`, and the work of each call is captured from its
arguments (roofline/<entry>.capture, read once the trace has stopped).

The trace: torch.profiler's raw events over the traced steps. A device
operation belongs to an entry's span when the launch call that issued it
(matched by the profiler's correlation id) ran inside the span.
"""

from __future__ import annotations

import bisect
import collections
import functools
import importlib
from dataclasses import dataclass, field

import torch

from benchmark import roofline

SPAN_PREFIX = "bench::"
_NOT_KERNELS = ("Memcpy", "Memset")
NAME_CHARS = 160


class Spans:
    """Wraps the roofline entries while installed; records only while
    `active`."""

    def __init__(self):
        self.entries = roofline.entries()
        self.active = False
        self.calls = collections.defaultdict(list)
        self._saved = []

    def install(self):
        for name, mod in self.entries.items():
            target = importlib.import_module(mod.MODULE)
            orig = getattr(target, name)
            setattr(target, name, self._wrap(name, mod, orig))
            self._saved.append((target, name, orig))
        return self

    def uninstall(self):
        for target, name, orig in reversed(self._saved):
            # the entry counts its launches on the module's attribute, the
            # wrapper while installed: hand the counts back
            orig.__dict__.update(getattr(target, name).__dict__)
            setattr(target, name, orig)
        self._saved.clear()

    def _wrap(self, name, mod, orig):
        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            if not self.active:
                return orig(*args, **kwargs)
            with torch.profiler.record_function(SPAN_PREFIX + name):
                out = orig(*args, **kwargs)
            self.calls[name].append(mod.capture(args, kwargs))
            return out

        return wrapper

    def work(self) -> dict:
        """entry -> summed work of its captured calls: 'calls', 'ops',
        'bytes', 'bound_s' (the sum of each call's roofline bound) and any
        further counts the entry's work() gives (summed)."""
        out = {}
        for name, caps in self.calls.items():
            mod = self.entries[name]
            tot = collections.Counter()
            for cap in caps:
                w = mod.work(cap) if hasattr(mod, "work") else cap
                tot["bound_s"] += roofline.bound_s(w["ops"], w["bytes"])
                for k, v in w.items():
                    if isinstance(v, (int, float)):
                        tot[k] += v
            tot["calls"] = len(caps)
            out[name] = dict(tot)
        return out


@dataclass
class Trace:
    """What the traced steps' device events say."""
    steps: int
    window_s: float
    busy_s: dict                 # device index -> seconds busy (union)
    ops: list                    # (device, start_ns, end_ns, name, span)
    gaps: list = field(default_factory=list)  # (seconds, host label)

    def kernels(self):
        return [o for o in self.ops if not o[3].startswith(_NOT_KERNELS)]

    def span_seconds(self, entry) -> float:
        return sum(e - s for _, s, e, _, span in self.ops
                   if span == SPAN_PREFIX + entry) * 1e-9


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof, steps: int, window_s: float, devices) -> Trace:
    """The Trace of a stopped torch.profiler.profile over `steps` steps
    that lasted `window_s` seconds on the host clock, on CUDA device
    indices `devices`."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    dev_ev, host = [], []
    for e in raw:
        if e.device_type() == DeviceType.CUDA:
            # the profiler mirrors each span on the device's timeline; it
            # is no device work
            if not e.name().startswith(SPAN_PREFIX):
                dev_ev.append(e)
        elif e.device_type() == DeviceType.CPU:
            host.append(e)
    # a device operation belongs to the span whose interval holds the
    # launch call that issued it (on the thread that ran the span)
    spans = sorted((e.start_ns(), e.end_ns(), e.start_thread_id(), e.name())
                   for e in host if e.is_user_annotation()
                   and e.name().startswith(SPAN_PREFIX))
    starts = [s[0] for s in spans]
    launch_at = {e.correlation_id(): (e.start_ns(), e.start_thread_id())
                 for e in host if "Launch" in e.name()}
    span_of = {}
    for e in dev_ev:
        at = launch_at.get(e.correlation_id())
        if at is None:
            continue
        i = bisect.bisect_right(starts, at[0]) - 1
        if i >= 0 and spans[i][1] >= at[0] and spans[i][2] == at[1]:
            span_of[id(e)] = spans[i][3]
    ops = [(e.device_index(), e.start_ns(), e.end_ns(), e.name(),
            span_of.get(id(e))) for e in dev_ev]
    busy = {}
    for d in devices:
        merged = _union([(s, e) for dv, s, e, _, _ in ops if dv == d])
        busy[d] = sum(e - s for s, e in merged) * 1e-9
    return Trace(steps=steps, window_s=window_s, busy_s=busy, ops=ops,
                 gaps=_idle_gaps(ops, host, devices))


def _idle_gaps(ops, host, devices):
    """Each idle gap between the busy intervals of each device, labelled by
    the innermost host operation under way at its midpoint on the thread
    that issues the work."""
    if not ops:
        return []
    main = collections.Counter(e.start_thread_id() for e in host
                               if not e.is_user_annotation()).most_common(1)
    tid = main[0][0] if main else None
    hs = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host
                 if e.start_thread_id() == tid and not e.is_async()),
                key=lambda x: (x[0], -x[1]))
    gaps = []
    for d in devices:
        merged = _union([(s, e) for dv, s, e, _, _ in ops if dv == d])
        gaps += [((e0 + s1) // 2, (s1 - e0) * 1e-9)
                 for (_, e0), (s1, _) in zip(merged, merged[1:])]
    gaps.sort()
    # one sweep in time order: the host operations of one thread nest, so
    # the innermost one under way is the top of a stack
    out, stack, i = [], [], 0
    for mid, sec in gaps:
        while i < len(hs) and hs[i][0] <= mid:
            while stack and stack[-1][1] < hs[i][0]:
                stack.pop()
            stack.append(hs[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out.append((sec, stack[-1][2] if stack else "host (no torch op)"))
    return out


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took the most time, and the ten
    host operations under which the device sat idle longest. Names are cut
    at NAME_CHARS characters (a kernel's template arguments run long)."""
    ops = collections.Counter()
    for _, s, e, name, _ in trace.ops:
        ops[name[:NAME_CHARS]] += (e - s) * 1e-9
    gaps = collections.Counter()
    for sec, label in trace.gaps:
        gaps[label] += sec
    return {"device_ops": [[n, v] for n, v in ops.most_common(10)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(10)]}
