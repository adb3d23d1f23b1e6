"""Phase timing, the program's spans and counters, and device tracing
(port of raytracer_odin_tpu/utils/profiling.py).

  * `PhaseTimer` — host wall time per named phase (ingest, build, upload,
    render, readback, ...) with a printable report and Mrays/s over the
    "render" phase; and the program's tally of spans and counters:
    span(name) adds a block's call, inclusive and self host time to
    `spans[name]`, count(name, n) adds n to `counters[name]`, and what
    either records while a "step" span is open on its thread goes to
    `step_spans` / `step_counters` as well (a step that starts while a
    profiler records stays out of them: the profiler slows it);
  * `PROCESS` — the process-wide PhaseTimer that the module's `span()` and
    `count()` write to; runtime.render_scene returns what one call added to
    it (RenderResult.phases);
  * `trace()` wraps `torch.profiler` around a block and writes a Chrome
    trace (chrome://tracing, Perfetto) into a directory: the CLI's
    `--profile-dir`. While a profiler records, every span is also a CPU
    range named "rt::<name>" on the profiler's host timeline.

A phase's or a span's time is the host's: work a block enqueues on the
card is in it only where the block waits for the card. The tally is
always on: a span costs two clock reads and one dict update under a lock,
and keeps one entry per name, whatever the number of calls.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

# The span whose open calls mark what `step_spans` / `step_counters` keep.
STEP = "step"
# Name prefix of the spans' ranges on the profiler's timeline.
RANGE_PREFIX = "rt::"
# A plain CPU op of the profiler (not a user annotation, so the profiler
# mirrors no range of it on the device's timeline).
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_recording = torch.autograd._profiler_enabled


@dataclass
class SpanStat:
    """One span name's tally: calls, and inclusive and self host time in
    ns (self: inclusive less the spans opened inside it on its thread)."""
    calls: int = 0
    total_ns: int = 0
    self_ns: int = 0

    @property
    def total_s(self) -> float:
        return self.total_ns * 1e-9


class _Open:
    """One open span; after the block, `seconds` is its inclusive time."""

    __slots__ = ("timer", "name", "thread", "step", "t0", "child_ns",
                 "range", "seconds")

    def __init__(self, timer: "PhaseTimer", name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        th = self.timer._threads
        th.stack.append(self)
        self.thread, self.child_ns, self.range = th, 0, None
        recording = _recording()
        # A step that starts under a profiler runs at the profiler's pace:
        # it opens no step part.
        self.step = self.name == STEP and not recording
        if self.step:
            th.steps += 1
        if recording and _RANGE is not None:
            self.range = _RANGE(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(None, None, None)
        th = self.thread
        th.stack.pop()
        if th.stack:
            th.stack[-1].child_ns += ns
        in_step = th.steps > 0
        if self.step:
            th.steps -= 1
        self.seconds = ns * 1e-9
        self.timer._add(self.name, ns, ns - self.child_ns, in_step)
        return False


class _Thread(threading.local):
    """A thread's open spans, innermost last, and how many are steps."""

    def __init__(self):
        self.stack = []
        self.steps = 0


@dataclass
class PhaseTimer:
    phases: dict = field(default_factory=dict)
    order: list = field(default_factory=list)
    # span name -> SpanStat over every call, and over the calls made while
    # a "step" span that began with no profiler recording was open on
    # their thread
    spans: dict = field(default_factory=dict)
    step_spans: dict = field(default_factory=dict)
    # counter name -> count, and the part counted inside a step
    counters: dict = field(default_factory=dict)
    step_counters: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    _threads: _Thread = field(default_factory=_Thread, repr=False,
                              compare=False)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Add the block's wall time to phase `name`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.phases:
                self.order.append(name)
                self.phases[name] = 0.0
            self.phases[name] += dt

    def span(self, name: str) -> _Open:
        """A context manager that tallies the block under `name`."""
        return _Open(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to counter `name`."""
        in_step = self._threads.steps > 0
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if in_step:
                self.step_counters[name] = self.step_counters.get(name, 0) + n

    def _add(self, name: str, ns: int, self_ns: int, in_step: bool):
        with self._lock:
            for tally in ((self.spans, self.step_spans) if in_step
                          else (self.spans,)):
                s = tally.get(name)
                if s is None:
                    s = tally[name] = SpanStat()
                s.calls += 1
                s.total_ns += ns
                s.self_ns += self_ns

    def snapshot(self) -> "PhaseTimer":
        """A copy of the spans and counters so far."""
        with self._lock:
            return PhaseTimer(
                spans={k: SpanStat(v.calls, v.total_ns, v.self_ns)
                       for k, v in self.spans.items()},
                step_spans={k: SpanStat(v.calls, v.total_ns, v.self_ns)
                            for k, v in self.step_spans.items()},
                counters=dict(self.counters),
                step_counters=dict(self.step_counters))

    def since(self, before: "PhaseTimer") -> "PhaseTimer":
        """The spans and counters recorded after `before` (a snapshot)."""
        now = self.snapshot()

        def minus(cur, old):
            out = {}
            for k, v in cur.items():
                o = old.get(k, SpanStat())
                if v.calls > o.calls:
                    out[k] = SpanStat(v.calls - o.calls,
                                      v.total_ns - o.total_ns,
                                      v.self_ns - o.self_ns)
            return out

        def less(cur, old):
            return {k: v - old.get(k, 0) for k, v in cur.items()
                    if v > old.get(k, 0)}

        return PhaseTimer(
            spans=minus(now.spans, before.spans),
            step_spans=minus(now.step_spans, before.step_spans),
            counters=less(now.counters, before.counters),
            step_counters=less(now.step_counters, before.step_counters))

    def reset(self) -> None:
        """Forget every phase, span and counter."""
        with self._lock:
            for d in (self.phases, self.spans, self.step_spans,
                      self.counters, self.step_counters):
                d.clear()
            self.order.clear()

    def report(self, rays_cast: int | None = None) -> str:
        """Each phase's ms and share, the total, and with `rays_cast` the
        Mrays/s of the "render" phase; then, where spans or counters were
        recorded, each span's calls, inclusive, self and in-step ms, and
        each counter with its in-step part."""
        lines = []
        if self.phases or not (self.spans or self.counters):
            lines.append("--- phase timings ---")
            total = sum(self.phases.values())
            for name in self.order:
                dt = self.phases[name]
                lines.append(f"{name:>12}: {dt * 1000:9.1f} ms "
                             f"({dt / max(total, 1e-9) * 100:4.1f}%)")
            lines.append(f"{'total':>12}: {total * 1000:9.1f} ms")
            if rays_cast and self.phases.get("render", 0) > 0:
                mrays = rays_cast / self.phases["render"] / 1e6
                lines.append(f"{'throughput':>12}: {mrays:9.2f} Mrays/s")
        if self.spans or self.counters:
            lines.append("--- spans (host ms) ---")
            lines.append(f"{'span':>12}  {'calls':>8} {'total':>10} "
                         f"{'self':>10} {'in steps':>10}")
            for name, s in self.spans.items():
                in_step = self.step_spans.get(name, SpanStat())
                lines.append(f"{name:>12}: {s.calls:8d} "
                             f"{s.total_ns * 1e-6:10.1f} "
                             f"{s.self_ns * 1e-6:10.1f} "
                             f"{in_step.total_ns * 1e-6:10.1f}")
            for name, n in self.counters.items():
                lines.append(f"{name:>12}: {n:8d} "
                             f"({self.step_counters.get(name, 0)} in steps)")
        return "\n".join(lines)


# The program's tally: every span and counter of the port writes here,
# through `with span("shade"): ...` and `count("host_syncs")`. Counters:
# host_syncs (a site where the host waits for the card),
# shade_graph_replays and shade_graph_captures (ops/shade_graph.py: a
# shading segment replayed from its CUDA graph, a graph captured),
# light_launches (ops/light_cull.py: a launch of K5, the culled light pdf's
# kernel, whose calls the span "light" wraps with their lists),
# shade_kernel (ops/shade_graph.py: a "shade" span in which the shade
# kernel of ops/shade_kernel.py launched, eagerly or in a replayed graph).
PROCESS = PhaseTimer()
span = PROCESS.span
count = PROCESS.count


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Trace the block's host activity, and the card's kernels when
    `device` is a CUDA device, into log_dir/trace.json; the program's
    spans appear on the host timeline as rt::<name> ranges."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
