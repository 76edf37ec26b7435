"""Span tracer: the one timing mechanism of sweeps and benchmarks.

Counterpart of ``repro/telemetry/trace.py`` (pure Python; the port keeps its
own copy).  A span-tree API::

    from repro_torch.telemetry import trace

    with trace.span("partition", scenarios=5, device=dev) as sp:
        result = run_partition(...)
    print(sp.duration_us)

Spans nest (a ``with`` inside a ``with`` becomes a child span) and the
whole tree exports as Chrome trace-event JSON — ``trace.export(path)``
writes a ``{"traceEvents": [...]}`` document loadable in Perfetto or
``chrome://tracing``.  The process-global tracer is what the module-level
helpers operate on; ``Tracer`` instances can be used standalone (tests).

Work on the card is asynchronous: a span closes when the host has queued
its kernels, not when they have run.  ``span(..., device=d)`` with a CUDA
device synchronises ``d`` when the span opens and again before it closes,
so its duration covers the device work queued inside it (the ``device``
argument is not exported as an attribute).  ``timed_call``'s ``block``
does the same for each timed call.

``torch_profile(path)`` wraps a block in ``torch.profiler`` (host and CUDA
activities) and, given a path, writes the profiler's own Chrome trace
beside the host spans.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = [
    "Span", "Timing", "Tracer", "export", "get_tracer", "reset", "span",
    "spans", "sync_device", "timed_call", "to_chrome_trace",
    "torch_profile",
]


@dataclass
class Span:
    """One timed interval.  ``duration_us`` is valid after the ``with``
    block exits; ``attrs`` may be extended inside the block (they export
    as the Chrome event's ``args``)."""

    name: str
    start_us: float
    duration_us: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)
    tid: int = 0


class Timing(float):
    """A median-microseconds float that also carries the compile/run split.

    ``float(t)`` (and all arithmetic) is the median run time per call in
    microseconds, so existing ``emit(name, time_call(...), ...)`` callers
    keep working; ``t.compile_us`` is the first-call (compile-inclusive)
    wall time and ``t.run_us`` the steady-state median.
    """

    compile_us: Optional[float]
    run_us: float

    def __new__(cls, run_us: float, compile_us: Optional[float] = None):
        self = float.__new__(cls, run_us)
        self.run_us = float(run_us)
        self.compile_us = None if compile_us is None else float(compile_us)
        return self


class Tracer:
    """A span tree with a per-thread open-span stack."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._stacks: Dict[int, List[Span]] = {}
        self.roots: List[Span] = []

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, *, device: Any = None,
             **attrs: Any) -> Iterator[Span]:
        sync_device(device)
        tid = threading.get_ident()
        sp = Span(name=name, start_us=self._now_us(), attrs=dict(attrs),
                  tid=tid & 0xFFFF)
        with self._lock:
            stack = self._stacks.setdefault(tid, [])
            (stack[-1].children if stack else self.roots).append(sp)
            stack.append(sp)
        try:
            yield sp
        finally:
            sync_device(device)
            sp.duration_us = self._now_us() - sp.start_us
            with self._lock:
                self._stacks[tid].pop()

    def reset(self) -> None:
        self.__init__()

    def spans(self) -> List[Span]:
        return list(self.roots)

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The span tree as a Chrome trace-event document (Perfetto-loadable):
        one ``ph="X"`` complete event per span, µs timestamps."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "repro_torch"},
        }]

        def visit(sp: Span) -> None:
            events.append({
                "name": sp.name, "cat": "repro_torch", "ph": "X",
                "ts": sp.start_us, "dur": sp.duration_us,
                "pid": pid, "tid": sp.tid,
                "args": {k: _json_safe(v) for k, v in sp.attrs.items()},
            })
            for child in sp.children:
                visit(child)

        for root in self.roots:
            visit(root)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> Dict[str, Any]:
        doc = self.to_chrome_trace()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        return doc


def sync_device(device: Any) -> None:
    """Wait for ``device``'s queued work when it is a CUDA device (or a
    tensor on one); anything else, None included, is a no-op."""
    if device is None:
        return
    import torch

    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _json_safe(v: Any) -> Any:
    """Chrome's ``args`` values must be JSON: numbers/strings/bools pass
    through (non-finite floats stringify), everything else reprs."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return v if v == v and abs(v) != float("inf") else repr(v)
    return repr(v)


# ---------------------------------------------------------------------------
# The process-global tracer (what sweep/benchmarks record into).
# ---------------------------------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, *, device: Any = None, **attrs: Any):
    """``with trace.span("partition", scenarios=5) as sp: ...``; a CUDA
    ``device`` makes the span cover the device work queued inside it."""
    return _TRACER.span(name, device=device, **attrs)


def reset() -> None:
    _TRACER.reset()


def spans() -> List[Span]:
    return _TRACER.spans()


def to_chrome_trace() -> Dict[str, Any]:
    return _TRACER.to_chrome_trace()


def export(path: str) -> Dict[str, Any]:
    """Write the global span tree as Chrome trace JSON; returns the doc."""
    return _TRACER.export(path)


def timed_call(
    fn: Callable,
    *args: Any,
    warmup: int = 1,
    iters: int = 5,
    block: Optional[Callable[[Any], Any]] = None,
    name: Optional[str] = None,
) -> Timing:
    """Median wall time per call, with the compile/run split as spans.

    The first warmup call runs inside a ``compile:<name>`` span (for jitted
    callables that is where compilation lands); the timed iterations run
    inside one ``run:<name>`` span.  ``block`` is applied to each result
    before the clock stops (pass ``trace.sync_device`` of the result for
    work on the card, or a function that waits for it).
    """
    label = name or getattr(fn, "__name__", None) or "call"
    sink = block if block is not None else (lambda x: x)
    compile_us: Optional[float] = None
    if warmup > 0:
        with span(f"compile:{label}") as sp:
            sink(fn(*args))
        compile_us = sp.duration_us
        for _ in range(warmup - 1):
            sink(fn(*args))
    times = []
    with span(f"run:{label}", iters=iters) as sp:
        for _ in range(iters):
            t0 = time.perf_counter()
            sink(fn(*args))
            times.append(time.perf_counter() - t0)
    times.sort()
    run_us = times[len(times) // 2] * 1e6
    sp.attrs["median_us"] = run_us
    return Timing(run_us, compile_us=compile_us)


@contextmanager
def torch_profile(path: Optional[str] = None) -> Iterator[Any]:
    """Run a block under ``torch.profiler`` with host and (when a GPU is
    visible) CUDA activities; yields the profiler, whose
    ``key_averages()`` holds the kernels' device times.  ``path`` writes
    its Chrome trace there when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    if path is not None:
        prof.export_chrome_trace(str(path))
