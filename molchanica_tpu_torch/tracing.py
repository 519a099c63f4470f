"""Spans and counters of the port, on the clock torch.profiler stamps its
events with.

`span(name)` marks a phase of the host's work (the replica farm's rebuild,
force evaluations, PME, constraints, ...). While tracing is off it costs
one flag test and returns a shared no-op object. While it is on, each span
appends (name, span id, parent id, thread id, start_ns, end_ns) to an
in-memory list that `collect()` hands over: the thread id is
`threading.get_ident()` (pthread_self), whose low 32 bits are the thread
id CUPTI, and so kineto, gives the CUDA runtime calls a thread makes
(`KinetoEvent.device_resource_id()`; `threading.get_native_id()` is not
it), the parent the innermost span open on the same thread (a span opened
on another thread, such as autograd's CUDA worker, starts its own chain),
and the times are `time.perf_counter_ns()` shifted to the epoch by one
offset taken at `enable()`, the base of kineto's `KinetoEvent.start_ns()`.
So a profile of the same window can put each
kernel and each idle gap of the device down to the span that was open
when it was launched or happened (`benchmark/spans.py`).

This module only reads the host's clock: it launches nothing, never
synchronizes and allocates nothing on a device.

Counters (`count`, `counters`, `reset_counters`) are named integers,
always on: the kernels' launch counts ("direct_force", "probe_prefetch",
"cluster_force", "pme_spread", "pme_gather", and one per colpair instance
name, "colpair_...") and
K2's rebuilds ("k2_rebuild", one per call of its rebuild, batched or not).
"""
from __future__ import annotations

import itertools
import threading
import time

_on = False          # spans record only while set
_offset_ns = 0       # epoch ns - perf_counter ns, taken at enable()
_spans = []
_ids = itertools.count(1)
_local = threading.local()
_counts = {}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _thread():
    """(this thread's stack of open span ids, its id)."""
    try:
        return _local.stack, _local.tid
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_ident()
        return _local.stack, _local.tid


class _Span:
    __slots__ = ("name", "id", "parent", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack, _ = _thread()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack, tid = _thread()
        stack.pop()
        _spans.append((self.name, self.id, self.parent, tid,
                       self.start + _offset_ns, end + _offset_ns))
        return False


def span(name: str):
    """A context manager marking the phase `name` (a no-op while tracing
    is off)."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


def enable():
    """Start recording spans, their times on the epoch's clock from here
    on."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable():
    """Stop recording spans; spans still open are recorded when they
    close."""
    global _on
    _on = False


def collect():
    """The spans recorded so far, [(name, id, parent id, thread id,
    start_ns, end_ns)] in the order they closed; clears them."""
    global _spans
    out, _spans = _spans, []
    return out


def count(name: str, n: int = 1):
    _counts[name] = _counts.get(name, 0) + n


def counters(prefix: str = "") -> dict:
    """{name: count} of the counters whose name starts with prefix."""
    return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str = ""):
    """Drop the counters whose name starts with prefix."""
    for k in list(counters(prefix)):
        del _counts[k]
