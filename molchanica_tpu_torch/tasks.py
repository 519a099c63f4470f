"""Background task registry: the headless analog of the reference's
thread-receiver registry (port of molchanica_tpu.tasks).

The reference declares one mpsc channel per async task kind
(`ThreadReceivers`, src/threads.rs:32-59: HTTP fetches, geostd params,
therapeutic properties, pharmacophore batches, GROMACS MD, structure
prediction) and polls them all once per UI frame (`handle_thread_rx`,
src/threads.rs:77; worker failures surface as Disconnected ->
UI errors, :206-214). The TPU-native equivalent keeps the same contract —
fire-and-forget named tasks, a cheap non-blocking poll that drains
whatever finished, errors surfaced at poll/join time rather than lost —
without the per-kind channel boilerplate: one registry, tasks are
closures dispatching torch work on daemon threads. A task given a CUDA
device runs with that device (its index fixed by the caller) as its
thread's current device, and its handle is marked done only after that
device has finished the task's work.

The REPL (`cli.py`) polls the registry before each prompt, the way the
reference polls per frame.
"""
from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class TaskError(RuntimeError):
    """A background task raised; carries the worker traceback."""


@dataclass
class TaskHandle:
    """One background task. `result`/`error` are set exactly once, then
    `done` fires; reads are safe without the lock after `done`."""
    name: str
    kind: str
    started: float
    _done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    error_tb: str = ""

    @property
    def running(self) -> bool:
        return not self._done.is_set()

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self.started

    def join(self, timeout: Optional[float] = None):
        """Block until finished; re-raise a worker failure as TaskError
        (the reference turns worker mpsc Disconnected into a UI error,
        src/threads.rs:206-214)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"task {self.name!r} still running")
        if self.error is not None:
            raise TaskError(
                f"task {self.name!r} failed: {self.error}\n{self.error_tb}"
            ) from self.error
        return self.result


class TaskRegistry:
    """Named background tasks + non-blocking poll.

    submit(kind, fn) -> TaskHandle; poll() drains tasks that finished
    since the last poll (reference handle_thread_rx contract: each
    completion is delivered exactly once)."""

    def __init__(self):
        self._tasks: Dict[str, TaskHandle] = {}
        self._unpolled: List[str] = []
        self._lock = threading.Lock()
        self._counter = 0

    def submit(self, kind: str, fn: Callable[[], Any],
               name: Optional[str] = None, cuda_device=None) -> TaskHandle:
        """Run fn() on a daemon thread. `cuda_device`: the CUDA device the
        work runs on (None: no CUDA device)."""
        with self._lock:
            self._counter += 1
            name = name or f"{kind}-{self._counter}"
            if name in self._tasks and self._tasks[name].running:
                raise ValueError(f"task {name!r} already running")
        handle = TaskHandle(name=name, kind=kind,
                            started=time.perf_counter())

        def work():
            try:
                handle.result = _run_on(cuda_device, fn)
            except BaseException as e:      # surfaced at poll/join
                handle.error = e
                handle.error_tb = traceback.format_exc(limit=8)
            finally:
                handle._done.set()
                with self._lock:
                    self._unpolled.append(name)

        with self._lock:
            self._tasks[name] = handle
        threading.Thread(target=work, daemon=True,
                         name=f"molchanica-task-{name}").start()
        return handle

    def poll(self) -> List[Tuple[str, TaskHandle]]:
        """Drain tasks completed since the last poll (each exactly once)."""
        with self._lock:
            names, self._unpolled = self._unpolled, []
            return [(n, self._tasks[n]) for n in names]

    def running(self) -> List[TaskHandle]:
        with self._lock:
            return [t for t in self._tasks.values() if t.running]

    def get(self, name: str) -> TaskHandle:
        with self._lock:
            if name not in self._tasks:
                raise KeyError(f"no task named {name!r}")
            return self._tasks[name]

    def join_all(self, timeout: Optional[float] = None):
        """Wait for every running task; returns handles that failed."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        failed = []
        for t in list(self.running()):
            left = None if deadline is None else \
                max(deadline - time.perf_counter(), 0.0)
            try:
                t.join(left)
            except TaskError:
                failed.append(t)
        return failed


def _run_on(cuda_device, fn):
    """fn() with `cuda_device` as the thread's current device, then wait
    for the device to finish the work fn queued on it."""
    if cuda_device is None:
        return fn()
    import torch

    dev = torch.device(cuda_device)
    if dev.type != "cuda" or dev.index is None:
        raise ValueError(f"cuda_device {cuda_device!r}: expected cuda:<index>")
    with torch.cuda.device(dev):
        out = fn()
        torch.cuda.synchronize(dev)
    return out


# Module-level default registry (the reference keeps ThreadReceivers on
# the State root; headless callers that don't hold a CliState share this).
REGISTRY = TaskRegistry()
