"""Spans around the calls into the program's layers, recorded from the
benchmark's own files: wrappers installed on module attributes that the
program looks up at call time. Self time is a span's length less the spans
nested in it on the same thread.

The gate wrappers are installed in every run: once the window has closed
they park the program's threads at the next nuclide, so the output check
has the CPU to itself. They cost one function call a nuclide.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class Span:
    name: str
    thread: int
    t0: float
    t1: float
    children: float = 0.0
    overhead: float = 0.0  # the recorder's own work inside this span
    moments: int = 0  # write_nuclide: scatter values it wrote

    @property
    def self_s(self) -> float:
        return self.t1 - self.t0 - self.children

    @property
    def busy_s(self) -> float:
        return self.t1 - self.t0 - self.overhead


class Recorder:
    def __init__(self):
        self.spans: list[Span] = []
        self.open: dict[int, Span] = {}  # spans entered and not yet left
        self.recording = False
        self._local = threading.local()
        self._restore: list[tuple[object, str, object]] = []

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def wrap(self, owner, attr: str, name: str, on_return=None) -> None:
        """Replace owner.attr by a recording wrapper. on_return(span, args,
        result) runs after the span has closed, outside its time."""
        inner = getattr(owner, attr)
        rec = self

        def wrapper(*args, **kwargs):
            if not rec.recording:
                return inner(*args, **kwargs)
            stack = rec._stack()
            span = Span(name, threading.get_ident(), time.perf_counter(), 0.0)
            stack.append(span)
            rec.open[id(span)] = span
            try:
                result = inner(*args, **kwargs)
            finally:
                span.t1 = time.perf_counter()
                rec.open.pop(id(span), None)
                stack.pop()
                if stack:
                    stack[-1].children += span.t1 - span.t0
                rec.spans.append(span)
            if on_return is not None:
                t = time.perf_counter()
                on_return(span, args, result)
                cost = time.perf_counter() - t
                for outer in stack:
                    outer.overhead += cost
                    outer.children += cost if outer is stack[-1] else 0.0
            return result

        self._restore.append((owner, attr, inner))
        setattr(owner, attr, wrapper)

    def close(self, t: float) -> list[Span]:
        """Every span recorded, those still open ended at t."""
        self.recording = False
        still = [Span(s.name, s.thread, s.t0, t, s.children, s.overhead) for s in list(self.open.values())]
        return self.spans + still

    def restore(self) -> None:
        for owner, attr, inner in reversed(self._restore):
            setattr(owner, attr, inner)
        self._restore.clear()


class GateClosed(Exception):
    """Raised in the program's threads once a parked run is released."""


class Gate:
    """Counts the nuclides the program starts and the ones it quarantines,
    and parks its threads once closed. release() lets them go on by raising
    GateClosed, which ends the pass (the CPU tests join the run's threads)."""

    def __init__(self):
        self.closed = threading.Event()
        self.started = 0
        self.failed = 0
        self._released = threading.Event()

    def release(self) -> None:
        self._released.set()

    def _park(self) -> None:
        if self.closed.is_set():
            self._released.wait()
            raise GateClosed()

    def install(self, driver_mod, writer_cls, before_write=None) -> None:
        """before_write(fh) runs in the writer's thread before each nuclide."""
        process = driver_mod._process_with_oom_retry
        write = writer_cls.write_nuclide
        gate = self

        def gated_process(*args, **kwargs):
            gate._park()
            gate.started += 1
            try:
                return process(*args, **kwargs)
            except Exception:
                gate.failed += 1
                raise

        def gated_write(self_, res):
            gate._park()
            if before_write is not None:
                before_write(self_.fh)
            return write(self_, res)

        self._restore = [(driver_mod, "_process_with_oom_retry", process), (writer_cls, "write_nuclide", write)]
        driver_mod._process_with_oom_retry = gated_process
        writer_cls.write_nuclide = gated_write

    def uninstall(self) -> None:
        for owner, attr, inner in self._restore:
            setattr(owner, attr, inner)
