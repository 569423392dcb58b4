"""The library as it streams out of the writer, read from an in-memory file.

The port's ASCII writer (`AsciiLibraryWriter`) is given the path
/proc/<pid>/fd/<n> of an anonymous memory file (`os.memfd_create`):
nothing reaches a disk. A reader thread follows the file. Before the writer
starts each nuclide (its previous block flushed), rewind() lets the reader
catch up, empties the file and moves the writer's offset back to 0, so the
file never holds more than one nuclide's block whatever the rate. (Punching
out the consumed part with fallocate would be finer, but the card's
machine refuses PUNCH_HOLE on a memory file.)

The reader reads almost none of the library. Every value line of the
format is fixed width (four values of 26 characters and a newline), so each
array's byte length follows from the keyword line before it: the parser
reads only the keyword lines and the parts the output check keeps (each
nuclide's header line, energy grid, temperatures, `sigma_scatter`, small
optional arrays such as chi, and the sampled rows of `scatter`), each with
one `os.pread`, and skips the rest by offset. It counts the `scatter`
values that have reached the file: whole nuclides by their `end_nuclide`
marker, the nuclide in progress by the scatter lines written so far.
Offsets are of the pass's whole stream; the file holds the part of it from
`base` on.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

VALUE_WIDTH = 26
LINE = 4 * VALUE_WIDTH + 1
_KEEP_WHOLE = 1 << 16  # optional arrays up to this many values are kept whole
_LINE_PROBE = 4096  # bytes read to find a keyword line's end (grown if needed)


def array_bytes(n: int) -> int:
    """Byte length of an n-value array in the format (4 values a line)."""
    full, rest = divmod(n, 4)
    return full * LINE + (rest * VALUE_WIDTH + 1 if rest else 0)


def value_offset(k: int) -> int:
    """Byte offset of value k inside its array."""
    return (k // 4) * LINE + (k % 4) * VALUE_WIDTH


def parse_values(raw: bytes) -> np.ndarray:
    return np.array(raw.split(), dtype=np.float64)


@dataclass
class NuclideBlock:
    """What the check keeps of one nuclide of the library."""

    name: str
    header: list[str]
    arrays: dict[str, np.ndarray] = field(default_factory=dict)
    shapes: dict[str, tuple[int, ...]] = field(default_factory=dict)
    rows: dict[tuple[int, int], np.ndarray] = field(default_factory=dict)  # (t, e) -> (L+1, G)
    complete: bool = False


@dataclass
class LibraryHeader:
    lines: list[str] = field(default_factory=list)
    bounds: np.ndarray | None = None


class StreamParser:
    """Incremental parser of one library pass.

    advance(fetch, end): fetch(a, b) returns the stream's bytes [a, b);
    end is how much of the stream exists. choose_rows(block, energy, shape)
    gives the incident rows of a nuclide to keep.
    """

    def __init__(self, choose_rows):
        self.choose_rows = choose_rows
        self.header = LibraryHeader()
        self.blocks: list[NuclideBlock] = []
        self.done_values = 0  # scatter values of nuclides whose end_nuclide arrived
        self.current: NuclideBlock | None = None
        self.scatter_got = 0  # scatter bytes of the nuclide in progress
        self.scatter_shape: tuple[int, ...] | None = None
        self.ended = False
        self.faults: list[str] = []  # what did not parse as the format says
        self.cur = 0  # stream offset of the next item
        self._pending = None  # (key, shape, start, nbytes) of the array being passed
        self._cuts: list[tuple[int, int, object]] = []  # (start, end, tag) still to read

    def in_progress_values(self) -> int:
        if self.scatter_shape is None:
            return 0
        n = int(np.prod(self.scatter_shape))
        return min(n, (self.scatter_got // LINE) * 4)

    def values(self) -> int:
        """scatter values that reached the library so far in this pass."""
        return self.done_values + self.in_progress_values()

    def advance(self, fetch, end: int) -> None:
        while True:
            if self._pending is None:
                if self.cur >= end:
                    return
                probe = _LINE_PROBE
                while True:
                    chunk = fetch(self.cur, min(end, self.cur + probe))
                    i = chunk.find(b"\n")
                    if i >= 0 or self.cur + probe >= end:
                        break
                    probe *= 4
                if i < 0:
                    return  # the line is not whole yet
                line = chunk[:i].decode(errors="replace")
                self.cur += i + 1
                self._keyword(line)
                continue
            key, shape, start, nbytes = self._pending
            if key == "scatter":
                self.scatter_got = max(0, min(end, start + nbytes) - start)
            while self._cuts and self._cuts[0][1] <= end:
                a, b, tag = self._cuts.pop(0)
                self._cut(key, shape, tag, fetch(a, b))
            if end < start + nbytes:
                return
            self._pending = None
            self.cur = start + nbytes

    def _start_array(self, key: str, shape: tuple[int, ...]) -> None:
        n = int(np.prod(shape))
        nbytes = array_bytes(n)
        self._pending = (key, shape, self.cur, nbytes)
        if key == "scatter":
            self.scatter_shape = shape
            self.scatter_got = 0
            nt, ne, lp1, ng = shape
            per = lp1 * ng
            cuts = []
            for e in self.choose_rows(self.current, self.current.arrays.get("energy"), shape):
                for t in range(nt):
                    k0 = (t * ne + e) * per
                    cuts.append((self.cur + value_offset(k0), self.cur + value_offset(k0 + per), (t, e)))
            self._cuts = sorted(cuts)
        elif n <= _KEEP_WHOLE:
            self._cuts = [(self.cur, self.cur + nbytes, None)]
        else:
            self._cuts = []
        if self.current is not None:
            self.current.shapes[key] = shape

    def _cut(self, key, shape, tag, raw: bytes) -> None:
        try:
            vals = parse_values(raw)
        except ValueError as e:
            self.faults.append(f"{key}: {e}")
            return
        want = shape[2] * shape[3] if key == "scatter" else int(np.prod(shape))
        if vals.size != want:
            self.faults.append(f"{key} {tag}: {vals.size} values where {want} belong; "
                               f"{raw[:60]!r} ... {raw[-60:]!r}")
            return
        if key == "bounds":
            self.header.bounds = vals
        elif key == "scatter":
            self.current.rows[tag] = vals.reshape(shape[2], shape[3])
        elif self.current is not None:
            self.current.arrays[key] = vals.reshape(shape)

    def _keyword(self, line: str) -> None:
        parts = line.split()
        if not parts:
            return
        key = parts[0]
        if not self.header.lines and not line.startswith("NDPP-TPU ASCII LIBRARY"):
            self.faults.append(f"the pass does not start with the format's first line: {line[:80]!r}")
        if self.current is None:
            if key == "nuclide":
                self.current = NuclideBlock(name=parts[1], header=parts)
            elif key == "end_library":
                self.ended = True
            elif key == "group_structure":
                self.header.lines.append(line)
                self._start_array("bounds", (int(parts[2]) + 1,))
            elif key != "metrics":
                self.header.lines.append(line)
            return
        if key == "end_nuclide":
            blk = self.current
            blk.complete = parts[1] == blk.name
            if self.scatter_shape is not None:
                self.done_values += int(np.prod(self.scatter_shape))
            self.blocks.append(blk)
            self.current, self.scatter_shape, self.scatter_got = None, None, 0
            return
        try:
            shape = tuple(int(x) for x in parts[1:])
        except ValueError:
            self.faults.append(f"not a keyword line: {line[:80]!r}")
            return
        self._start_array(key, shape)


class MemLibrary:
    """An anonymous memory file for the library, and the thread that reads it.

    Each pass: reset() (with no writer open), then the port writes to
    `path`; drain() reads to the end of what was written. rewind(fh) runs
    in the writer's thread between its nuclides.
    """

    def __init__(self, choose_rows, poll_s: float = 0.05):
        self.fd = os.memfd_create("ndpp-library", os.MFD_CLOEXEC)
        self.path = f"/proc/{os.getpid()}/fd/{self.fd}"
        self.choose_rows = choose_rows
        self.poll_s = poll_s
        self.lock = threading.Lock()
        self.passes: list[StreamParser] = []
        self.parser = StreamParser(choose_rows)
        self.base = 0  # stream offset of the file's first byte
        self.peak_resident = 0  # largest size the file reached, bytes
        self.thread_cpu_s = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="bench-library-reader", daemon=True)
        self._thread.start()

    def _fetch(self, a: int, b: int) -> bytes:
        return os.pread(self.fd, b - a, a - self.base)

    def _read(self) -> None:
        size = os.fstat(self.fd).st_size
        self.peak_resident = max(self.peak_resident, size)
        self.parser.advance(self._fetch, self.base + size)

    def _empty(self) -> None:
        os.ftruncate(self.fd, 0)
        if os.fstat(self.fd).st_size != 0:
            raise OSError("the library's memory file did not empty")

    def reset(self) -> None:
        """Before a pass: read what is left and empty the file (the writer's
        own truncation is not relied on)."""
        with self.lock:
            self._read()
            self._empty()
            self.parser = StreamParser(self.choose_rows)
            self.passes.append(self.parser)
            self.base = 0

    def rewind(self, fh) -> None:
        """Catch up, empty the file, and put the writer's offset (its buffer
        is flushed) back at 0."""
        fh.flush()  # before the first nuclide the header may sit in the buffer
        with self.lock:
            self._read()
            size = os.fstat(self.fd).st_size
            if self.parser.cur != self.base + size:
                self.parser.faults.append("the reader had not reached the end of a nuclide at its rewind")
            self._empty()
            os.lseek(fh.fileno(), 0, os.SEEK_SET)
            self.base += size

    def _loop(self) -> None:
        t0 = time.thread_time()
        while not self._stop.is_set():
            with self.lock:
                self._read()
            self.thread_cpu_s = time.thread_time() - t0
            self._stop.wait(self.poll_s)

    def snapshot(self) -> int:
        """Read to the end of what is written now; scatter values of all passes."""
        with self.lock:
            self._read()
            return sum(p.values() for p in self.passes)

    def drain(self) -> None:
        with self.lock:
            self._read()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
