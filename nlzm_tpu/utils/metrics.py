"""Per-stage timing and throughput observability.

The reference's only instrumentation is wall-clock prints around the codec
loops (NLZM.cpp:1780,1899,2035) and a startup memory report
(NLZM.cpp:1755-1759). This module provides the framework equivalent:
nestable stage timers with byte counters, a GB/s readout per stage, and a
memory-budget report for the selected configuration. `jax.profiler` traces
can wrap any stage via `trace=True`.
"""

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Stage:
    name: str
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0

    @property
    def mb_per_s(self) -> float:
        return self.bytes / self.seconds / 1e6 if self.seconds > 0 else 0.0


@dataclass
class Metrics:
    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0, trace: bool = False):
        st = self.stages.setdefault(name, Stage(name))
        ctx = contextlib.nullcontext()
        if trace:
            import jax

            ctx = jax.profiler.TraceAnnotation(name)
        t0 = time.perf_counter()
        with ctx:
            yield st
        st.seconds += time.perf_counter() - t0
        st.bytes += nbytes
        st.calls += 1

    def report(self) -> str:
        lines = []
        for st in self.stages.values():
            rate = f" {st.mb_per_s:8.2f} MB/s" if st.bytes else ""
            lines.append(f"  {st.name:<24} {st.seconds:8.3f} s  x{st.calls}{rate}")
        return "\n".join(lines)


def memory_report(hist_bits: int, block_size: int = 0, batch_blocks: int = 0) -> str:
    """Working-set budget for a configuration (reference: NLZM.cpp:1755-1759)."""
    from ..constants import PARSE_TABLE_SIZE, frame_bits_for

    def kb(n):
        return f"{(n + 1023) >> 10} KB"

    window = 1 << hist_bits
    frame = 1 << frame_bits_for(hist_bits)
    clamp = lambda v, lo, hi: max(lo, min(hi, v))
    search = (
        4 * (1 << 12)  # ht2
        + 2 * 4 * (1 << (12 + clamp(hist_bits, 15, 17) - 15))  # ht3
        + 4 * ((1 << (13 + clamp(hist_bits, 16, 20) - 16)) + (2 << hist_bits))  # bt4
        + 4 * (1 << (15 + clamp(hist_bits, 16, 22) - 16))  # rk
    )
    lines = [
        f"  Model:             {kb(2 * 916 + 16)}",
        f"  Parser:            {kb(20 * (PARSE_TABLE_SIZE + 1))}",
        f"  Dictionary:        {kb(window)}",
        f"  Frame:             {kb(frame)}",
        f"  Dictionary search: {kb(search)}",
    ]
    if block_size and batch_blocks:
        bank = batch_blocks * 916 * 4
        streams = batch_blocks * (block_size + 64)
        out = batch_blocks * block_size
        lines.append(f"  Device model bank: {kb(bank)}  ({batch_blocks} blocks)")
        lines.append(f"  Device streams:    {kb(streams + out)}")
    return "\n".join(lines)


class ProgressLine:
    """Reference-style carriage-return progress/ETA line.

    Mirrors print_fill (NLZM.cpp:1695-1709, usage :1857-1868): rewrites
    one status line in place, erasing the previous line's tail with
    spaces, and estimates time left from bytes processed so far. Prints
    at most every `interval` seconds and only when stderr is a TTY
    (or `force`)."""

    def __init__(self, total: int, label: str = "Working", interval: float = 0.25, force: bool = False):
        import sys

        self.total = max(total, 1)
        self.label = label
        self.interval = interval
        self.t0 = time.time()
        self.last_print = 0.0
        self.last_width = 0
        self.enabled = force or sys.stderr.isatty()

    def update(self, done: int, out_bytes: int | None = None) -> None:
        if not self.enabled:
            return
        now = time.time()
        if now - self.last_print < self.interval and done < self.total:
            return
        self.last_print = now
        elapsed = now - self.t0
        msg = f"{self.label}... {done} / {self.total}"
        if out_bytes is not None:
            msg += f" -> {out_bytes}"
        if done and elapsed > 1.0 and done < self.total:
            left = max(2, int(elapsed * (self.total - done) / done))
            msg += f" ~{left} seconds left"
        import sys

        pad = " " * max(0, self.last_width - len(msg))
        print(f"{msg}{pad}\r", end="", file=sys.stderr, flush=True)
        self.last_width = len(msg)

    def finish(self) -> None:
        if not self.enabled or not self.last_width:
            return
        import sys

        print(" " * self.last_width + "\r", end="", file=sys.stderr, flush=True)
