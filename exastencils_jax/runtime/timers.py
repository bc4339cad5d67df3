"""Timing subsystem.

Reference: the generated StopWatch class + named timer registry
(timing/ir/IR_Stopwatch.scala:31,67), DSL builtins startTimer/stopTimer/
getTotalTime/printAllTimers/printTimerStatistics (IR_TimerFunctions.scala,
IR_PrintAllTimers.scala), MPI-reduced statistics (IR_ReduceTimers.scala),
and automatic timing of function categories (IR_AutomaticFunctionTiming).

Notes: `timer_syncDevice` maps to `jax.block_until_ready`
before reading the clock (the analog of cudaDeviceSynchronize); traces
integrate with `jax.profiler` via named annotations."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import jax


@dataclass
class Timer:
    """One named stopwatch (reference IR_Stopwatch: total/last/num)."""

    name: str
    total: float = 0.0
    last: float = 0.0
    num_entries: int = 0
    num_measurements: int = 0
    _start: Optional[float] = None

    def start(self):
        self.num_entries += 1
        if self.num_entries == 1:
            self._start = time.perf_counter()

    def stop(self):
        if self.num_entries == 0:
            raise RuntimeError(f"timer {self.name!r} stopped but not started")
        self.num_entries -= 1
        if self.num_entries == 0:
            self.last = time.perf_counter() - self._start
            self.total += self.last
            self.num_measurements += 1
            self._start = None

    @property
    def mean(self) -> float:
        return self.total / max(self.num_measurements, 1)


class TimerRegistry:
    """Named timer pool + the DSL timer builtins."""

    # reference timer_type backends (timing/ir/IR_Stopwatch.scala,
    # config/Knowledge.scala:311) — every one maps onto the host's
    # monotonic high-resolution clock here (time.perf_counter); the
    # value is validated so bogus .knowledge settings surface
    _CLOCKS = ("Chrono", "QPC", "WIN_TIME", "UNIX_TIME", "MPI_TIME",
               "WINDOWS_RDSC", "RDSC")

    def __init__(self, knowledge=None):
        self.timers: Dict[str, Timer] = {}
        self.knowledge = knowledge
        self.sync_device = getattr(knowledge, "timer_syncDevice", True)
        clock = getattr(knowledge, "timer_type", "Chrono")
        if clock not in self._CLOCKS:
            raise ValueError(
                f"timer_type {clock!r} not a reference clock backend "
                f"{self._CLOCKS}")
        self.clock = clock

    def _get(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def _sync(self, value=None):
        if self.sync_device:
            if value is not None:
                jax.block_until_ready(value)
            else:
                jax.effects_barrier()

    # --- DSL builtins (util timer functions) ---
    def start(self, name: str, pending=None):
        self._sync(pending)
        self._get(name).start()

    def stop(self, name: str, pending=None):
        self._sync(pending)
        self._get(name).stop()

    def get_total_time(self, name: str) -> float:
        return self._get(name).total * 1e3  # ms, like the reference default unit

    def get_mean_time(self, name: str) -> float:
        return self._get(name).mean * 1e3

    def get_last_time(self, name: str) -> float:
        return self._get(name).last * 1e3

    @contextlib.contextmanager
    def __call__(self, name: str):
        """with timers("solve"): ... — also emits a jax.profiler annotation."""
        self.start(name)
        with jax.profiler.TraceAnnotation(name):
            try:
                yield
            finally:
                self.stop(name)

    # --- automatic category timing (IR_AutomaticFunctionTiming) ---
    # Categories mirror IR_AutomaticTimingCategory (COMM/APPLYBC/IO; the
    # reference's PACK/UNPACK/WAIT phases have no distinct analog here —
    # a ppermute exchange is one op).  Timer naming follows the generated
    # code: autoTime_<CATEGORY>[@level]
    # (communication/ir/IR_RemoteSend.scala:96).

    def auto_enabled(self, category: str) -> bool:
        k = self.knowledge
        if k is None or not getattr(k, "timer_automaticTiming", False):
            return False
        return bool({
            "COMM": getattr(k, "timer_automaticCommTiming", False),
            "APPLYBC": getattr(k, "timer_automaticBCsTiming", False),
            "IO": getattr(k, "timer_automaticIOTiming", False),
        }.get(category, False))

    def auto_scope(self, category: str, level: Optional[int] = None):
        """Context manager timing one occurrence of a category (leveled
        for COMM/APPLYBC like IR_IV_AutomaticLeveledTimer); a no-op
        when the category is not enabled."""
        if not self.auto_enabled(category):
            return contextlib.nullcontext()
        name = f"autoTime_{category}"
        if level is not None:
            name = f"{name}@{level}"
        return self(name)

    # --- reporting (IR_PrintAllTimers / IR_PrintTimerStatistics) ---
    def print_all(self, out=print):
        for name in sorted(self.timers):
            t = self.timers[name]
            out(f"Timer {name}: {t.total * 1e3:.6f} ms ({t.num_measurements} measurements)")

    def print_statistics(self, out=print):
        for name in sorted(self.timers):
            t = self.timers[name]
            out(
                f"Timer {name}: total {t.total * 1e3:.6f} ms, "
                f"mean {t.mean * 1e3:.6f} ms, n {t.num_measurements}"
            )

    def as_dict(self) -> Dict[str, float]:
        return {n: t.total for n, t in self.timers.items()}
