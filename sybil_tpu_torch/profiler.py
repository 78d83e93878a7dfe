"""Profiling & phase timing.

The reference gates pprof CPU/heap profiles behind a `profile` build tag
(-profile/-mem flags, src/lib/profiler_enable.go:28-31, config.go:171-174)
and sprinkles DEBUG_TIMING wall-clock lines around every IO/combine phase
(e.g. table_query.go:155-161,367-378).  The equivalents here:

- `-profile` captures a torch.profiler trace (CUDA kernel timeline +
  host events) into `<profile-dir>/trace.json`, viewable with Perfetto
  or chrome://tracing.
- PhaseTimer accumulates per-phase wall timings (bind / load / dispatch /
  download / merge / finish) and reports one breakdown line via debug(),
  so "where does the query wall time go" is one -debug run away.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class PhaseTimer:
    """Accumulates wall time per named phase.  Cheap enough to always be
    on; reporting is gated by the debug flag."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def wall(self) -> float:
        return time.perf_counter() - self._t0

    def report(self, label: str = "query") -> str:
        wall = self.wall()
        accounted = sum(self.totals.values())
        parts = [f"{name} {self.totals[name] * 1e3:.1f}ms"
                 f"/{self.counts[name]}"
                 for name in sorted(self.totals, key=self.totals.get,
                                    reverse=True)]
        line = (f"{label.upper()} TIMING wall {wall * 1e3:.1f}ms | "
                + " | ".join(parts)
                + f" | other {(wall - accounted) * 1e3:.1f}ms")
        from .debug import debug
        debug(line)
        return line


class _NullTimer:
    """No-op stand-in so call sites need no conditionals."""

    @contextmanager
    def phase(self, name: str):
        yield

    def wall(self) -> float:
        return 0.0

    def report(self, label: str = "") -> str:
        return ""


NULL_TIMER = _NullTimer()


@contextmanager
def device_trace(profile_dir: str | None):
    """torch.profiler trace capture around a block (the -profile flag)."""
    if not profile_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    from .debug import print_
    print_("profile trace written to", path)
