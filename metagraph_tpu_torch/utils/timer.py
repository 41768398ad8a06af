"""Process memory and phase timing.

Own copy of ``get_curr_rss`` and ``get_peak_rss`` of
metagraph_tpu/utils/timer.py:28-45 (ref common/unix_tools.hpp:18-41), for
the server's ``/stats``, and of ``set_trace``, ``trace`` and
``PhaseTimer`` (:48-74), the phase lines that ``build -v`` prints on
stderr.
"""

from __future__ import annotations

import os
import sys
import time


def get_curr_rss() -> int:
    """Current resident set size in bytes."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def get_peak_rss() -> int:
    """Peak resident set size in bytes."""
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, ValueError):
        return 0


_VERBOSE = [False]


def set_trace(enabled: bool):
    _VERBOSE[0] = enabled


def trace(msg: str):
    """A phase or progress line on stderr, when tracing is on."""
    if _VERBOSE[0]:
        print(f"[trace] {msg}", file=sys.stderr)


class PhaseTimer:
    """Context manager: traces '<name>: X.XXX sec, RSS cur/peak MB' on
    exit."""

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        trace(f"{self.name}: {time.perf_counter() - self.t0:.3f} sec, "
              f"RSS {get_curr_rss() / 1e6:.0f}/{get_peak_rss() / 1e6:.0f} MB")
        return False
