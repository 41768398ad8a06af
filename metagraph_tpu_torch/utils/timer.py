"""Process memory for the server's ``/stats``.

Own copy of ``get_curr_rss`` and ``get_peak_rss`` of
metagraph_tpu/utils/timer.py:28-45 (ref common/unix_tools.hpp:18-41).
"""

from __future__ import annotations

import os


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
