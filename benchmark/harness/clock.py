"""The set-up clock: seconds from the process's start, as the kernel
recorded it, to a moment of the run."""

from __future__ import annotations

import os
import time


def process_start() -> float:
    """The epoch second at which this process started (``/proc``), to the
    kernel's clock tick."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])  # field 22, starttime, counted after the comm field
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def since_start() -> float:
    return time.time() - process_start()
