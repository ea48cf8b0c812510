"""Leveled logger (the reference's create_logger closure,
qgsw_raytrace.m:42-45, 182-189) plus a progress ticker (:173-175).

Counterpart of swraytracing_tpu/utils/logging.py, copied: it has no
device code."""

from __future__ import annotations

import sys
import time

__all__ = ["LOG_ERROR", "LOG_INFO", "LOG_VERBOSE", "create_logger",
           "Progress"]

LOG_ERROR = 0
LOG_INFO = 1
LOG_VERBOSE = 2


def create_logger(max_level: int = LOG_VERBOSE, stream=None):
    """Returns log(message, level=LOG_INFO, *args): printf-style, printed
    only when level <= max_level."""
    stream = stream or sys.stdout

    def log(message: str, level: int = LOG_INFO, *args):
        if level <= max_level:
            stream.write((message % args if args else message))
            if not message.endswith("\n"):
                stream.write("\n")
            stream.flush()

    return log


class Progress:
    """Percentage ticker, printed every `every` steps
    (qgsw_raytrace.m:173-175 prints every 51)."""

    def __init__(self, total: int, every: int = 51, log=None):
        self.total = total
        self.every = every
        self.log = log or create_logger()
        self.t0 = time.time()

    def tick(self, step: int):
        if step % self.every == 0 and step > 0:
            pct = 100.0 * step / self.total
            rate = step / (time.time() - self.t0)
            self.log(f"{pct:6.2f}%  ({rate:.1f} steps/s)", LOG_VERBOSE)
