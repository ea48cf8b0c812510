"""Logging and profiling utilities.

Counterpart of swraytracing_tpu/utils (its host-transfer helpers are a
workaround for one TPU backend and have no counterpart here).
"""

from . import logging, profiling
from .logging import create_logger, LOG_ERROR, LOG_INFO, LOG_VERBOSE, Progress
from .profiling import trace, Timer, time_callable

__all__ = ["logging", "profiling", "create_logger", "LOG_ERROR", "LOG_INFO",
           "LOG_VERBOSE", "Progress", "trace", "Timer", "time_callable"]
