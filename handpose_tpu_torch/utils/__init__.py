"""Run directories, logs and timers; device introspection and traces;
the spans of the program's phases (``utils.tracing``); visualisation
(``utils.vis``); FID (``utils.fid``)."""

from .device_info import (enable_compilation_cache, get_device_info,
                          get_device_utilization_as_string, profile_trace)
from .logging import RunLogger, StepStats, Timer, make_run_dir

__all__ = ["RunLogger", "StepStats", "Timer", "make_run_dir",
           "enable_compilation_cache", "get_device_info",
           "get_device_utilization_as_string", "profile_trace"]
