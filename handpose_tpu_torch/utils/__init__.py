"""Run directories, logs and timers."""

from .logging import RunLogger, StepStats, Timer, make_run_dir

__all__ = ["RunLogger", "StepStats", "Timer", "make_run_dir"]
