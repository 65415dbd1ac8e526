"""Run directories, TensorBoard scalars, plain-text logs, timers.

Port of ``handpose_tpu/utils/logging.py:24-131``: the run directory
``<save_log_dir>/<model>/<dataset>/run_<timestamp>/`` with the config
snapshot (``config.json``) and the code revision (``provenance.json``),
TensorBoard scalars (through ``torch.utils.tensorboard`` where its
``tensorboard`` package is installed, else none, as the JAX package does
with tensorboardX), ``log.txt`` and the console (``NullLogger`` off the
lead rank), and the step-time against input-stall timers of every epoch
line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types
from datetime import datetime
from typing import Optional


def make_run_dir(save_log_dir: str, model_name: str, dataset_name: str,
                 config_json: Optional[str] = None,
                 provenance: Optional[dict] = None) -> str:
    """Create the run directory with ``config.json`` (``config_json``,
    when given) and ``provenance.json`` (with ``provenance``'s entries);
    returns its path."""
    ts = datetime.now().strftime("%Y-%m-%d-%H-%M-%S-%f")
    run_dir = os.path.join(save_log_dir, model_name, dataset_name,
                           f"run_{ts}")
    os.makedirs(run_dir, exist_ok=True)
    if config_json is not None:
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            f.write(config_json)
    _write_provenance(run_dir, provenance or {})
    return run_dir


def _git(*args: str) -> str:
    return subprocess.run(["git", *args], capture_output=True, text=True,
                          timeout=5, check=True,
                          cwd=os.path.dirname(os.path.abspath(__file__))
                          ).stdout.strip()


def _write_provenance(run_dir: str, extra: dict) -> None:
    """The time, ``extra`` and, where the package lies in a git checkout,
    its revision and whether the tree had changes."""
    info = {"timestamp": datetime.now().isoformat(), **extra}
    try:
        info["git_rev"] = _git("rev-parse", "HEAD")
        info["git_dirty"] = bool(_git("status", "--porcelain"))
    except (OSError, subprocess.SubprocessError):
        pass              # not a checkout, or no git: the time alone
    with open(os.path.join(run_dir, "provenance.json"), "w") as f:
        json.dump(info, f, indent=2)


def _summary_writer(run_dir: str):
    """torch's ``SummaryWriter`` on ``run_dir``, or None without the
    ``tensorboard`` package.  The writer touches only local files, so
    TensorBoard's own switch to its TensorFlow stub (the module
    ``tensorboard.compat.notf``) is set unless TensorFlow is loaded
    already: where TensorFlow is installed, importing it would add tens of
    seconds to every run's start."""
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(run_dir)


class RunLogger:
    """TensorBoard scalars, ``<run_dir>/log.txt`` and the console."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.writer = _summary_writer(run_dir)
        self.log_path = os.path.join(run_dir, "log.txt")

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, global_step=step)

    def text(self, info: str):
        print(info, flush=True)
        with open(self.log_path, "a") as f:
            f.write(info + "\n")

    def close(self):
        if self.writer is not None:
            self.writer.close()


class NullLogger:
    """:class:`RunLogger`'s interface, doing nothing: a rank other than
    the lead owns no run directory, TensorBoard file or ``log.txt``."""

    log_path = None

    def scalar(self, tag: str, value: float, step: int):
        pass

    def text(self, info: str):
        pass

    def close(self):
        pass


class Timer:
    """Cumulative host-clock timer."""

    def __init__(self):
        self.total = 0.0
        self.calls = 0
        self._start = None

    def tic(self):
        self._start = time.perf_counter()

    def toc(self, n: int = 1) -> float:
        """The seconds since :meth:`tic`, booked as ``n`` calls."""
        dt = time.perf_counter() - self._start
        self.total += dt
        self.calls += n
        return dt

    @property
    def average(self) -> float:
        return self.total / max(self.calls, 1)


class StepStats:
    """Train-loop health: step time against input-stall time, and the
    host time of each train step (``train_seconds``)."""

    def __init__(self):
        self.step = Timer()
        self.input = Timer()
        self.train_seconds: list = []

    def train_toc(self, n: int = 1) -> None:
        """Close the step timer over ``n`` train steps (a
        ``steps_per_dispatch`` group), each booked its equal share."""
        dt = self.step.toc(n)
        self.train_seconds.extend([dt / n] * n)

    def summary(self) -> str:
        share = self.input.total / max(self.step.total + self.input.total,
                                       1e-9)
        return (f"step {self.step.average * 1e3:.1f} ms avg, "
                f"input stall {self.input.average * 1e3:.1f} ms avg "
                f"({100 * share:.1f}%)")
