"""Preemption-safe training: checkpoint and exit on SIGTERM.

Port of ``handpose_tpu/train/preemption.py:27-81``.  The signal only
sets a flag; the Worker's epoch loop reads it at the next step boundary,
writes a resumable ``checkpoint`` (which restarts the interrupted epoch)
and returns.  Nothing asynchronous touches the model or the card.
Arming is explicit (``Worker.enable_preemption_save()``; the train CLI
arms it), so callers with their own signal handling are not surprised.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional

DEFAULT_SIGNALS = (signal.SIGTERM,)


class PreemptionGuard:
    """Flag-setting signal trap that chains to the handlers it replaced.

    ``install()`` replaces the handlers of ``signals``; the trap sets
    :attr:`requested`, then calls the previous handler where that was a
    Python callable.  As a context manager it restores them on exit.
    """

    def __init__(self, signals: Iterable[int] = DEFAULT_SIGNALS):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self._installed = False

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Trigger without a signal (tests, cooperative shutdown)."""
        self._event.set()

    def _trap(self, signum, frame) -> None:
        self._event.set()
        prev = self._previous.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        if not self._installed:
            for sig in self.signals:
                self._previous[sig] = signal.getsignal(sig)
                signal.signal(sig, self._trap)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            for sig in self.signals:
                prev = self._previous.get(sig, signal.SIG_DFL)
                # getsignal() gives None for a handler not installed from
                # Python, which signal() does not take back
                signal.signal(sig, signal.SIG_DFL if prev is None else prev)
            self._previous.clear()
            self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> Optional[bool]:
        self.uninstall()
        return None
