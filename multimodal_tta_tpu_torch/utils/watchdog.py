"""Stalled-dispatch watchdog for device-facing loops (the port of
``multimodal_tta_tpu/utils/watchdog.py``).

On the card a hung dispatch is a kernel launch, a copy or a synchronise
that never returns: a kernel that never ends, a card that fell off the bus,
or another process that holds it. No exception comes, and a blocked thread
cannot be interrupted from Python; the useful responses are to detect the
stall from a monitor thread, print a diagnosis, and exit the process (the
blocked thread is lost anyway). Serving loops (``cli/serve_artifact.py``)
wrap their device work in a :class:`DispatchWatchdog`::

    with DispatchWatchdog(60.0, what="adapt+segment dispatch") as wd:
        for batch in stream:
            result = adapt_predict(state, batch)
            wd.heartbeat()          # any forward progress resets the clock

If the protected section makes no heartbeat (and does not exit) within the
deadline, the monitor thread prints :func:`wedged_diagnosis` and calls
``os._exit(exit_code)``. Pass ``on_timeout`` to override (tests use a
flag-setting callback instead of exiting).
"""

from __future__ import annotations

import os
import sys
import threading
import time

__all__ = ["DispatchWatchdog", "WEDGED_DEVICE_DIAGNOSIS", "wedged_diagnosis"]

WEDGED_DEVICE_DIAGNOSIS = (
    "device produced no result within {deadline:.0f}s ({what}). A kernel "
    "launch, copy or synchronise on the GPU has not returned: a kernel that "
    "never ends, a card in an error state, or a stale process holding the "
    "card (stopped with SIGTSTP/SIGSTOP, or crashed without releasing it). "
    "Diagnose with `nvidia-smi` (the processes on the card, its state) and "
    "`ps aux | awk '$8 ~ /^T/'` (stopped processes); resume (`kill -CONT "
    "<pid>`) or terminate (`kill <pid>`) the specific PID, then re-run."
)


def wedged_diagnosis(what: str, deadline: float) -> str:
    return "[watchdog] " + WEDGED_DEVICE_DIAGNOSIS.format(what=what, deadline=deadline)


class DispatchWatchdog:
    """Monitor-thread deadline around device dispatches that may hang.

    Parameters
    ----------
    deadline_s:
        Seconds of no progress (no ``heartbeat()``, section still open)
        after which the watchdog fires. ``None`` or ``<= 0`` disables it
        (the context manager does nothing), so call sites can pass a config
        knob straight through.
    what:
        Label of the protected dispatch, used in the diagnosis.
    on_timeout:
        Callback run in the monitor thread when the deadline passes. The
        default prints :func:`wedged_diagnosis` to ``stream`` and calls
        ``os._exit(exit_code)``: a blocked dispatch thread cannot be
        unblocked, so process exit is the only clean recovery.
    exit_code:
        Exit status for the default ``on_timeout``.
    stream:
        Where the diagnosis is written (default ``sys.stderr``).
    first_deadline_s:
        Deadline applied until the first ``heartbeat()``: the first
        protected section may include one-time work (building the kernels,
        loading the program) that later sections do not, and must not be
        taken for a hang at the steady deadline. Defaults to ``deadline_s``.
    """

    def __init__(
        self,
        deadline_s: float | None,
        what: str = "device dispatch",
        on_timeout=None,
        exit_code: int = 3,
        stream=None,
        poll_s: float | None = None,
        first_deadline_s: float | None = None,
    ):
        self.deadline_s = float(deadline_s) if deadline_s else 0.0
        self._current_deadline = (
            float(first_deadline_s) if first_deadline_s else self.deadline_s
        )
        self.what = what
        self.exit_code = exit_code
        self.stream = stream
        self.on_timeout = on_timeout
        self.fired = False
        self._poll_s = poll_s if poll_s is not None else min(1.0, max(0.05, self.deadline_s / 10.0 or 1.0))
        self._done = threading.Event()
        self._last = time.monotonic()
        self._thread: threading.Thread | None = None

    @property
    def enabled(self) -> bool:
        return self.deadline_s > 0

    def heartbeat(self) -> None:
        """Record completed-unit progress: resets the no-progress clock and
        ends the (possibly longer) first-deadline window."""
        self._last = time.monotonic()
        self._current_deadline = self.deadline_s

    def touch(self) -> None:
        """Reset the no-progress clock WITHOUT ending the first-deadline
        window. For host-side progress (NIfTI decode) inside a protected
        section: it keeps slow host work from counting against the
        device-dispatch deadline, while a first device call still pending
        keeps its longer allowance."""
        self._last = time.monotonic()

    def __enter__(self) -> "DispatchWatchdog":
        if self.enabled:
            self._last = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name=f"watchdog:{self.what}", daemon=True
            )
            self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        return False

    def _run(self) -> None:
        while not self._done.wait(self._poll_s):
            if time.monotonic() - self._last >= self._current_deadline:
                self.fired = True
                self._fire()
                return

    def _fire(self) -> None:
        if self.on_timeout is not None:
            self.on_timeout()
            return
        stream = self.stream if self.stream is not None else sys.stderr
        print(wedged_diagnosis(self.what, self._current_deadline), file=stream, flush=True)
        os._exit(self.exit_code)
