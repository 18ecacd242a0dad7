"""Preemption drain: turn a SIGTERM into a checkpoint, not lost work (the
port's copy of ``cloud_tpu/training/preemption.py``, standard library only).

Preemptions (and most orchestrators' evictions) deliver
SIGTERM with a grace window before the hard kill.  Without a handler the
Python default tears the process down mid-step and up to
``every_n_steps`` of training is thrown away; with this module the
signal becomes a cooperative drain:

1. The launcher (the port's container bootstrap, ``core.bootstrap``) or
   the training script calls :func:`install_sigterm_handler` before
   training starts.
2. The handler sets a process-wide stop event (signal-safe: no locks, no
   allocation beyond a flag and a log).
3. ``Trainer.fit`` checks :func:`stop_requested` at every dispatch
   boundary (step for K=1, window for fused K-step dispatch), breaks out
   of the epoch loop, and lets ``on_train_end`` fire — where
   ``CheckpointCallback`` saves the CURRENT step and ``wait()``\\ s the
   async write out.  Work lost is at most one dispatch window.
4. The launcher exits with :data:`PREEMPTION_EXIT_CODE` (the
   conventional 128+SIGTERM), a status a supervisor can tell apart from
   a crash; the recreated node re-enters the same script
   and ``CheckpointCallback(resume=True)`` restores the drained save.

The event is process-global (one SIGTERM means "this process must go",
whoever is training) with an injectable clock on nothing — determinism
comes from tests calling :func:`request_stop` directly instead of
delivering real signals, though ``os.kill(os.getpid(), SIGTERM)`` works
too and is exercised in the test suite.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

logger = logging.getLogger(__name__)

#: 128 + SIGTERM(15): the exit status a drained-then-exited training
#: process reports, distinct from both success (0) and a crash (1).
PREEMPTION_EXIT_CODE = 143

_stop_event = threading.Event()
_reason: Optional[str] = None
_installed = False


def stop_requested() -> bool:
    """True once a drain was requested (SIGTERM or :func:`request_stop`)."""
    return _stop_event.is_set()


def stop_reason() -> Optional[str]:
    return _reason


def request_stop(reason: str = "explicit request") -> None:
    """Request a cooperative drain (what the SIGTERM handler calls)."""
    global _reason
    if not _stop_event.is_set():
        _reason = reason
        _stop_event.set()
        logger.warning("preemption drain requested: %s", reason)


def clear() -> None:
    """Reset the event (tests; a supervisor reusing the process)."""
    global _reason
    _reason = None
    _stop_event.clear()


def install_sigterm_handler() -> bool:
    """Install the drain handler for SIGTERM (main thread only — Python
    restricts ``signal.signal`` to it; callers elsewhere get False and
    the default kill behavior).  Idempotent; chains nothing (the
    previous handler was going to kill the process, which is exactly
    what the drain replaces).
    """
    global _installed
    if _installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        logger.warning(
            "SIGTERM drain handler not installed (not on the main thread)"
        )
        return False

    def _handler(signum, frame):
        # Signal context: set the flag, count it, get out.  The actual
        # checkpoint happens on the training thread at the next window
        # boundary, with the full runtime available.
        request_stop(f"signal {signum}")
        try:
            from cloud_tpu_torch.monitoring import metrics

            metrics.counter_inc("preempt/sigterm")
        except Exception:  # noqa: BLE001 — never raise from a handler
            pass

    try:
        signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError):  # pragma: no cover - exotic platforms
        logger.warning("could not install SIGTERM handler", exc_info=True)
        return False
    _installed = True
    return True


def _reset_for_tests() -> None:
    """Clear the event AND restore the default SIGTERM disposition, so a
    test that delivered a real signal leaves no process-global residue."""
    global _installed
    clear()
    if _installed and threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    _installed = False
